"""Reference of the ``hybrid`` family (Zamba2, arXiv:2411.15242, as the
system under test reads it): token embedding; for each group, one attention
block whose single weight set is shared by every group, then ``period``
Mamba-2 blocks; then the tail Mamba-2 blocks; final norm and LM head."""
from __future__ import annotations

from . import common as c


def plan(m: dict):
    p = m["hybrid_attn_period"]
    groups = m["num_layers"] // p
    return p, groups, m["num_layers"] - groups * p


def descs(m: dict) -> dict:
    p, groups, tail = plan(m)
    out = c.embed_descs(m)
    out["shared_attn"] = c.attn_block_descs(m)
    out["group_ssm"] = c.stacked(c.stacked(c.ssm_block_descs(m), p), groups)
    if tail:
        out["tail_ssm"] = c.stacked(c.ssm_block_descs(m), tail)
    return out


def forward(m: dict, params: dict, tokens):
    p, groups, tail = plan(m)
    positions = c.positions_of(tokens)
    x = params["embed"][tokens]
    for g in range(groups):
        x = c.attn_block(params["shared_attn"], x, m, positions)
        for i in range(p):
            x = c.ssm_block(c.layer(params["group_ssm"], g, i), x, m)
    for i in range(tail):
        x = c.ssm_block(c.layer(params["tail_ssm"], i), x, m)
    return c.head(params, x, m)
