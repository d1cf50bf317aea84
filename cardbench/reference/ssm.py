"""Reference of the ``ssm`` family (Mamba-2, arXiv:2405.21060): token
embedding, a stack of Mamba-2 blocks, final norm and LM head. Each block
is recomputed in the backward pass (``common.blockwise``), so that the
reference fits the card at the batch the cell trains."""
from __future__ import annotations

from . import common as c


def descs(m: dict) -> dict:
    out = c.embed_descs(m)
    out["layers"] = c.stacked(c.ssm_block_descs(m), m["num_layers"])
    return out


def forward(m: dict, params: dict, tokens):
    x = params["embed"][tokens]
    for i in range(c.n_stacked(params["layers"])):
        x = c.blockwise(c.ssm_block, c.layer(params["layers"], i), x, m)
    return c.head(params, x, m)
