"""FLOPs of one sequence through each kind of block (multiply-adds count 2).

Copied from the formulas the port's chip smoke script used for its prefill
rates (``_ssm_flops``, ``_attn_flops``), over plain dicts of the
configuration's ``model`` object."""
from __future__ import annotations


def vocab_padded(m: dict) -> int:
    return (m["vocab_size"] + 2047) // 2048 * 2048


def ssm_block(m: dict, seq: int) -> int:
    """A Mamba-2 block as the chunked SSD computes it: the projections, the
    depthwise conv, and the chunked SSD's four products (C B within a chunk,
    the masked products with x, the chunk states, and the carried states'
    contribution)."""
    s, d = m["ssm"], m["d_model"]
    di = s["expand"] * d
    nh = di // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    L = min(s["chunk_size"], seq)
    return (2 * seq * d * (2 * di + 2 * gn + nh) + 2 * seq * s["d_conv"] * (di + 2 * gn)
            + 2 * seq * L * (gn + nh * s["head_dim"]) + 2 * 2 * seq * nh * s["head_dim"] * s["d_state"]
            + 2 * seq * di * d)


def attn_block(m: dict, seq: int) -> int:
    """An attention block with its MLP: the products, and every (query, key)
    pair of attention."""
    d = m["d_model"]
    hd = m.get("head_dim") or d // m["num_heads"]
    nq, nkv = m["num_heads"], m["num_kv_heads"]
    return (2 * seq * d * hd * (2 * nq + 2 * nkv) + 2 * 2 * seq * seq * nq * hd
            + 2 * seq * 3 * d * m["d_ff"])


def head(m: dict, seq: int) -> int:
    """The LM head over every position of the sequence."""
    return 2 * seq * m["d_model"] * vocab_padded(m)
