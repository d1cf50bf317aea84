"""Training FLOPs of the ``hybrid`` family: the shared attention block at
each group, every Mamba-2 block, and the head."""
from __future__ import annotations

from . import blocks


def train_flops(m: dict, batch: int, seq: int) -> int:
    groups = m["num_layers"] // m["hybrid_attn_period"]
    fwd = (groups * blocks.attn_block(m, seq) + m["num_layers"] * blocks.ssm_block(m, seq)
           + blocks.head(m, seq))
    return 3 * batch * fwd
