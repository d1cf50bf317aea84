"""Training FLOPs of the ``ssm`` family: Mamba-2 blocks and the head."""
from __future__ import annotations

from . import blocks


def train_flops(m: dict, batch: int, seq: int) -> int:
    fwd = m["num_layers"] * blocks.ssm_block(m, seq) + blocks.head(m, seq)
    return 3 * batch * fwd
