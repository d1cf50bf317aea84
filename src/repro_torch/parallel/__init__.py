"""Multi-device layer (port of ``repro/parallel``): the sharding rules as
DeviceMesh placements, and expert-parallel MoE over ``torch.distributed``."""
from .sharding import (
    ShardingProfile,
    batch_input_descs,
    make_rules,
    profile_for,
    tree_shardings,
)

__all__ = [
    "ShardingProfile",
    "batch_input_descs",
    "make_rules",
    "profile_for",
    "tree_shardings",
]
