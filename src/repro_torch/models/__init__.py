"""Torch model substrate: configs, parameter descriptors, the dense forward."""
from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES, shape_by_name
from .params import PDesc, init_params, param_count, params_from_jax, stack, stack_tree
from .transformer import DenseLM, apply_head, forward_dense, lm_loss, param_descs

__all__ = [
    "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "shape_by_name",
    "PDesc", "init_params", "param_count", "params_from_jax", "stack", "stack_tree",
    "DenseLM", "apply_head", "forward_dense", "lm_loss", "param_descs",
]
