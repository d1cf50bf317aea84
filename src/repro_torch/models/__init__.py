"""Torch model substrate: configs, parameter descriptors, tuning flags, the dense/moe, ssm,
hybrid, encdec and vlm forwards."""
from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES, shape_by_name
from .params import (PDesc, init_params, is_desc, param_bytes, param_count, params_from_jax,
                     resolve_spec, resolve_specs, stack, stack_tree, zeros_from_descs)
from .ssm import mamba2_mixer, ssd_chunked, ssd_decode_step
from .transformer import (DenseLM, apply_head, cache_descs, chunked_lm_loss, decode_step, forward,
                          forward_dense, forward_encdec, forward_hybrid, forward_ssm,
                          forward_vlm, lm_loss, param_descs)
from .tuning import Tuning, get_tuning, tuning

__all__ = [
    "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "shape_by_name",
    "PDesc", "init_params", "is_desc", "param_bytes", "param_count", "params_from_jax",
    "resolve_spec", "resolve_specs", "stack", "stack_tree", "zeros_from_descs",
    "mamba2_mixer", "ssd_chunked", "ssd_decode_step",
    "DenseLM", "apply_head", "cache_descs", "chunked_lm_loss", "decode_step", "forward",
    "forward_dense", "forward_encdec", "forward_hybrid", "forward_ssm", "forward_vlm",
    "lm_loss", "param_descs",
    "Tuning", "get_tuning", "tuning",
]
