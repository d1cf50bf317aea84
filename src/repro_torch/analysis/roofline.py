"""Roofline terms of one step (port of ``repro/analysis/roofline.py``).

Three terms, all in seconds per step per card:

    compute    = FLOPs / peak bf16 FLOP/s
    memory     = bytes accessed / HBM B/s
    collective = wire bytes / NVLink B/s

plus MODEL_FLOPS (the analytically useful work: 6*N*D train, 2*N*D
inference, N_active for MoE) and the usefulness ratio MODEL_FLOPS / FLOPs,
which exposes remat, dispatch and redundant work. The constants are the
H100 SXM's (``launch/mesh.py::H100_SXM``); the counts are the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..launch.mesh import H100_SXM
from ..models.config import ModelConfig, ShapeConfig


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of routed experts + shared).
    Embedding lookups are excluded (the 6ND convention counts only matmul
    params; the LM head IS included)."""
    total = cfg.param_count()
    total -= cfg.vocab_padded * cfg.d_model  # embedding gather is not a matmul
    if cfg.moe is not None:
        mo = cfg.moe
        n_moe_layers = cfg.num_layers - mo.first_k_dense
        per_expert = 3 * cfg.d_model * mo.d_expert
        inactive = (mo.num_experts - mo.top_k) * per_expert * n_moe_layers
        total -= inactive
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch


def roofline_terms(
    cost: Dict[str, float],
    collectives: Dict[str, float],
    cfg: ModelConfig,
    shape: ShapeConfig,
    chips: int,
    hw: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """``cost``: per-card {"flops", "bytes accessed"}; ``collectives``: per-card
    {"total": wire bytes}; ``hw`` defaults to ``H100_SXM``."""
    hw = hw or H100_SXM
    flops_per_chip = float(cost.get("flops", 0.0))
    bytes_per_chip = float(cost.get("bytes accessed", 0.0))
    wire_per_chip = float(collectives.get("total", 0.0))

    compute_s = flops_per_chip / hw["peak_flops_bf16"]
    memory_s = bytes_per_chip / hw["hbm_bw"]
    collective_s = wire_per_chip / hw["nvlink_bw"]

    mf = model_flops(cfg, shape)
    mf_per_chip = mf / chips
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    bound = max(compute_s, memory_s, collective_s)
    ideal_s = mf_per_chip / hw["peak_flops_bf16"]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "hlo_flops_per_chip": flops_per_chip,
        "hlo_bytes_per_chip": bytes_per_chip,
        "wire_bytes_per_chip": wire_per_chip,
        "model_flops_global": mf,
        "model_flops_per_chip": mf_per_chip,
        "useful_ratio": (mf_per_chip / flops_per_chip) if flops_per_chip else 0.0,
        # fraction of the compute roofline achievable if the step runs at the
        # bound given by its dominant term:
        "roofline_fraction": (ideal_s / bound) if bound > 0 else 0.0,
    }
