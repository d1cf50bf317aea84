"""Analytic per-card HBM estimate (port of ``repro/analysis/memory_est.py``).

An analytic model over the *sharded* descriptor trees: exact for params,
optimizer state and caches (declared trees with resolved specs), estimated
for activations:

  train  : params + grads + 2x fp32 moments + L x (saved layer input) [remat]
           + fp32 logits(+grad) working set
  prefill: params + ~4 live layer intermediates + last-token logits
  decode : params + KV/state cache + O(B*D) working set

Every byte count is the reference's. The reference checks the total
against a TPU v5e's 16 GiB (``fits_16g``); the port checks it against an
H100 SXM's 80 GB (``fits_hbm``, ``launch/mesh.py::H100_SXM``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..launch.mesh import H100_SXM
from ..models.config import ModelConfig, ShapeConfig
from ..models.params import resolve_spec
from ..tree import tree_flatten


def _shard_factor(spec, sizes: Dict[str, int]) -> int:
    f = 1
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            f *= sizes.get(a, 1)
    return f


def sharded_tree_bytes(descs, rules, sizes, elt_bytes: int) -> int:
    total = 0
    for d in tree_flatten(descs)[0]:
        n = int(np.prod(d.shape)) if d.shape else 1
        total += n * elt_bytes // _shard_factor(resolve_spec(d, rules, sizes), sizes)
    return total


def estimate_hbm(cfg: ModelConfig, shape: ShapeConfig, rules, sizes, remat: str) -> Dict:
    from ..models import cache_descs, param_descs

    batch_axes = [a for a in ("pod", "data") if a in sizes]
    b_shards = int(np.prod([sizes[a] for a in batch_axes])) or 1
    m = sizes.get("model", 1)
    b_loc = max(shape.global_batch // b_shards, 1)
    d = cfg.d_model
    v_loc = cfg.vocab_padded // m if cfg.vocab_padded % m == 0 else cfg.vocab_padded

    pdescs = param_descs(cfg)
    params_b = sharded_tree_bytes(pdescs, rules, sizes, 2)
    out: Dict[str, float] = {"params": params_b}

    if shape.kind == "train":
        from ..models.tuning import get_tuning

        tun = get_tuning()
        out["optimizer_fp32"] = sharded_tree_bytes(pdescs, rules, sizes, 4) * 2
        out["grads"] = params_b
        saved_per_layer = b_loc * shape.seq_len * d * 2  # bf16 layer input
        n_saved = cfg.num_layers + cfg.encoder_layers
        mult = {"full": 1.0, "dots": 4.0, "none": 10.0}[remat]
        out["activations_saved"] = saved_per_layer * n_saved * mult / tun.microbatch
        s_eff = min(shape.seq_len, tun.loss_chunk) if tun.loss_chunk else shape.seq_len
        out["logits_ws_fp32"] = 2 * (b_loc // tun.microbatch) * s_eff * v_loc * 4
        out["layer_working_set"] = 4 * saved_per_layer / tun.microbatch
    elif shape.kind == "prefill":
        live = b_loc * shape.seq_len * d * 2
        out["layer_working_set"] = 6 * live
        out["logits"] = b_loc * v_loc * 4
    else:  # decode
        cdescs = cache_descs(cfg, batch=shape.global_batch, max_len=shape.seq_len)
        out["kv_cache"] = sharded_tree_bytes(cdescs, rules, sizes, 2) * 2  # in+out
        out["layer_working_set"] = 8 * b_loc * d * 2
        out["logits"] = b_loc * v_loc * 4

    out["total"] = float(sum(v for k, v in out.items()))
    out["hbm_fraction"] = out["total"] / H100_SXM["hbm_bytes"]
    out["fits_hbm"] = bool(out["total"] <= H100_SXM["hbm_bytes"])
    return out
