"""Measure the attention-quadratic share of the memory roofline term (port
of ``repro/analysis/quad_probe.py``).

Method: the bytes a device accesses at a fixed token count T decompose as
    bytes(S, B) = linear(T) + quad * S        (attention S^2 per sequence =
                                               S * T total)
so counting cells at (S, B) and (S/2, 2B) (same tokens, same parameter
traffic) isolates the quadratic part:
    quad_total = 2 * (bytes(S, B) - bytes(S/2, 2B))

The counts are the dry run's (``launch/dryrun.py``: ``OpCounter`` beneath
DTensor, at full depth), which go through the plain attention path
(``models/layers.py::_sdpa``), whose S^2 logits and probabilities reach
HBM. The port's flash-attention kernel (``kernels/csrc/flash_attention.cu``
through ``ops.flash_attention``) keeps those S^2 intermediates in shared
memory and registers, one query tile against streamed K/V tiles, so its
HBM traffic is linear in S: the adjusted memory term is (total - quad).
This models what the kernel would save; no forward reaches it yet.
The roofline constants are the H100 SXM's (``launch/mesh.py::H100_SXM``,
``roofline_terms``' default).

Usage:
  PYTHONPATH=src python -m repro_torch.analysis.quad_probe --arch gemma_2b --shape train_4k
"""
import argparse
import dataclasses as dc
import json

from ..configs import get_config
from ..launch.dryrun import _cost_and_collectives, _trace_cell, fake_world
from ..models import shape_by_name
from .roofline import roofline_terms


def probe_cost(cfg, shape, mesh, remat="full"):
    """(cost, collectives) of one cell, counted at full depth."""
    counter, _, _ = _trace_cell(cfg, shape, mesh, remat)
    return _cost_and_collectives(counter)


def quad_decompose(arch: str, shape_name: str, remat: str = "full", device_type: str = "cuda"):
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    half = dc.replace(shape, seq_len=shape.seq_len // 2,
                      global_batch=shape.global_batch * 2)
    with fake_world(multi_pod=False, device_type=device_type) as mesh:
        cost_full, coll_full = probe_cost(cfg, shape, mesh, remat)
        cost_half, _ = probe_cost(cfg, half, mesh, remat)
        chips = mesh.size()

    b_full = cost_full["bytes accessed"]
    b_half = cost_half["bytes accessed"]
    quad = max(0.0, 2.0 * (b_full - b_half))
    f_full = cost_full["flops"]
    f_half = cost_half["flops"]
    quad_flops = max(0.0, 2.0 * (f_full - f_half))

    adj_cost = dict(cost_full)
    adj_cost["bytes accessed"] = b_full - quad
    base = roofline_terms(cost_full, coll_full, cfg, shape, chips)
    adj = roofline_terms(adj_cost, coll_full, cfg, shape, chips)
    return {
        "arch": arch, "shape": shape_name,
        "bytes_per_chip": b_full,
        "quad_bytes_per_chip": quad,
        "quad_fraction": quad / b_full if b_full else 0.0,
        "quad_flops_fraction": quad_flops / f_full if f_full else 0.0,
        "memory_s_plain": base["memory_s"],
        "memory_s_flash_adjusted": adj["memory_s"],
        "roofline_fraction_plain": base["roofline_fraction"],
        "roofline_fraction_flash_adjusted": adj["roofline_fraction"],
        "dominant_after": adj["dominant"],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--constrain-activations", action="store_true")
    ap.add_argument("--device-type", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    from ..models.tuning import tuning

    with tuning(
        loss_chunk=args.loss_chunk,
        microbatch=args.microbatch,
        constrain_activations=args.constrain_activations,
    ):
        out = quad_decompose(args.arch, args.shape, args.remat, args.device_type)
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in out.items()}, indent=2))


if __name__ == "__main__":
    main()
