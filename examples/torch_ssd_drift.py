"""How far f32 SSD drifts through mamba2-370m: the port's two routes against
a float64 run of the same model.

The chunked SSD takes exp(cum_i - cum_j) of cumulative decay sums that reach
a few hundred within a 256-token chunk, so its f32 exponents carry absolute
errors of |cum| * 2^-24; 48 residual layers then amplify what reaches the
logits. This script measures, relative to max |logit| of a float64
``forward_ssm``:
  chunked  ``forward_ssm`` in f32 (the model's own chunked path)
  ssd_impl every mixer on ``ops.ssd_model_impl`` in f32: the CUDA kernel on
           a card, the sequential recurrence ``ref.ssd_ref`` on the CPU
and the two against each other (what ``chip_smoke.py``'s ssm phase holds to
its tolerance). The float64 run is the same model with float64 weights:
``models/ssm.py`` and ``rms_norm`` then work in float64 throughout.

    PYTHONPATH=src python examples/torch_ssd_drift.py --device cpu --batch 1 --seq 512
    PYTHONPATH=src python examples/torch_ssd_drift.py --device cuda --batch 4 --seq 2048
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

sys.path.insert(0, "src")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import apply_head, forward_ssm, init_params, param_descs  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.ssm import mamba2_mixer  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def kernel_route(cfg, params, tokens):
    x = params["embed"][tokens]
    for i in range(cfg.num_layers):
        lp = tree_map(lambda w: w[i], params["layers"])
        out, _ = mamba2_mixer(lp["mixer"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                                      ssd_impl=ops.ssd_model_impl)
        x = x + out
    return apply_head(cfg, params, x)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: all 48)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2_370m")
    if args.layers:
        import dataclasses
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(param_descs(cfg), gen, dtype=torch.float32, device=args.device)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq), generator=gen,
                           device=args.device)
    with torch.no_grad():
        t0 = time.perf_counter()
        chunked = forward_ssm(cfg, params, tokens)[0]
        routed = kernel_route(cfg, params, tokens)
        truth = forward_ssm(cfg, tree_map(lambda w: w.double(), params), tokens)[0]
    top = truth.abs().max()
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"mamba2-370m x{cfg.num_layers}, batch {args.batch} x {args.seq}, seed {args.seed}, "
          f"on {name} ({time.perf_counter() - t0:.1f} s); max |logit| {float(top):.4f}")
    print(f"  chunked f32 vs float64:  {float((chunked.double() - truth).abs().max() / top):.3e}")
    print(f"  ssd_impl f32 vs float64: {float((routed.double() - truth).abs().max() / top):.3e}")
    print(f"  ssd_impl vs chunked:     "
          f"{float((routed - chunked).abs().max() / chunked.abs().max()):.3e}")


if __name__ == "__main__":
    main()
