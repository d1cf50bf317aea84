"""Expert-parallel MoE on N ranks against the einsum dispatch, at
granite-moe-3b-a800m's full width (40 experts, top 8, d_model 1536,
d_expert 512), one batch of 1 x 2048 seeded tokens, f32.

    torchrun --standalone --nproc-per-node 4 examples/torch_ep_moe.py
    torchrun --standalone --nproc-per-node 4 examples/torch_ep_moe.py --device cpu --smoke

Every rank draws the same seeded weights, x and cotangent. On a (1, N) mesh
(``launch/mesh.py::make_host_mesh(model=N)``) ``layers.moe`` under
``tuning(moe_impl="ep")`` gives rank m the sequence slice m and experts
[m E_pad/N, (m + 1) E_pad/N); the buckets cross the ranks by all-to-all
(NCCL on the cards, gloo with ``--device cpu``). It is held against the
einsum dispatch of the whole batch on every rank at capacity factor E / k,
where no slot drops, so the two agree within f32 rounding: y within 1e-5
of max |y|, the gradients of sum(y * ct) within 1e-4 of each leaf's max
|grad| (the same on every rank). The EP aux is the mean of the slices'
aux losses, held to the einsum aux of each slice (1e-5 relative). Prints
the median ms of each forward, the card's name and power limit, and last a
JSON line with the numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, "src")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import init_params, tuning  # noqa: E402
from repro_torch.models.layers import moe, moe_descs  # noqa: E402
from repro_torch.parallel.ep_moe import ep_mesh  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def median_ms(fn, dev, reps: int) -> float:
    """Host clock around each call, which ends in a synchronize (the EP
    forward waits on its collectives); every rank starts together."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    ap.add_argument("--smoke", action="store_true", help="the smoke config (for the CPU)")
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(f"cuda:{local}" if args.device == "cuda" else args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("nccl", device_id=dev)
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo")
    try:
        mesh = make_host_mesh(model=world, device_type=dev.type)
        cfg = get_config("granite_moe_3b_a800m", smoke=args.smoke)
        mo = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            mo, capacity_factor=mo.num_experts / mo.top_k))
        gen = torch.Generator(device=dev).manual_seed(0)
        p = init_params(moe_descs(cfg), gen, dtype=torch.float32, device=dev)
        x = torch.randn((1, args.tokens, cfg.d_model), generator=gen, device=dev)
        ct = torch.randn(x.shape, generator=gen, device=dev)
        leaves = tree_flatten(p)[0]

        def run(ep: bool):
            for t in leaves + [x]:
                t.requires_grad_(True)
            if ep:
                with ep_mesh(mesh), tuning(moe_impl="ep"):
                    y, aux = moe(p, x, cfg)
            else:
                y, aux = moe(p, x, cfg)
            grads = torch.autograd.grad((y * ct).sum(), leaves + [x])
            return y.detach(), aux.detach(), grads

        y0, aux0, g0 = run(False)
        y1, aux1, g1 = run(True)
        err_y = rel(y1, y0)
        err_g = max(rel(a, b) for a, b in zip(g1, g0))
        with torch.no_grad():
            s = args.tokens // world
            aux_slices = torch.stack([moe(p, x[:, m * s:(m + 1) * s], cfg)[1]
                                      for m in range(world)]).mean()
        err_aux = abs(float(aux1) - float(aux_slices)) / abs(float(aux_slices))
        if err_y > 1e-5 or err_g > 1e-4 or err_aux > 1e-5:
            raise AssertionError(f"rank {rank}: EP vs einsum: y {err_y:.3e}, grads {err_g:.3e}, "
                                 f"aux {err_aux:.3e}")
        for t in (y1, aux1) + tuple(g1):
            ref = t.clone()
            dist.broadcast(ref, src=0)
            if not torch.equal(t, ref):
                raise AssertionError(f"rank {rank}: y, aux or a gradient differs from rank 0's")

        def fwd(ep: bool):
            with torch.no_grad():
                if ep:
                    with ep_mesh(mesh), tuning(moe_impl="ep"):
                        moe(p, x, cfg)
                else:
                    moe(p, x, cfg)

        ms_ep = median_ms(lambda: fwd(True), dev, args.reps)
        ms_einsum = median_ms(lambda: fwd(False), dev, args.reps)
        if rank == 0:
            card = "cpu"
            if dev.type == "cuda":
                card = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                    capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
            print(f"[ep_moe] {cfg.name}, {world} rank(s) on {dev.type}, 1 x {args.tokens} tokens, "
                  f"capacity factor {cfg.moe.capacity_factor}: EP vs einsum y {err_y:.3e} of max "
                  f"|y|, gradients {err_g:.3e}, aux vs the slices' mean {err_aux:.3e}; forward "
                  f"median EP {ms_ep:.3f} ms over {world} rank(s), einsum {ms_einsum:.3f} ms on "
                  f"one; {card}", flush=True)
            print(card)
            print(json.dumps({"ranks": world, "device": dev.type, "tokens": args.tokens,
                              "err_y": err_y, "err_grads": err_g, "err_aux": err_aux,
                              "ep_ms": ms_ep, "einsum_ms": ms_einsum}))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
