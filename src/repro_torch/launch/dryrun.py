"""Multi-pod dry run (port of ``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) cell: resolve the sharding
profile, build allocation-free inputs (``FakeTensorMode`` tensors laid out
as DTensors by ``tree_shardings``, the counterpart of the reference's
``ShapeDtypeStruct``), and run the port's real step (``make_step``) once on
them under ``spmd(mesh)`` over a ``DeviceMesh`` of the production shape,
(data=16, model=16) = 256 or (pod=2, data=16, model=16) = 512 ranks of
torch's ``"fake"`` process-group backend, in one process. ``OpCounter``
counts the per-device flops, bytes and collectives beneath DTensor. Nothing
is allocated and no kernel is launched: the step goes through the plain
attention path, as the reference's XLA lowering does.

A cell whose step DTensor cannot partition is a bug in the system, not in
the dry run: it is recorded ``status: "failed"`` with the operator's error
and the port's line, never run unsharded or at global shapes.

The record has the reference's keys, with three differences:
``memory_est`` comes from the port's estimator (``fits_hbm`` against an
H100's 80 GB); ``memory_local`` (argument and output bytes of this device's
shards) stands where the reference has ``memory_xla_raw``; and ``cost`` is
counted at full depth (``cost_method`` says so): the port loops over layers
in Python, so no scan body is counted once, and ``scaled_pair`` /
``extrapolate`` serve only to check that.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.jsonl
  (``--device-type cpu`` where torch has no CUDA: fake tensors of a CPU
  build cannot be CUDA tensors)

Each cell's line on standard output carries ``launches``: the kernel
launch counts (``kernels/ops.py::LAUNCHES``) set to 0 just before the cell
and read just after it, all 0 when nothing is launched.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses as dc
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ..analysis.aten_cost import OpCounter, collective_wire_bytes
from ..analysis.memory_est import estimate_hbm
from ..analysis.roofline import roofline_terms
from ..configs import ARCHITECTURES, get_config
from ..kernels import ops
from ..models import SHAPES, cache_descs, param_descs, shape_by_name
from ..models.tuning import get_tuning, tuning
from ..parallel.ep_moe import ep_mesh
from ..models.params import resolve_spec
from ..parallel.sharding import (batch_dtypes, batch_input_descs, mesh_axis_sizes, placements,
                                 profile_for)
from ..parallel.spmd import spmd
from ..tree import tree_flatten, tree_map, tree_unflatten
from .mesh import make_production_mesh
from .steps import make_step


def scaled_pair(cfg):
    """Two pattern-preserving shallow variants for cost extrapolation
    (the reference's): (small, large, extra_units) with
        cost(full) = cost(small) + extra_units * (cost(large) - cost(small)).
    The port counts at full depth; the pair checks that the count is
    linear in depth, as the reference's extrapolation assumes."""
    if cfg.family == "encdec":
        assert cfg.encoder_layers == cfg.num_layers
        small = dc.replace(cfg, num_layers=2, encoder_layers=2)
        large = dc.replace(cfg, num_layers=4, encoder_layers=4)
        return small, large, (cfg.num_layers - 2) // 2
    if cfg.global_period:  # gemma3 pattern: groups of p + tail
        p = cfg.global_period
        tail = cfg.num_layers % p
        small = dc.replace(cfg, num_layers=p + tail)
        large = dc.replace(cfg, num_layers=2 * p + tail)
        return small, large, (cfg.num_layers - (p + tail)) // p
    if cfg.moe is not None and cfg.moe.first_k_dense:
        fk = cfg.moe.first_k_dense
        small = dc.replace(cfg, num_layers=fk + 2)
        large = dc.replace(cfg, num_layers=fk + 4)
        return small, large, (cfg.num_layers - fk - 2) // 2
    if cfg.family == "hybrid":
        p = cfg.hybrid_attn_period
        tail = cfg.num_layers % p
        small = dc.replace(cfg, num_layers=p + tail)
        large = dc.replace(cfg, num_layers=2 * p + tail)
        return small, large, (cfg.num_layers - (p + tail)) // p
    if cfg.family == "vlm":
        p = cfg.cross_attn_period
        small = dc.replace(cfg, num_layers=p)
        large = dc.replace(cfg, num_layers=2 * p)
        return small, large, (cfg.num_layers - p) // p
    small = dc.replace(cfg, num_layers=2)
    large = dc.replace(cfg, num_layers=4)
    return small, large, (cfg.num_layers - 2) // 2


def extrapolate(small: dict, large: dict, extra: int) -> dict:
    """Linear two-point extrapolation, clamped at the small-probe value
    (the reference's)."""
    keys = set(small) | set(large)
    out = {}
    for k in keys:
        s = small.get(k, 0.0)
        l = large.get(k, 0.0)
        if not isinstance(s, (int, float)):
            continue
        v = s + extra * (l - s)
        out[k] = max(v, min(s, l), 0.0)
    return out


def skip_reason(cfg, shape) -> str:
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return (
            "pure full-attention arch: 500k-token KV per layer is architecturally "
            "a non-goal (sub-quadratic archs run this cell; see DESIGN.md §4)"
        )
    return ""


@contextlib.contextmanager
def fake_world(multi_pod: bool, device_type: str = "cuda"):
    """A process group of the "fake" backend with the production mesh's
    world size, this process its rank 0, and the production mesh over it;
    destroyed on exit. Collectives on it move no data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    finally:
        dist.destroy_process_group()


def _fake_tree(descs, dtype, profile, mesh):
    """A tree of DTensors laid out by ``profile`` on ``mesh`` (the
    placements ``tree_shardings`` gives), each leaf a fake tensor of its
    local shard (call under the FakeTensorMode)."""
    sizes = mesh_axis_sizes(mesh)
    dev = torch.device(mesh.device_type)
    return tree_map(lambda d: distribute_tensor(
        torch.empty(d.shape, dtype=dtype, device=dev), mesh,
        list(placements(resolve_spec(d, profile.rules, sizes), mesh)), src_data_rank=None),
        descs)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _trace_cell(cfg, shape, mesh, remat: str):
    """Run one (cfg, shape) step on fake DTensors over ``mesh`` under
    ``spmd`` and the counter (the counterpart of the reference's
    ``_compile_cell``). Returns (counter, profile, memory_local)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    profile = profile_for(cfg, shape, mesh)
    pdescs = param_descs(cfg)
    bdescs = batch_input_descs(cfg, shape)
    step = make_step(cfg, shape.kind, remat=remat)
    fake = FakeTensorMode()
    with fake:
        params = _fake_tree(pdescs, torch.bfloat16, profile, mesh)
        dtypes = batch_dtypes(cfg)
        batch = {k: _fake_tree(d, dtypes[k], profile, mesh) for k, d in bdescs.items()}
        args = [params]
        if shape.kind == "train":
            step_n = torch.zeros((), dtype=torch.int32, device=torch.device(mesh.device_type))
            args.append({"m": _fake_tree(pdescs, torch.float32, profile, mesh),
                         "v": _fake_tree(pdescs, torch.float32, profile, mesh),
                         "step": DTensor.from_local(step_n, mesh, [Replicate()] * mesh.ndim,
                                                         run_check=False)})
        elif shape.kind == "decode":
            cdescs = cache_descs(cfg, batch=shape.global_batch, max_len=shape.seq_len)
            args.append(_fake_tree(cdescs, torch.bfloat16, profile, mesh))
        args.append(batch)
        if shape.kind == "decode":
            args.append(shape.seq_len - 1)  # the last position: the whole cache attends

    counter = OpCounter()
    ep = ep_mesh(mesh) if get_tuning().moe_impl == "ep" else contextlib.nullcontext()
    with fake, spmd(mesh), ep, counter:
        out = step(*args)
        if shape.kind == "train":  # out_shardings: the new state laid out as the old
            new, td = tree_flatten(out[:2])
            old = tree_flatten(tuple(args[:2]))[0]
            out = tree_unflatten(td, [n.redistribute(mesh, o.placements)
                                      for n, o in zip(new, old)]) + (out[2],)
    memory_local = {"argument_bytes": _local_bytes(args), "output_bytes": _local_bytes(out)}
    return counter, profile, memory_local


def _cost_and_collectives(counter: OpCounter):
    """The counterpart of the reference's: ``cost`` with its "flops" and
    "bytes accessed" (and the dot flops and the conversion flops on their
    own, see ``analysis/aten_cost.py``), ``collectives`` as per-device wire
    bytes."""
    cost = {**counter.cost_dict(), "dot flops": float(counter.dot_flops),
            "conversion flops": float(counter.conversion_flops)}
    return cost, collective_wire_bytes(counter.collectives)


def _port_frame(tb) -> str:
    """The innermost frame of the port's model code in a traceback, as
    file:line (the rules of ``parallel/spmd.py`` and the counter skipped)."""
    where = ""
    for f in traceback.extract_tb(tb):
        if "repro_torch" in f.filename and not f.filename.endswith(
                ("parallel/spmd.py", "analysis/aten_cost.py")):
            where = f"{f.filename.split('src/')[-1]}:{f.lineno}"
    return where


def build_cell(arch: str, shape_name: str, multi_pod: bool, remat: str = "full",
               variant: str = "baseline", tune: Optional[dict] = None,
               *, mesh) -> Dict:
    """Trace one cell at its full config on ``mesh`` (a ``fake_world``'s);
    returns the result record."""
    chips = mesh.size()
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "variant": variant,
    }
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec

    t0 = time.time()
    try:
        with tuning(**(tune or {})):
            counter, profile, memory_local = _trace_cell(cfg, shape, mesh, remat)
    except Exception as e:  # a cell DTensor cannot partition: a finding, recorded
        rec.update(status="failed", error=f"{type(e).__name__}: {str(e).splitlines()[0]}",
                   where=_port_frame(e.__traceback__),
                   traceback=traceback.format_exc(limit=-6))
        return rec
    rec.update(status="ok", compile_s=round(time.time() - t0, 2), profile=profile.name)
    rec["memory_local"] = memory_local
    with tuning(**(tune or {})):
        rec["memory_est"] = {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in estimate_hbm(
                cfg, shape, profile.rules, mesh_axis_sizes(mesh), remat
            ).items()
        }
    cost, coll = _cost_and_collectives(counter)
    rec["cost"] = cost
    rec["collectives"] = {k: round(v, 1) for k, v in coll.items()}
    rec["cost_method"] = "counted at full depth beneath DTensor (OpCounter, unfused)"
    # the H100's work: bf16 computed natively, without the CPU's conversions
    work = {**cost, "flops": cost["flops"] - cost["conversion flops"]}
    rec["roofline"] = {
        k: (round(v, 6) if isinstance(v, float) else v)
        for k, v in roofline_terms(work, rec["collectives"], cfg, shape, chips).items()
    }
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[s.name for s in SHAPES] + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    # §Perf tuning knobs (models/tuning.py); tag runs with --variant
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--decode-seq-constraint", action="store_true")
    ap.add_argument("--constrain-activations", action="store_true")
    ap.add_argument("--moe-impl", default="einsum", choices=["einsum", "ep"])
    ap.add_argument("--device-type", default="cuda", choices=["cuda", "cpu"],
                    help="the device of the fake tensors (cpu where torch has no CUDA)")
    args = ap.parse_args(argv)
    tune = dict(
        loss_chunk=args.loss_chunk,
        microbatch=args.microbatch,
        decode_seq_constraint=args.decode_seq_constraint,
        constrain_activations=args.constrain_activations,
        moe_impl=args.moe_impl,
    )

    archs = ARCHITECTURES if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    done = set()
    out_path = Path(args.out) if args.out else None
    if out_path and out_path.exists() and not args.force:
        for line in out_path.read_text().splitlines():
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline")))
            except (json.JSONDecodeError, KeyError):
                pass

    n_ok = n_skip = n_fail = 0
    for multi_pod in meshes:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        with fake_world(multi_pod, args.device_type) as mesh:
            for arch in archs:
                for shape_name in shapes:
                    key = (arch, shape_name, mesh_name, args.variant)
                    if key in done:
                        continue
                    ops.reset_launch_counts()
                    try:
                        rec = build_cell(arch, shape_name, multi_pod, remat=args.remat,
                                         variant=args.variant, tune=tune, mesh=mesh)
                    except Exception:
                        rec = {
                            "arch": arch, "shape": shape_name, "mesh": mesh_name,
                            "variant": args.variant,
                            "status": "failed", "error": traceback.format_exc(limit=4),
                        }
                    launches = dict(ops.LAUNCHES)
                    st = rec["status"]
                    n_ok += st == "ok"
                    n_skip += st == "skipped"
                    n_fail += st == "failed"
                    line = json.dumps(rec)
                    if out_path:
                        out_path.parent.mkdir(parents=True, exist_ok=True)
                        with open(out_path, "a") as f:
                            f.write(line + "\n")
                    brief = {k: rec.get(k) for k in ("arch", "shape", "mesh", "status",
                                                     "compile_s")}
                    brief["launches"] = launches
                    if st == "ok":
                        brief["dominant"] = rec["roofline"]["dominant"]
                        brief["roofline_fraction"] = rec["roofline"]["roofline_fraction"]
                        brief["hbm_frac"] = rec["memory_est"]["hbm_fraction"]
                        brief["fits_hbm"] = rec["memory_est"]["fits_hbm"]
                        brief["flops_per_chip"] = rec["cost"].get("flops")
                    if st == "failed":
                        brief["error"] = rec["error"].splitlines()[-1]
                        brief["where"] = rec.get("where")
                    print(json.dumps(brief), flush=True)
    print(f"dryrun: ok={n_ok} skipped={n_skip} failed={n_fail}", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
