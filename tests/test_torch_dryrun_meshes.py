"""The port's per-card plan against GSPMD's on meshes that do not divide.

The reference partitions its steps with GSPMD; the port runs the same steps
on DTensors under ``parallel/spmd.py``. Here both plan the six families
whose sharded dims stop dividing a 16-wide mesh (gemma-2b's 8 heads,
yi-6b's 4 kv heads, granite's 24 heads and 40 experts, deepseek's MoE
dispatch, the mamba2 and zamba2 scans) at full width and 2 layers, batch 4
x 256 tokens, on (data, model) = (1, 16) and (2, 8):

  * one subprocess compiles the reference's ``_compile_cell`` on 16
    placeholder CPU devices (both stacks unrolled) and reads from XLA's
    partitioned per-device HLO its dot flops (2 M N K of every ``dot``),
    its cost analysis's flops, and the flops its CPU backend adds to them
    beyond the program's own operations: the ``convert`` it inserts around
    bf16 work (no ``op_name``), and the reduce-windows its partitioner
    makes of a cumsum (output x window elements, quadratic in the tokens);
  * the port traces the same cells (``dryrun._trace_cell``) on a 16-rank
    ``"fake"`` process group over ``make_host_mesh``;
  * each prefill and train case holds the port's dot flops within
    FLOPS_TOL of XLA's, and its flops less its counter's conversion flops
    within FLOPS_TOL of XLA's flops less the backend's additions. The dot
    flops are the plan; where the rest differs by more, it is elementwise
    work the two count differently, and the case has its own bound below
    (never above 3%) with its measured gap;
  * the SSM families train at 4096 tokens too (batch 2): at this length
    the two plans' per-card flops at 16 x 16 lie 0.82x (mamba2) and 0.85x
    (zamba2) apart, and the dot flops hold them to the same plan (the rest
    is the CPU backend's conversions and elementwise work counted
    differently, PERF.md);
  * decode 4 x 1024 is traced and printed beside XLA's, not held (PERF.md
    says what the gap is);
  * ``--constrain-activations`` moves the port's collectives where it
    moves the reference's (the FSDP cell, yi-6b train on (2, 8)), the same
    way, and leaves the plan where it leaves the reference's.

The reference subprocess takes about 2 min; the port's cases 1-9 s each.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.tuning import tuning  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FLOPS_TOL = 0.01
ARCHS = ["gemma_2b", "yi_6b", "granite_moe_3b_a800m", "deepseek_v2_lite_16b", "mamba2_370m",
         "zamba2_1p2b"]
MESHES = [(1, 16), (2, 8)]
LAYERS, BATCH = 2, 4
SHAPES = {"prefill": ShapeConfig("prefill_256", "prefill", 256, BATCH),
          "train": ShapeConfig("train_256", "train", 256, BATCH),
          "decode": ShapeConfig("decode_1k", "decode", 1024, BATCH)}
#: the SSM train cases at 4096 tokens, the production train_4k's length, on
#: both meshes (batch 2: "data" divides it, and XLA compiles each in seconds)
LONG = {"train_4k": ShapeConfig("train_4k", "train", 4096, 2)}
LONG_ARCHS = ["mamba2_370m", "zamba2_1p2b"]
#: the port's flops less its conversions against XLA's less its backend's
#: additions, where the dot flops agree within FLOPS_TOL and the rest is
#: elementwise work counted differently (XLA's expanded softplus, exp and
#: segsum selects of the SSD scan, its reductions): the measured gap, then
#: the bound held
OWN_BOUND = {
    ("mamba2_370m", (1, 16), "prefill"): 0.015,  # measured 1.06%
    ("mamba2_370m", (1, 16), "train"): 0.025,   # measured 1.81%
    ("mamba2_370m", (2, 8), "train"): 0.025,    # measured 1.95%
    ("zamba2_1p2b", (1, 16), "train"): 0.025,   # measured 1.79%
    ("zamba2_1p2b", (2, 8), "train"): 0.025,    # measured 1.51%
    ("mamba2_370m", (1, 16), "train_4k"): 0.025,  # measured 1.40%
    ("mamba2_370m", (2, 8), "train_4k"): 0.025,   # measured 1.07%
    ("zamba2_1p2b", (1, 16), "train_4k"): 0.025,  # measured 1.64%
    ("zamba2_1p2b", (2, 8), "train_4k"): 0.025,   # measured 1.05%
}
TUNED = [("yi_6b", (2, 8), "train"), ("gemma_2b", (2, 8), "train"), ("gemma_2b", (1, 16), "train")]

_REF = r'''
import os, sys, json, re
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import dataclasses as dc
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models.config import ShapeConfig
from repro.launch.dryrun import _compile_cell, _cost_and_collectives
from repro.models.scan_utils import scan_unroll
from repro.models.tuning import tuning

_DEF = re.compile(r"^\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")

def _dims(s):
    return [int(x) for x in s.split(",") if x]

def _prod(xs):
    n = 1
    for x in xs:
        n *= x
    return n

def hlo_flops(text):
    """(dot flops, flops the CPU backend adds) of a per-device HLO text."""
    dot = extra = 0
    shapes = {}
    for line in text.splitlines():
        if line and not line.startswith(" ") and line.rstrip().endswith("{"):
            shapes = {}  # a new computation
        m = _DEF.match(line)
        if not m:
            continue
        shapes[m.group(1)] = _dims(m.group(2))
        if " dot(" in line:
            lhs = shapes[re.search(r" dot\((%[\w.\-]+),", line).group(1)]
            k = _prod(lhs[d] for d in _dims(re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                                                           line).group(1)))
            dot += 2 * _prod(_dims(m.group(2))) * k
        elif " convert(" in line and "op_name=" not in line:
            extra += _prod(_dims(m.group(2)))
        elif " reduce-window(" in line and "cumsum" in line:
            w = re.search(r"window=\{size=([\dx]+)", line).group(1)
            extra += _prod(_dims(m.group(2))) * _prod(int(x) for x in w.split("x"))
    return dot, extra

layers, cases = json.loads(sys.argv[2])
out = {}
for arch, (d, m), (name, kind, seq, batch), tune in cases:
    cfg = dc.replace(get_config(arch), num_layers=layers)
    mesh = Mesh(np.array(jax.devices()[:16]).reshape(d, m), ("data", "model"))
    with scan_unroll(), tuning(**tune):
        compiled, _ = _compile_cell(cfg, ShapeConfig(name, kind, seq, batch), mesh, "full")
    cost, coll = _cost_and_collectives(compiled)
    dot, extra = hlo_flops(compiled.as_text())
    out[f"{arch}|{d}x{m}|{name}|{int(bool(tune))}"] = {
        "flops": cost["flops"], "dot": float(dot), "extra": float(extra), "coll": coll}
json.dump(out, open(sys.argv[1], "w"))
print("REF-MESHES-OK")
'''


def _shape(kind) -> ShapeConfig:
    return SHAPES[kind] if kind in SHAPES else LONG[kind]


def _key(arch, mesh, kind, tuned=False) -> str:
    return f"{arch}|{mesh[0]}x{mesh[1]}|{_shape(kind).name}|{int(tuned)}"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_meshes")
    (out / "ref.py").write_text(_REF)
    shape = lambda k: dataclasses.astuple(SHAPES[k])  # noqa: E731
    cases = [[a, list(m), shape(k), {}] for a in ARCHS for m in MESHES for k in SHAPES]
    cases += [[a, list(m), shape(k), {"constrain_activations": True}] for a, m, k in TUNED]
    cases += [[a, list(m), dataclasses.astuple(LONG[k]), {}] for a in LONG_ARCHS for m in MESHES
              for k in LONG]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, str(out / "ref.py"), str(out / "ref.json"),
                          json.dumps([LAYERS, cases])],
                         capture_output=True, text=True, timeout=900, env=env, cwd=str(ROOT))
    assert "REF-MESHES-OK" in run.stdout, run.stderr[-4000:]
    return json.loads((out / "ref.json").read_text())


@pytest.fixture(scope="module")
def meshes():
    """A 16-rank fake process group and its (1, 16) and (2, 8) host meshes;
    the group is destroyed on teardown."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield {m: make_host_mesh(model=m[1], device_type="cpu") for m in MESHES}
    finally:
        dist.destroy_process_group()


def _trace(arch, mesh, kind, **tune):
    cfg = dataclasses.replace(get_config(arch), num_layers=LAYERS)
    with tuning(**tune):
        counter, _, _ = dryrun._trace_cell(cfg, _shape(kind), mesh, "full")
    return dryrun._cost_and_collectives(counter)


def _counts(coll) -> dict:
    return {k[2:]: v for k, v in coll.items() if k.startswith("n_")}


def _hold_to_xla(reference, meshes, arch, mesh, kind) -> None:
    """The port's dot flops within FLOPS_TOL of XLA's, its flops less its
    conversions within the case's bound of XLA's less the backend's additions."""
    ref = reference[_key(arch, mesh, kind)]
    cost, coll = _trace(arch, meshes[mesh], kind)
    dots = cost["dot flops"] / ref["dot"]
    work = (cost["flops"] - cost["conversion flops"]) / (ref["flops"] - ref["extra"])
    print(f"\n{arch} {mesh} {kind}: dot flops port {cost['dot flops']:.6e} XLA {ref['dot']:.6e} "
          f"({dots:.4f}); flops port {cost['flops']:.6e} XLA {ref['flops']:.6e} "
          f"({cost['flops'] / ref['flops']:.4f}); less conversions {work:.4f}; collectives "
          f"port {_counts(coll)} XLA {_counts(ref['coll'])}")
    assert abs(dots - 1) <= FLOPS_TOL
    assert abs(work - 1) <= OWN_BOUND.get((arch, mesh, kind), FLOPS_TOL)


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_per_card_flops_match_gspmds_plan(reference, meshes, arch, mesh, kind):
    _hold_to_xla(reference, meshes, arch, mesh, kind)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_ssm_train_at_4096_tokens_matches_gspmds_plan(reference, meshes, arch, mesh):
    """The SSM train cells at train_4k's 4096 tokens: the same plan as
    GSPMD's (dot flops within FLOPS_TOL) and the same elementwise bound as
    at 256 tokens. XLA's flops here include its CPU backend's conversions,
    3.3-5.1% of them at 2 layers (14.0% and 10.1% of mamba2's and zamba2's
    per-card flops at full depth on 16 x 16, where the port's total is
    0.82x and 0.85x the reference's)."""
    _hold_to_xla(reference, meshes, arch, mesh, "train_4k")


def test_decode_cases_trace_and_are_printed(reference, meshes):
    """Decode 4 x 1024 against the whole cache: printed beside XLA's, not
    held (the port counts the plan it runs; PERF.md says why XLA's is
    larger)."""
    for arch in ARCHS:
        for mesh in MESHES:
            ref = reference[_key(arch, mesh, "decode")]
            cost, coll = _trace(arch, meshes[mesh], "decode")
            work = (cost["flops"] - cost["conversion flops"]) / (ref["flops"] - ref["extra"])
            print(f"\n{arch} {mesh} decode_1k: flops port {cost['flops']:.4e} XLA "
                  f"{ref['flops']:.4e} ({cost['flops'] / ref['flops']:.3f}); less conversions "
                  f"{work:.3f}; dot flops port {cost['dot flops']:.4e} XLA {ref['dot']:.4e}; "
                  f"collectives port {_counts(coll)} XLA {_counts(ref['coll'])}")
            assert cost["dot flops"] > 0


def test_constrain_activations_moves_the_plan_where_the_references_moves(reference, meshes):
    """Under FSDP (yi-6b train on (2, 8): the weights' embed dim sharded
    over "data") pinning the activations to batch sharding at every block's
    entry changes both plans' collectives the same way (more all-gathers,
    fewer all-reduces), and the port's dot flops not at all (its attention
    already runs on the batch's shards; XLA's move by 1.6%). Where the
    reference's collectives do not move (gemma-2b, no FSDP), the port's
    plan does not either."""
    for arch, mesh, kind in TUNED:
        base, tuned = reference[_key(arch, mesh, kind)], reference[_key(arch, mesh, kind, True)]
        cost0, coll0 = _trace(arch, meshes[mesh], kind)
        cost1, coll1 = _trace(arch, meshes[mesh], kind, constrain_activations=True)
        print(f"\n{arch} {mesh} {kind} --constrain-activations: dot flops port "
              f"{cost1['dot flops'] / cost0['dot flops']:.4f}x XLA "
              f"{tuned['dot'] / base['dot']:.4f}x; collectives port {_counts(coll0)} -> "
              f"{_counts(coll1)}, XLA {_counts(base['coll'])} -> {_counts(tuned['coll'])}")
        if _counts(base["coll"]) == _counts(tuned["coll"]):
            assert cost1 == cost0 and coll1 == coll0
            continue
        assert abs(cost1["dot flops"] / cost0["dot flops"] - 1) <= FLOPS_TOL
        for op in ("all-gather", "all-reduce"):
            port = coll1.get(f"n_{op}", 0) - coll0.get(f"n_{op}", 0)
            ref = tuned["coll"].get(f"n_{op}", 0) - base["coll"].get(f"n_{op}", 0)
            assert port * ref > 0, (op, port, ref)
