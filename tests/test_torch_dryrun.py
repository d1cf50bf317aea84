"""The port's dry run (``launch/dryrun.py``) and its report
(``analysis/report.py``) against the JAX package's.

  * ``skip_reason``, ``scaled_pair`` and ``extrapolate`` equal the
    reference's for every architecture and shape;
  * the port's per-device flops for gemma-2b at full width and 2 layers,
    prefill 4 x 256 on a (data, model) = (2, 2) mesh, lie within FLOPS_TOL
    of the flops of XLA's cost analysis of the reference's ``_compile_cell``
    on 4 placeholder CPU devices (both stacks unrolled, so both count both
    layers); bytes and collectives are printed beside each other, not held
    equal: DTensor is not GSPMD, and the port counts unfused operators;
  * the dense cells come out ``ok`` at full config on the production meshes
    (gemma-2b's three shapes on 16 x 16 and 2 x 16 x 16, gemma3-4b's
    long_500k on 16 x 16), with the reference's record keys less
    ``memory_xla_raw``, plus ``memory_local``;
  * a cell DTensor cannot partition (granite-moe through the EP route,
    whose collectives run on plain tensors) is recorded ``failed`` with the
    operator and the port's line, and ``main`` exits 1;
  * ``report.roofline_table`` and ``pick_hillclimb`` give the reference's
    output on the same rows, with the fits key mapped.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` when it is imported, so the
reference's dry run runs in a subprocess only. Each fake process group is
created in a fixture and destroyed in it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro.analysis import report as ref_report  # noqa: E402
from repro.analysis.roofline import roofline_terms as ref_roofline_terms  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import shape_by_name as ref_shape_by_name  # noqa: E402
from repro_torch.analysis import report  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import SHAPES  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the port's flops against XLA's on the (2, 2) check: measured 0.19% apart
#: (the port 1.15994e11, XLA 1.16218e11 per device; the dot flops agree and
#: the two count elementwise work differently)
FLOPS_TOL = 0.01
CHECK_LAYERS, CHECK_SHAPE = 2, ("prefill_256", "prefill", 256, 4)
#: the reference's keys of an "ok" record (repro/launch/dryrun.py, build_cell)
REF_OK_KEYS = {"arch", "shape", "mesh", "chips", "variant", "status", "compile_s", "profile",
               "memory_xla_raw", "memory_est", "cost", "collectives", "cost_method", "roofline"}

_REF = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses as dc
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs import ARCHITECTURES, get_config
from repro.models import SHAPES
from repro.models.config import ShapeConfig
from repro.launch.dryrun import (_compile_cell, _cost_and_collectives, extrapolate,
                                 scaled_pair, skip_reason)
from repro.models.scan_utils import scan_unroll

layers, shape = json.loads(sys.argv[2])
out = {"archs": {}}
for arch in ARCHITECTURES:
    cfg = get_config(arch)
    small, large, extra = scaled_pair(cfg)
    out["archs"][arch] = {
        "skip": {s.name: skip_reason(cfg, s) for s in SHAPES},
        "pair": [small.num_layers, small.encoder_layers, large.num_layers,
                 large.encoder_layers, extra],
        "extrapolate": extrapolate({"flops": 3.0, "bytes": 10.0, "name": "x"},
                                   {"flops": 5.0, "bytes": 7.0}, extra),
    }
cfg = dc.replace(get_config("gemma_2b"), num_layers=layers)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
with scan_unroll():
    compiled, _ = _compile_cell(cfg, ShapeConfig(*shape), mesh, "full")
out["cost"], out["collectives"] = _cost_and_collectives(compiled)
json.dump(out, open(sys.argv[1], "w"))
print("REF-DRYRUN-OK")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_dryrun")
    (out / "ref.py").write_text(_REF)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, str(out / "ref.py"), str(out / "ref.json"),
                          json.dumps([CHECK_LAYERS, CHECK_SHAPE])],
                         capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))
    assert "REF-DRYRUN-OK" in run.stdout, run.stderr[-4000:]
    return json.loads((out / "ref.json").read_text())


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_skip_pair_and_extrapolate_equal_the_references(reference, arch):
    ref = reference["archs"][arch]
    cfg = get_config(arch)
    assert {s.name: dryrun.skip_reason(cfg, s) for s in SHAPES} == ref["skip"]
    small, large, extra = dryrun.scaled_pair(cfg)
    assert [small.num_layers, small.encoder_layers, large.num_layers, large.encoder_layers,
            extra] == ref["pair"]
    assert dryrun.extrapolate({"flops": 3.0, "bytes": 10.0, "name": "x"},
                              {"flops": 5.0, "bytes": 7.0}, extra) == ref["extrapolate"]


@pytest.fixture
def fake_world(request):
    """A fake process group, destroyed on teardown: "single" and "multi"
    give the production meshes, 4 a (2, 2) host mesh."""
    if request.param in ("single", "multi"):
        with dryrun.fake_world(request.param == "multi", device_type="cpu") as mesh:
            yield mesh
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=request.param)
    try:
        yield make_host_mesh(model=2, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fake_world", [4], indirect=True)
def test_flops_agree_with_the_references_xla_cost(reference, fake_world):
    import dataclasses

    cfg = dataclasses.replace(get_config("gemma_2b"), num_layers=CHECK_LAYERS)
    counter, _, _ = dryrun._trace_cell(cfg, ShapeConfig(*CHECK_SHAPE), fake_world, "full")
    cost, coll = dryrun._cost_and_collectives(counter)
    print(f"\n(2, 2) check, per device: flops port {cost['flops']:.6e} XLA "
          f"{reference['cost']['flops']:.6e}; bytes port {cost['bytes accessed']:.6e} XLA "
          f"{reference['cost']['bytes accessed']:.6e}; collectives port {coll} XLA "
          f"{reference['collectives']}")
    assert abs(cost["flops"] / reference["cost"]["flops"] - 1) <= FLOPS_TOL
    assert cost["dot flops"] <= cost["flops"]


DENSE_CELLS = [("single", "gemma-2b", s) for s in ("train_4k", "prefill_32k", "decode_32k")] + [
    ("multi", "gemma-2b", s) for s in ("train_4k", "prefill_32k", "decode_32k")] + [
    ("single", "gemma3-4b", "long_500k")]


@pytest.mark.parametrize("fake_world,arch,shape_name", DENSE_CELLS,
                         indirect=["fake_world"])
def test_dense_cells_are_ok_on_the_production_meshes(fake_world, arch, shape_name):
    multi = fake_world.ndim == 3
    rec = dryrun.build_cell(arch, shape_name, multi, mesh=fake_world)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == (REF_OK_KEYS - {"memory_xla_raw"}) | {"memory_local"}
    assert rec["chips"] == (512 if multi else 256)
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    cfg, shape = ref_get_config(arch), ref_shape_by_name(shape_name)
    ref_terms = ref_roofline_terms({"flops": 1.0, "bytes accessed": 1.0}, {"total": 1.0},
                                   cfg, shape, rec["chips"])
    assert set(rec["roofline"]) == set(ref_terms)
    assert rec["memory_est"]["fits_hbm"] and "fits_16g" not in rec["memory_est"]
    assert rec["cost"]["flops"] >= rec["cost"]["dot flops"] > 0
    assert rec["cost"]["bytes accessed"] > 0 and rec["memory_local"]["argument_bytes"] > 0
    assert rec["cost_method"].startswith("counted at full depth")
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")


def test_a_cell_dtensor_cannot_partition_is_recorded_failed(tmp_path, capsys):
    """The EP route runs its all-to-all on plain tensors, which DTensor has
    no rule for: the cell is ``failed`` with the operator and the port's
    line, and ``main`` exits 1. The cell's line on standard output carries
    its kernel launches, none."""
    out = tmp_path / "cells.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "granite-moe-3b-a800m", "--shape", "prefill_32k",
                     "--moe-impl", "ep", "--device-type", "cpu", "--out", str(out)])
    assert e.value.code == 1
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "failed"
    assert "alltoall" in rec["error"] and "sharding strategy" in rec["error"]
    assert rec["where"].startswith("repro_torch/parallel/ep_moe.py:")
    brief = json.loads(capsys.readouterr().out.splitlines()[0])
    assert brief["status"] == "failed"
    assert brief["launches"] == {"delta_encode": 0, "delta_decode": 0, "ssd": 0,
                                 "flash_attention": 0}
    assert not dist.is_initialized()


def _rows(fits_key: str):
    """Dry-run records as both packages' reports read them."""
    rows = []
    for i, (arch, shape, status) in enumerate([
            ("yi-6b", "train_4k", "ok"), ("gemma-2b", "train_4k", "ok"),
            ("gemma-2b", "decode_32k", "ok"), ("glm4-9b", "prefill_32k", "ok"),
            ("gemma-2b", "long_500k", "skipped"), ("granite-moe-3b-a800m", "prefill_32k",
                                                    "failed")]):
        r = {"arch": arch, "shape": shape, "mesh": "16x16", "status": status}
        if status == "ok":
            r["roofline"] = {"compute_s": 0.3 / (i + 1), "memory_s": 2e-3 * (i + 1),
                             "collective_s": 4e-6 * (i + 2), "dominant": "compute",
                             "useful_ratio": 0.1 * (i + 1), "roofline_fraction": 0.05 * (i + 1),
                             "model_flops_global": 1e15 * (3 - i)}
            r["memory_est"] = {"hbm_fraction": 0.2 * i, fits_key: i != 2}
        rows.append(r)
    return rows


def test_report_gives_the_references_tables(tmp_path):
    ref_rows, rows = _rows("fits_16g"), _rows("fits_hbm")
    want = ref_report.roofline_table(ref_rows).replace("| fits |", "| fits 80 GB |")
    assert report.roofline_table(rows) == want
    pick, ref_pick = report.pick_hillclimb(rows), ref_report.pick_hillclimb(ref_rows)
    assert {k: (r["arch"], r["shape"]) for k, r in pick.items()} == {
        k: (r["arch"], r["shape"]) for k, r in ref_pick.items()}
    path = tmp_path / "cells.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows + rows[:1]) + "\nnot json\n")
    assert len(report.load(path)) == len(rows)
