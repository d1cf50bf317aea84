"""The result line, the refusals, and what a run's process loads."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from cardbench import harness, testing  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_last_line_keys(traced):
    """The line has exactly ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and ``breakdown`` when traced), then the
    numbers compared beside their limits under a key of their own, last."""
    out = testing.run_smoke_process("zamba2-1.2b-x8.train-kill", traced=traced)
    want = KEYS + (["breakdown"] if traced else [])
    assert list(out)[:-1] == want and list(out)[-1] == "checks"
    assert out["correct"] is True
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    cell = harness.load_cell("zamba2-1.2b-x8.train-kill")
    entries = cell.per_layer if traced else cell.end_to_end
    # a CPU run names no device metric: the rooflines, the MFU and the idle
    # share are left out of the line there
    cpu_silent = {"train_mfu", "device_idle_pct"}
    assert set(out["metrics"]) == {m["name"] for m in entries} - cpu_silent
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit", "where"} and c["value"] <= c["limit"], name
    if traced:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])


def test_no_card_no_result():
    """Without a card the command fails and prints nothing on stdout; it
    does not fall back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "cardbench/run.py", "--workload",
                          "mamba2-370m.train-steady", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_no_jax_after_the_harness_imports():
    """What a run imports (the harness, the metric readers, the system's
    modules it drives) loads no module named jax, jaxlib, flax or repro."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from cardbench import harness, calibrate, run\n"
        "import repro_torch.checkpoint, repro_torch.core, repro_torch.data\n"
        "import repro_torch.launch.steps, repro_torch.optim, repro_torch.models\n"
        "for m in ['train_tokens_per_s', 'setup_s', 'dse_overhead_ms', 'persist_v0_s',\n"
        "          'restore_s', 'step_ms', 'train_mfu', 'device_idle_pct']:\n"
        "    harness.load_reader(m)\n"
        "print(sorted({k.split('.')[0] for k in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)
    assert "repro_torch" in loaded


def test_run_refuses_a_process_that_holds_jax(monkeypatch):
    """The harness's own look once the window has closed: a module named
    jax in the process fails the run, and no result is made."""
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.ForbiddenImport) as e:
        testing.run_smoke("mamba2-370m.train-steady", seconds=0.2)
    assert "jax" in e.value.names


def test_run_refuses_jax_brought_in_by_a_reader():
    """A metric reader (or the reference, or a FLOP module) that imports
    JAX is seen: the look comes after all of them have run."""
    code = (
        "import sys, types; sys.path[:0] = ['src', '.']\n"
        "import torch; torch.set_num_threads(1)\n"
        "from cardbench import harness, testing\n"
        "real = harness.load_reader\n"
        "def planting(name):\n"
        "    read = real(name)\n"
        "    def planted(run):\n"
        "        sys.modules['jax'] = types.ModuleType('jax')\n"
        "        return read(run)\n"
        "    return planted\n"
        "harness.load_reader = planting\n"
        "try:\n"
        "    testing.run_smoke('mamba2-370m.train-steady', seconds=0.2)\n"
        "except harness.ForbiddenImport as e:\n"
        "    print('refused', e.names)\n"
        "else:\n"
        "    print('result')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "refused ['jax']"
