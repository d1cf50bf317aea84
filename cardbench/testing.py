"""Smoke-size cells for the benchmark's own tests, on the CPU.

Each cell of ``BENCHMARK.json`` with its configuration shrunk in width,
depth and vocabulary by the file's own ``smoke`` object (same family, same
traffic, same limits), so that a whole run takes seconds. A run can go in
a fresh process (``python -m cardbench.testing <cell> <fault|-> <trace>
<seconds>``, which prints the result line), so that what the test process
has loaded, JAX included, does not reach the harness's check of loaded
modules.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SMOKE_SEQ = 32


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over`` laid on it, sub-objects merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def smoke_cell(name: str):
    """The cell with its configuration's ``smoke`` object laid over its
    ``model``, two rows a step and ``SMOKE_SEQ`` tokens a row."""
    from cardbench import harness

    cell = harness.load_cell(name)
    config = copy.deepcopy(cell.config)
    config["model"] = merged(config["model"], config.get("smoke", {}))
    config["train_global_batch"] = 2
    cell.config = config
    cell.traffic = dict(cell.traffic, seq_len=SMOKE_SEQ)
    return cell


def run_smoke(name: str, fault: str = "-", traced: bool = False, seconds: float = 3.0,
              seed: int = 4_000_000_123) -> dict:
    """One smoke-size run on the CPU in this process, with a planted fault.
    The window is long enough for the kill cell's replay to pass its kill
    point on a loaded host."""
    from cardbench import faults, harness

    kw = {}
    if fault in faults.STEP_FAULTS:
        kw["wrap_step"] = faults.STEP_FAULTS[fault]
    elif fault in faults.TOKEN_FAULTS:
        kw["wrap_tokens"] = faults.TOKEN_FAULTS[fault]
    elif fault != "-":
        raise KeyError(fault)
    return harness.run_cell(smoke_cell(name), seed, seconds, traced, device="cpu", **kw)


def run_smoke_process(name: str, fault: str = "-", traced: bool = False,
                      seconds: float = 3.0) -> dict:
    """``run_smoke`` in a fresh interpreter; -> its result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "cardbench.testing", name, fault,
                          str(int(traced)), str(seconds)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    import torch

    torch.set_num_threads(1)  # smoke-size tensors: threads only contend on a shared host
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    cell, fault, traced, seconds = sys.argv[1:5]
    print(json.dumps(run_smoke(cell, fault, traced == "1", float(seconds))))
