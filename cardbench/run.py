#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port on the card.

    python3 cardbench/run.py --workload mamba2-370m.train-steady --seed 7 \
        --seconds 51 --trace 0

from the root of a checkout that holds ``BENCHMARK.json``, ``cardbench/``
and the system under test (``src/repro_torch``). Prints, as the last line
of standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (and ``breakdown`` when traced), then
``checks``: each number compared with the reference, beside its limit. The
same numbers are the last lines of standard error. Exits non-zero and
prints no result without a CUDA device, with fewer devices than the cell
asks for, or when JAX or the JAX package was loaded in the process.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the program's and the toolchains' caches, at fixed paths inside the checkout
CACHE = ROOT / ".cardbench_cache"
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # deterministic cuBLAS
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402


def finite(x):
    """JSON has no infinity or NaN: such a number is written as 1e308."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cardbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell asks for {cell.chips} devices, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                               device="cuda", t_process=T_PROCESS)
    except harness.ForbiddenImport as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    out = finite(out)
    for name, c in out["checks"].items():
        ok = c["limit"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'} ({c['where']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
