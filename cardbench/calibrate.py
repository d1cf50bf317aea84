#!/usr/bin/env python3
"""Read the numbers that set the limits of ``correct`` (``check.py``), at a
cell's own sizes, in one process:

- the program's sound readings against the reference's, over many seeds
  (the lower readings);
- the control: the reference in TF32, the precision below the configured
  float32, put in the program's place (an upper reading);
- each fault the cell can have (``faults.py``), planted in the program.

The program is driven here through its train step
(``launch.steps.make_train_step``), the call ``TrainerStateObject.train_on``
makes in a run, from the same seeded weights and batches; one run's set-up
(the cluster and its version-0 persist) would cost minutes a seed.

    python3 cardbench/calibrate.py --workload mamba2-370m.train-steady \
        --seeds 12 --controls 3 --out calibrate.jsonl

Prints one JSON line a seed and a summary: the largest sound reading and
the smallest control and fault readings of each number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from cardbench import check, faults, harness, weights  # noqa: E402
from cardbench.tokens import TokenStream  # noqa: E402


def program_readings(cell, seed: int, device, wrap_step=None, wrap_tokens=None) -> dict:
    """The program's readings of the first steps, through its train step,
    under the configuration's step options."""
    from repro_torch.models.tuning import tuning
    from repro_torch.optim import adamw_init

    config, traffic = cell.config, cell.traffic
    m = config["model"]
    descs = harness.family(config).descs(m)
    opt = dict(traffic["optimizer"])
    stream = TokenStream(m["vocab_size"], int(config["train_global_batch"]),
                         int(traffic["seq_len"]), seed, **traffic["tokens"])
    fed = stream if wrap_tokens is None else wrap_tokens(stream)
    cfg, options = harness.program_model(config)
    step_fn = harness.program_step(cfg, traffic)
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)
    out = {"loss": []}
    with tuning(**options):
        params = weights.tree(descs, seed, device)
        state = adamw_init(params)
        for i in range(int(traffic["warmup_steps"])):
            params, state, loss = step_fn(params, state, {"tokens": fed.batch_at(i)})
            out["loss"].append(float(loss))
            if i == 0:
                out["grad"] = check.grad_norms(descs, state["m"], opt["b1"])
        out["update"] = check.change_norms(descs, params, weights.leaves(descs, seed, device))
    return out


def reference(cell, seed: int, device, tf32: bool = False) -> dict:
    config, traffic = cell.config, cell.traffic
    m = config["model"]
    n = int(traffic["warmup_steps"])
    stream = TokenStream(m["vocab_size"], int(config["train_global_batch"]),
                         int(traffic["seq_len"]), seed, **traffic["tokens"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return harness.reference_readings(config, seed, [stream.batch_at(s) for s in range(n)],
                                          device, n, dict(traffic["optimizer"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def numbers(prog: dict, ref: dict) -> dict:
    return {k: v for k, (v, _) in check.compare(prog, ref).items()}


def calibrate(cell, seeds, controls, device, log=print) -> dict:
    """-> {"sound": [numbers a seed], "control": [...], "<fault>": [...]}."""
    out = {"sound": [], "control": []}
    for k in (*faults.STEP_FAULTS, *faults.TOKEN_FAULTS):
        out[k] = []
    with harness.deterministic():
        for i, seed in enumerate(seeds):
            t = time.perf_counter()
            ref = reference(cell, seed, device)
            row = {"seed": seed, "sound": numbers(program_readings(cell, seed, device), ref)}
            if i < controls:
                row["control"] = numbers(reference(cell, seed, device, tf32=True), ref)
                for k, f in faults.STEP_FAULTS.items():
                    row[k] = numbers(program_readings(cell, seed, device, wrap_step=f), ref)
                for k, f in faults.TOKEN_FAULTS.items():
                    row[k] = numbers(program_readings(cell, seed, device, wrap_tokens=f), ref)
            row["seconds"] = time.perf_counter() - t
            log(json.dumps(row))
            for k in out:
                if k in row:
                    out[k].append(row[k])
    return out


def summary(out: dict) -> dict:
    """The largest sound reading and the smallest reading of the control and
    of each fault, per number."""
    res = {}
    for name in check.COMPARED:
        res[name] = {"sound_max": max(r[name] for r in out["sound"])}
        for k, rows in out.items():
            if k != "sound" and rows:
                res[name][f"{k}_min"] = min(r[name] for r in rows)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="read the limits' readings at a cell's sizes")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    sink = open(args.out, "a") if args.out else None

    def log(line):
        print(line, flush=True)
        if sink:
            sink.write(json.dumps({"workload": args.workload, **json.loads(line)}) + "\n")
            sink.flush()

    out = calibrate(cell, seeds, args.controls, torch.device("cuda"), log)
    log(json.dumps({"summary": summary(out), "card": torch.cuda.get_device_name(),
                    "power_limit": harness.nvidia_smi()}))
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
