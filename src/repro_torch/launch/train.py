"""Training launcher (port of ``repro/launch/train.py``, its local mode).

Runs the DSE-resilient training loop on one card (or the CPU with
``--device cpu``) on a registered architecture, the smoke config unless
``--full-config`` asks for the published dims, with optional failure
injection, and prints the run's result as JSON.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b --steps 6 \\
      --kill-at 3 --device cpu
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--kill-data-at", type=int, default=None)
    ap.add_argument("--group-commit-ms", type=float, default=20.0)
    ap.add_argument("--delta-codec", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="use the exact published dims (default: the reduced smoke config)")
    ap.add_argument("--out", default=None,
                    help="run directory (default: a new temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for (--device cpu)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.train import run_resilient_training

    cfg = get_config(args.arch, smoke=not args.full_config)
    out = Path(args.out) if args.out else Path(tempfile.mkdtemp(prefix="repro_torch_train_"))
    res = run_resilient_training(
        out,
        cfg,
        steps=args.steps,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        kill_trainer_at=args.kill_at,
        kill_data_at=args.kill_data_at,
        group_commit_interval=args.group_commit_ms / 1e3,
        use_delta_codec=args.delta_codec,
        device=args.device,
    )
    print(json.dumps({
        "arch": cfg.name,
        "final_step": res.final_step,
        "params_digest": res.params_digest,
        "rollbacks": res.rollbacks,
        "checkpoint_bytes": res.checkpoint_bytes,
        "first_loss": res.external_metrics[0][1] if res.external_metrics else None,
        "last_loss": res.external_metrics[-1][1] if res.external_metrics else None,
    }, indent=2))


if __name__ == "__main__":
    main()
