"""Speculative serving on the PyTorch port: decode tokens from a reduced-config
model where the generated text is exported to the client only behind a
speculation barrier (failure transparency), while the session's tokens
persist asynchronously through ``DecodeSessionStateObject`` (its decode
cache is derived state, rebuilt by replay on restore). The port's twin of
examples/serve_speculative.py.

Run:  PYTHONPATH=src python examples/torch_serve_speculative.py [--arch mamba2-370m] [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, "src")

from repro_torch.configs import ARCHITECTURES, canonical, get_config  # noqa: E402
from repro_torch.core import LocalCluster  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params, param_descs  # noqa: E402
from repro_torch.train import DecodeSessionStateObject  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_2b", type=canonical, choices=ARCHITECTURES)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = init_params(param_descs(cfg), torch.Generator(device=dev).manual_seed(0),
                         device=dev)

    with tempfile.TemporaryDirectory() as td:
        with LocalCluster(Path(td), group_commit_interval=0.010) as cluster:
            sess = cluster.add("session", lambda: DecodeSessionStateObject(
                Path(td) / "s", cfg, params, max_len=max(64, args.tokens + 1), device=dev))
            emitted = 0
            while emitted < args.tokens:
                if sess.generate(min(4, args.tokens - emitted)) is None:
                    cluster.refresh_all()
                    continue
                # stream to the client only what survives any failure:
                durable = sess.stream_durable(timeout=5.0)
                assert durable is not None
                print(f"[client] tokens[{emitted}:{len(durable)}] = "
                      f"{durable[emitted:]} (non-speculative)")
                emitted = len(durable)
            print(f"served {args.tokens} tokens from {cfg.name} on {dev} "
                  f"(reduced config, family={cfg.family})")


if __name__ == "__main__":
    main()
