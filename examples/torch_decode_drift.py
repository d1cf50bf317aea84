"""How far gemma-2b's teacher-forced decode drifts from its forward, in f32
and in float64, with the repo's seeded random weights.

``init_params`` takes the fan-in of a 3-D weight as ``shape[-2]``: 8 for
``wq`` (2048, 8, 256). The random model's attention logits are then far
wider than a trained model's, softmax is close to a hard argmax, and the
layers amplify rounding. This script prints, relative to max |logit| (or to
max |hidden| per layer):
  the std of layer 0's attention logits;
  f32 decode against the f32 forward, and the f32 forward against a float64
  forward (what ``chip_smoke.py``'s serve phase prints and does not hold);
  float64 decode against the float64 forward, layer by layer (what it holds).

    PYTHONPATH=src python examples/torch_decode_drift.py --device cuda
    PYTHONPATH=src python examples/torch_decode_drift.py --device cpu --layers 8 --vocab 4096 --tokens 16
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

sys.path.insert(0, "src")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import cache_descs, init_params, param_descs, zeros_from_descs  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.layers import rms_norm, rope  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def hidden_states(cfg, params, tokens, decode: bool) -> list:
    """The residual stream after each layer and the logits, (1, T, ...)."""
    T = tokens.shape[1]
    dev = tokens.device
    if not decode:
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
        x, out = tr._embed(cfg, params, tokens), []
        for i in range(cfg.num_layers):
            x = tr._block_apply(cfg, tree_map(lambda w: w[i], params["layers"]), x, pos,
                                kind="attn")
            out.append(x)
        return out + [tr.apply_head(cfg, params, x)]
    dtype = params["embed"].dtype
    cache = zeros_from_descs(cache_descs(cfg, 1, T), dtype, dev)
    per_t = []
    for t in range(T):
        x, row = tr._embed(cfg, params, tokens[:, t: t + 1]), []
        pos = torch.full((1, 1), t, dtype=torch.int32, device=dev)
        for i in range(cfg.num_layers):
            x = tr._block_apply(cfg, tree_map(lambda w: w[i], params["layers"]), x, pos,
                                kind="attn", cache=tree_map(lambda c: c[i], cache["layers"]),
                                cache_index=t)
            row.append(x)
        per_t.append(row + [tr.apply_head(cfg, params, x)])
    return [torch.cat(col, dim=1) for col in zip(*per_t)]


def gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--layers", type=int, default=18)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=None, help="default: the published 256000")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    base = get_config("gemma_2b")
    cfg = dataclasses.replace(base, num_layers=args.layers, vocab_size=args.vocab or base.vocab_size)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p32 = init_params(param_descs(cfg), gen, dtype=torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, args.tokens), generator=gen, device=dev)
    with torch.no_grad():
        h = rms_norm(tr._embed(cfg, p32, tokens), p32["layers"]["ln1"][0], cfg.norm_eps)
        attn = tree_map(lambda w: w[0], p32["layers"]["attn"])
        pos = torch.arange(args.tokens, device=dev)[None, None]
        q = rope(torch.einsum("bsd,dnh->bnsh", h, attn["wq"]), pos, cfg.rope_theta)
        k = rope(torch.einsum("bsd,dnh->bnsh", h, attn["wk"]), pos, cfg.rope_theta)
        logits0 = torch.einsum("bnsh,bmth->bnst", q, k) / np.sqrt(cfg.resolved_head_dim)
        fwd32 = hidden_states(cfg, p32, tokens, decode=False)
        dec32 = hidden_states(cfg, p32, tokens, decode=True)
        p64 = tree_map(lambda t: t.double(), p32)
        del p32
        fwd64 = hidden_states(cfg, p64, tokens, decode=False)
        dec64 = hidden_states(cfg, p64, tokens, decode=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"gemma-2b x{cfg.num_layers}, vocab {cfg.vocab_size}, {args.tokens} tokens, seed "
          f"{args.seed}, on {name}")
    print(f"layer 0 attention logits: std {float(logits0.std()):.1f}, max |.| "
          f"{float(logits0.abs().max()):.1f}")
    print(f"f32: decode vs forward {gap(dec32[-1], fwd32[-1]):.3e} of max |logit|; "
          f"f32 forward vs float64 forward {gap(fwd32[-1], fwd64[-1]):.3e}")
    print(f"float64: decode vs forward {gap(dec64[-1], fwd64[-1]):.3e} of max |logit|; "
          "by layer (of max |hidden|): "
          + ", ".join(f"{gap(d, f):.1e}" for d, f in zip(dec64[:-1], fwd64[:-1])))


if __name__ == "__main__":
    main()
