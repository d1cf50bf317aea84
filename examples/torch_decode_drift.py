"""How far a model's teacher-forced decode drifts from its forward, in f32
and in float64, with the repo's seeded random weights (gemma-2b by default;
``--arch gemma3-4b`` for the grouped local/global plan, ``granite-moe-3b-a800m``
for MoE, ``deepseek-v2-lite-16b`` for MLA with MoE, ``zamba2-1.2b`` for the
hybrid, ``seamless-m4t-large-v2`` for the encoder-decoder,
``llama-3.2-vision-90b`` for the gated cross-attention groups; any
architecture with attention).

``init_params`` takes the fan-in of a 3-D weight as ``shape[-2]``: 8 for
``wq`` (2048, 8, 256) of gemma-2b and (2560, 8, 256) of gemma3-4b, the head
count for the others (``w_q`` of MLA too). The random model's attention
logits are then far wider than a trained model's, softmax is close to a
hard argmax, and the layers amplify rounding. A MoE model is compared at a
capacity that drops no token (capacity factor E / k): a forward over T
tokens drops a (token, slot) past its expert's capacity, which one decoded
token never meets, so at the published factor the two differ by design.
The encdec and vlm families get seeded stub frames or image embeddings of
the std of an embedded token. The encdec decode is primed as the
reference's tests prime it: a forward with the cache runs the encoder and
stores its output, which the decode steps cross-attend to (``--layers``
cuts the encoder and the decoder alike; the layers printed are the
decoder's). The vlm's cross-block gates, 0 at init, are set to seeded
values of magnitude 0.5-1.5 and random sign, so its cross blocks count.
This script prints, relative to max |logit| (or to max |hidden| per layer):
  the std of layer 0's attention logits;
  f32 decode against the f32 forward, and the f32 forward against a float64
  forward (what ``chip_smoke.py``'s serve phase prints and does not hold);
  float64 decode against the float64 forward, layer by layer (what it holds).

    PYTHONPATH=src python examples/torch_decode_drift.py --device cuda
    PYTHONPATH=src python examples/torch_decode_drift.py --device cuda --arch gemma3-4b --layers 34
    PYTHONPATH=src python examples/torch_decode_drift.py --device cuda --arch deepseek-v2-lite-16b --layers 5
    PYTHONPATH=src python examples/torch_decode_drift.py --device cuda --arch zamba2-1.2b --tokens 256
    PYTHONPATH=src python examples/torch_decode_drift.py --device cuda --arch seamless-m4t-large-v2
    PYTHONPATH=src python examples/torch_decode_drift.py --device cuda --arch llama-3.2-vision-90b --layers 5
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


def extras_for(cfg, gen, dtype) -> dict:
    """Seeded stub frames (encdec) or image embeddings (vlm), batch 1, of
    the std of an embedded token: rows of std 1/sqrt(vocab_padded), times
    sqrt(d_model) under gelu."""
    if cfg.family not in ("encdec", "vlm"):
        return {}
    key, n = (("frames", cfg.source_len) if cfg.family == "encdec"
              else ("image_embeds", cfg.num_image_tokens))
    std = np.sqrt((cfg.d_model if cfg.activation == "gelu" else 1) / cfg.vocab_padded)
    x = torch.randn((1, n, cfg.d_model), generator=gen, device=gen.device) * std
    return {key: x.to(dtype)}


def open_gates(params, gen) -> None:
    """Set a vlm's cross-block gates, 0 at init, to seeded values of
    magnitude 0.5-1.5 and random sign, in place."""
    gc = params["group_cross"]
    for holder, key in ((gc["attn"], "gate"), (gc, "mlp_gate")):
        t = holder[key]
        mag = torch.rand(t.shape, generator=gen, device=t.device) + 0.5
        sign = torch.randint(0, 2, t.shape, generator=gen, device=t.device) * 2 - 1
        holder[key] = (mag * sign).to(t.dtype)


def to_double(tree) -> None:
    """Every leaf of a nested dict to float64, in place, one at a time (the
    f32 copy of each is freed before the next is made)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            to_double(v)
        else:
            tree[k] = v.double()
            del v


def hidden_states(cfg, params, tokens, extras, decode: bool) -> tuple:
    """The residual stream after each layer and the logits, (1, T, ...), of
    the model's forward (or of T decode steps), taken from each call of the
    model's block (the encdec decoder's block); and the first such layer's
    params."""
    name = "_decoder_block" if cfg.family == "encdec" else "_block_apply"
    seen, block = [], getattr(tr, name)

    def recorded(*args, **kw):
        out = block(*args, **kw)
        seen.append((args[1], out[0] if isinstance(out, tuple) else out))
        return out

    setattr(tr, name, recorded)
    try:
        if not decode:
            logits = tr.forward(cfg, params, tokens, extras=extras)[0]
            return [x for _, x in seen] + [logits], seen[0][0]
        cache = zeros_from_descs(cache_descs(cfg, 1, tokens.shape[1]), params["embed"].dtype,
                                 tokens.device)
        if cfg.family == "encdec":  # store the encoder output in the cache
            tr.forward(cfg, params, tokens[:, :1], extras=extras, cache=cache, cache_index=0)
        per_t = []
        for t in range(tokens.shape[1]):
            seen.clear()
            logits, cache = tr.decode_step(cfg, params, cache, tokens[:, t: t + 1], t,
                                           extras=extras)
            per_t.append([x for _, x in seen] + [logits])
        return [torch.cat(col, dim=1) for col in zip(*per_t)], seen[0][0]
    finally:
        setattr(tr, name, block)


def layer0_logits(cfg, lp, h, tokens: int):
    """The attention logits of the model's first attention block on ``h``."""
    pos = torch.arange(tokens, device=h.device)[None, None]
    a = lp["attn"]
    if "wq" in a:
        q = rope(torch.einsum("bsd,dnh->bnsh", h, a["wq"]), pos, cfg.rope_theta)
        k = rope(torch.einsum("bsd,dnh->bnsh", h, a["wk"]), pos, cfg.rope_theta)
        if k.shape[1] != q.shape[1]:
            k = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
        return torch.einsum("bnsh,bnth->bnst", q, k) / np.sqrt(cfg.resolved_head_dim)
    m = cfg.mla  # MLA: the nope and rope terms
    q = (torch.einsum("bsd,dr,rnh->bnsh", h, a["w_dq"], a["w_uq"]) if m.q_lora_rank
         else torch.einsum("bsd,dnh->bnsh", h, a["w_q"]))
    q_nope, q_pe = q[..., : m.qk_nope_head_dim], rope(q[..., m.qk_nope_head_dim:], pos,
                                                       cfg.rope_theta)
    dkv = torch.einsum("bsd,dr->bsr", h, a["w_dkv"])
    k_nope = torch.einsum("btr,rnh->bnth", dkv[..., : m.kv_lora_rank], a["w_uk"])
    k_pe = rope(dkv[..., m.kv_lora_rank:], pos[0], cfg.rope_theta)
    logits = (torch.einsum("bnsh,bnth->bnst", q_nope, k_nope)
              + torch.einsum("bnsh,bth->bnst", q_pe, k_pe))
    return logits / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--arch", default="gemma-2b", help="an architecture with attention")
    ap.add_argument("--layers", type=int, default=None, help="default: the published depth")
    ap.add_argument("--tokens", type=int, default=None,
                    help="default: 64, or the SSD chunk (256) for the hybrid")
    ap.add_argument("--vocab", type=int, default=None, help="default: the published one")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    base = get_config(args.arch)
    cfg = dataclasses.replace(base, num_layers=args.layers or base.num_layers,
                              vocab_size=args.vocab or base.vocab_size)
    if cfg.family == "encdec":  # cut the encoder as the decoder
        cfg = dataclasses.replace(cfg, encoder_layers=args.layers or base.encoder_layers)
    if cfg.moe is not None:  # a capacity no expert overflows (see above)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    n = args.tokens or (cfg.ssm.chunk_size if cfg.ssm is not None else 64)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(param_descs(cfg), gen, dtype=torch.float32, device=dev)
    if cfg.family == "vlm":
        open_gates(params, gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen, device=dev)
    ext32 = extras_for(cfg, gen, torch.float32)
    ext64 = tree_map(lambda t: t.double(), ext32)
    with torch.no_grad():
        fwd32, lp0 = hidden_states(cfg, params, tokens, ext32, decode=False)
        dec32, _ = hidden_states(cfg, params, tokens, ext32, decode=True)
        h = rms_norm(tr._embed(cfg, params, tokens), lp0["ln1"], cfg.norm_eps)
        logits0 = layer0_logits(cfg, lp0, h, n)
        del lp0, h
        to_double(params)
        fwd64, _ = hidden_states(cfg, params, tokens, ext64, decode=False)
        dec64, _ = hidden_states(cfg, params, tokens, ext64, decode=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    depth = (f"x{cfg.encoder_layers} encoder + x{cfg.num_layers} decoder"
             if cfg.family == "encdec" else f"x{cfg.num_layers}")
    print(f"{cfg.name} {depth}, vocab {cfg.vocab_size}, {n} tokens, seed "
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
