"""Transformer building blocks (port of ``repro/models/layers.py``).

Activations are ``x (B, S, D)``; attention weights keep the reference's
layout (``wq (D, N, H)``, ``wo (N, H, D)``) so parameters load unchanged from
the JAX package. Attention is plain torch math, as the reference's ``_sdpa``
is plain einsum, with GQA by repeating the kv heads (the reference's default
path). Decode caches are ``(B, Smax, Nkv, H)`` linear or ring buffers. Under
``Tuning.decode_seq_constraint`` decode takes the reference's grouped
"flash-decode" einsum instead, which reads the cache without repeating it.
Not ported yet: the cross-attention source (ROADMAP.md section 1).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import PDesc
from .tuning import get_tuning

F32 = torch.float32


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """The reference normalises and takes the softmax in f32; a float64
    model keeps float64 there."""
    return torch.promote_types(dtype, F32)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(_at_least_f32(x.dtype))
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w.to(x.dtype))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H) with H even; positions broadcastable to (..., S).
    Rotates concatenated halves, not interleaved pairs."""
    h = x.shape[-1]
    exponents = torch.arange(0, h, 2, dtype=F32, device=x.device) / h
    freqs = 1.0 / torch.pow(torch.full_like(exponents, theta), exponents)
    angles = positions[..., None].to(F32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : h // 2], x[..., h // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _soft_cap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(logits / cap) * cap if cap > 0 else logits


def attn_descs(cfg: ModelConfig) -> Dict[str, PDesc]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": PDesc((d, nq, hd), ("embed", "heads", None)),
        "wk": PDesc((d, nkv, hd), ("embed", "kv_heads", None)),
        "wv": PDesc((d, nkv, hd), ("embed", "kv_heads", None)),
        "wo": PDesc((nq, hd, d), ("heads", None, "embed")),
    }


def _sdpa(q, k, v, mask: Optional[torch.Tensor], softcap: float = 0.0) -> torch.Tensor:
    """q/k/v (B, S|T, N, H) with kv already repeated to N heads."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = torch.einsum("bsnh,btnh->bnst", q, k).to(_at_least_f32(q.dtype)) * scale
    logits = _soft_cap(logits, softcap)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnh->bsnh", probs, v)


def _cache_mask(smax: int, cache_index: int, idx: int, window: Optional[int],
                ring: bool, device) -> torch.Tensor:
    """Valid cache slots (1, 1, 1, Smax) at decode position ``cache_index``."""
    slot = torch.arange(smax, dtype=torch.int32, device=device)
    if ring:
        # slot holds absolute position cache_index - ((idx - slot) mod smax)
        abs_pos = cache_index - torch.remainder(idx - slot, smax)
        valid = (abs_pos >= 0) & (abs_pos <= cache_index)
        if window is not None:
            valid &= abs_pos > cache_index - window
    else:
        valid = slot <= cache_index
        if window is not None:
            valid &= slot > cache_index - window
    return valid[None, None, None, :]


def attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, S, D)
    cfg: ModelConfig,
    positions: torch.Tensor,             # (B, S) absolute positions of x
    *,
    window: Optional[int] = None,        # sliding-window size (local attention)
    cache: Optional[Dict[str, torch.Tensor]] = None,  # decode: {"k","v"} (B,Smax,Nkv,H)
    cache_index: Optional[int] = None,   # write offset, a host int
    ring: bool = False,                  # the cache is a ring buffer
    cross_src: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self-attention over ``positions``; returns ``(out, new_cache)``.

    With a cache, this step's k/v are written into ``cache`` in place at
    ``cache_index`` (modulo Smax for a ring) and the same dict is returned:
    the cache passed in is consumed, where the reference returns a new one
    from ``dynamic_update_slice``. An index the write does not fit raises,
    where ``dynamic_update_slice`` would clamp it."""
    if cross_src is not None:
        raise NotImplementedError("cross-attention (encdec, vlm) is not ported yet")
    B, S, D = x.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    groups = nq // nkv
    flash_decode = cache is not None and get_tuning().decode_seq_constraint

    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"])
    pos = positions[:, None, :]
    q = rope(q.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
    k = rope(k.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)

    if cache is not None:
        smax = cache["k"].shape[1]
        idx = cache_index % smax if ring else cache_index
        if not 0 <= idx <= smax - S:
            raise ValueError(f"cache index {cache_index} does not fit {S} token(s) in a "
                             f"cache of {smax}")
        cache["k"][:, idx: idx + S] = k
        cache["v"][:, idx: idx + S] = v
        k, v = cache["k"], cache["v"]
        mask = _cache_mask(smax, cache_index, idx, window, ring, x.device)
    else:
        mask = None
        qpos = positions[:, None, :, None]              # (B,1,S,1)
        kpos = positions[:, None, None, :]              # (B,1,1,T)
        if causal:
            mask = kpos <= qpos
        if window is not None:
            near = kpos > qpos - window
            mask = near if mask is None else mask & near
    if flash_decode:
        # the grouped einsum: no kv repeat; the mask broadcasts over G
        qg = q.reshape(B, S, nkv, groups, hd)
        scale = 1.0 / np.sqrt(hd)
        logits = torch.einsum("bsngh,btnh->bngst", qg, k).to(_at_least_f32(q.dtype)) * scale
        logits = _soft_cap(logits, cfg.logit_softcap)
        logits = torch.where(mask[:, :, None], logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bngst,btnh->bsngh", probs, v).reshape(B, S, nq, hd)
        return torch.einsum("bsnh,nhd->bsd", out, p["wo"]), cache
    if groups > 1:  # jnp.repeat(k, groups, axis=2); backward is a plain sum
        T = k.shape[1]
        k = k[:, :, :, None].expand(B, T, nkv, groups, hd).reshape(B, T, nq, hd)
        v = v[:, :, :, None].expand(B, T, nkv, groups, hd).reshape(B, T, nq, hd)
    out = _sdpa(q, k, v, mask, cfg.logit_softcap)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"]), cache


def mlp_descs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, PDesc]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": PDesc((d, f), ("embed", "ffn")),
        "wi_up": PDesc((d, f), ("embed", "ffn")),
        "wo": PDesc((f, d), ("ffn", "embed")),
    }


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, activation: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    gate = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
    gate = F.gelu(gate, approximate="tanh") if activation == "gelu" else F.silu(gate)
    h = gate * torch.einsum("bsd,df->bsf", x, p["wi_up"])
    return torch.einsum("bsf,fd->bsd", h, p["wo"])
