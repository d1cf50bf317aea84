"""Transformer building blocks, training branch (port of ``repro/models/layers.py``).

Activations are ``x (B, S, D)``; attention weights keep the reference's
layout (``wq (D, N, H)``, ``wo (N, H, D)``) so parameters load unchanged from
the JAX package. Attention is plain torch math, as the reference's ``_sdpa``
is plain einsum: no cache, no cross-attention source, no window, softcap 0.
The decode branch (caches, ring buffers) comes with the serving slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import PDesc

F32 = torch.float32


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
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


def attn_descs(cfg: ModelConfig) -> Dict[str, PDesc]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": PDesc((d, nq, hd), ("embed", "heads", None)),
        "wk": PDesc((d, nkv, hd), ("embed", "kv_heads", None)),
        "wv": PDesc((d, nkv, hd), ("embed", "kv_heads", None)),
        "wo": PDesc((nq, hd, d), ("heads", None, "embed")),
    }


def _sdpa(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q/k/v (B, S|T, N, H) with kv already repeated to N heads."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = torch.einsum("bsnh,btnh->bnst", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnh->bsnh", probs, v)


def attention(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Self-attention over positions (B, S); GQA by repeating kv heads."""
    if cfg.logit_softcap:
        raise NotImplementedError("logit_softcap is not ported yet")
    B, S, D = x.shape
    groups = cfg.num_heads // cfg.num_kv_heads

    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"])
    pos = positions[:, None, :]
    q = rope(q.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
    k = rope(k.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)

    mask = None
    if causal:
        mask = positions[:, None, None, :] <= positions[:, None, :, None]  # (B,1,S,T)
    if groups > 1:  # jnp.repeat(k, groups, axis=2); backward is a plain sum
        T, nkv, hd = k.shape[1:]
        k = k[:, :, :, None].expand(B, T, nkv, groups, hd).reshape(B, T, nkv * groups, hd)
        v = v[:, :, :, None].expand(B, T, nkv, groups, hd).reshape(B, T, nkv * groups, hd)
    out = _sdpa(q, k, v, mask)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"])


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
