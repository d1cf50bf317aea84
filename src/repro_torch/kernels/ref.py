"""Plain PyTorch versions of the hand-written kernels (the allclose targets).

Mirrors ``repro/kernels/ref.py``. The CPU tests run these, and the kernel
wrappers take them only for tensors that lie on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale=None) -> torch.Tensor:
    """q/k/v: (BH, S|T, D) -- plain softmax attention in f32."""
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(ki <= qi, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True) -> torch.Tensor:
    """q (B,S,Nq,H), k/v (B,T,Nkv,H) -> (B,S,Nq,H): kv heads repeated to Nq
    (head h reads kv head h // (Nq/Nkv)), then ``flash_attention_ref``."""
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    if nq != nkv:
        k = torch.repeat_interleave(k, nq // nkv, dim=2)
        v = torch.repeat_interleave(v, nq // nkv, dim=2)
    qf = q.transpose(1, 2).reshape(b * nq, s, hd)
    kf = k.transpose(1, 2).reshape(b * nq, t, hd)
    vf = v.transpose(1, 2).reshape(b * nq, t, hd)
    o = flash_attention_ref(qf, kf, vf, causal=causal)
    return o.reshape(b, nq, s, hd).transpose(1, 2)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Sequential (non-chunked) SSD recurrence -- the ground truth.
    x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N); returns y (B,S,H,P).
    Head ``h`` reads group ``h // (H/G)``, as ``jnp.repeat`` lays it out."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    Bh = torch.repeat_interleave(Bm, rep, dim=2).float()   # (B,S,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=2).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af)                    # (B,H)
        state = state * decay[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)               # (B,S,H,P)


def delta_encode_ref(new: torch.Tensor, prev: torch.Tensor):
    delta = new.float() - prev.float()
    amax = delta.abs().amax(dim=1)
    # divide by a tensor: PyTorch turns division by a Python scalar into a
    # multiply by its reciprocal, which rounds differently from IEEE x / 127
    scales = torch.clamp(amax, min=1e-30) / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(delta / scales[:, None]), -127, 127).to(torch.int8)
    return codes, scales


def delta_decode_ref(codes: torch.Tensor, scales: torch.Tensor, prev: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    delta = codes.float() * scales[:, None]
    return (prev.float() + delta).to(dtype)
