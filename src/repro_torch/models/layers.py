"""Transformer building blocks (port of ``repro/models/layers.py``).

Activations are ``x (B, S, D)``; attention weights keep the reference's
layout (``wq (D, N, H)``, ``wo (N, H, D)``) so parameters load unchanged from
the JAX package. Attention is plain torch math, as the reference's ``_sdpa``
is plain einsum, with GQA by repeating the kv heads (the reference's default
path). Decode caches are ``(B, Smax, Nkv, H)`` linear or ring buffers. Under
``Tuning.decode_seq_constraint`` decode takes the reference's grouped
"flash-decode" einsum instead, which reads the cache without repeating it.
MLA (DeepSeek-V2 multi-head latent attention) caches the compressed
``(B, Smax, R)`` kv latent and the shared ``(B, Smax, P)`` rope key and
expands them with the up-projections at every call, as the reference does.
MoE is the reference's GShard one-hot einsum dispatch: deterministic, with
no scatter in its forward or backward; under ``Tuning.moe_impl="ep"`` and an
EP mesh it takes the index-based dispatch of ``parallel/ep_moe.py``. Cross-attention (the encdec
decoder's attention to the encoder output, the vlm's gated blocks over the
image embeddings) projects K and V from ``cross_src``, with no rope, no
mask and no cache: its K and V are projected again at every call, decode
steps included, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.spmd import (gather_grad_to_merge, gather_to_merge, gather_uneven, prefer,
                             shard_batch)
from .config import ModelConfig
from .params import PDesc
from .tuning import constrain_replicated_heads, constrain_seq_sharded, get_tuning

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


def attn_descs(cfg: ModelConfig, cross: bool = False) -> Dict[str, PDesc]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    descs = {
        "wq": PDesc((d, nq, hd), ("embed", "heads", None)),
        "wk": PDesc((d, nkv, hd), ("embed", "kv_heads", None)),
        "wv": PDesc((d, nkv, hd), ("embed", "kv_heads", None)),
        "wo": PDesc((nq, hd, d), ("heads", None, "embed")),
    }
    if cross:
        descs["gate"] = PDesc((1,), (None,), init="zeros")  # tanh-gated (vlm)
    return descs


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
    cross_src: Optional[torch.Tensor] = None,  # (B, Ssrc, D): encoder output or image
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Attention over ``positions``; returns ``(out, new_cache)``.

    Self-attention (``cross_src`` None) is causal unless ``causal=False``
    (the encoder), within ``window`` if given. With a cache, this step's
    k/v are written into ``cache`` in place at ``cache_index`` (modulo Smax
    for a ring) and the same dict is returned: the cache passed in is
    consumed, where the reference returns a new one from
    ``dynamic_update_slice``. An index the write does not fit raises, where
    ``dynamic_update_slice`` would clamp it.

    Cross-attention (``cross_src`` given): every query attends to every
    source position; K and V are projected from ``cross_src``, neither q
    nor k is rotated, any cache is ignored and the returned cache is None."""
    B, S, D = x.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    groups = nq // nkv
    cross = cross_src is not None
    flash_decode = cache is not None and not cross and get_tuning().decode_seq_constraint

    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    kv_in = cross_src if cross else x
    # under spmd the kv heads follow q's (GSPMD propagates them back
    # through the repeat); a plain tensor is passed as it is
    k = torch.einsum("bsd,dnh->bsnh", kv_in, prefer(p["wk"], 1, p["wq"], 1))
    v = torch.einsum("bsd,dnh->bsnh", kv_in, prefer(p["wv"], 1, p["wq"], 1))
    # under spmd attention runs on the batch's shards (GSPMD scatters the
    # FSDP products there); plain tensors as they are
    q, k, v = shard_batch(q), shard_batch(k), shard_batch(v)
    if not cross:
        pos = positions[:, None, :]
        q = rope(q.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
        k = rope(k.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)

    if cross:
        mask, cache = None, None  # full attention over the source tokens
    elif cache is not None:
        smax = cache["k"].shape[1]
        idx = cache_index % smax if ring else cache_index
        _write_cache(cache, idx, k=k, v=v)
        k, v = cache["k"], cache["v"]
        if flash_decode:
            # the reference's flash-decode sharding (DTensors only): K/V stay
            # sequence-sharded, q replicated over "model"
            k, v = constrain_seq_sharded(k, 1), constrain_seq_sharded(v, 1)
            q = constrain_replicated_heads(q)
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
        k, v = gather_uneven(k, 2), gather_uneven(v, 2)
        T = k.shape[1]
        k = k[:, :, :, None].expand(B, T, nkv, groups, hd).reshape(B, T, nq, hd)
        v = v[:, :, :, None].expand(B, T, nkv, groups, hd).reshape(B, T, nq, hd)
    out = _sdpa(q, k, v, mask, cfg.logit_softcap)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"]), cache


def _write_cache(cache: Dict[str, torch.Tensor], idx: int, **new: torch.Tensor) -> None:
    """Write this step's entries into each (B, Smax, ...) cache leaf at
    ``idx``, in place; an index the write does not fit raises."""
    for name, t in new.items():
        smax, S = cache[name].shape[1], t.shape[1]
        if not 0 <= idx <= smax - S:
            raise ValueError(f"cache index {idx} does not fit {S} token(s) in a "
                             f"cache of {smax}")
        cache[name][:, idx: idx + S] = t


def mla_descs(cfg: ModelConfig) -> Dict[str, PDesc]:
    m, d, nq = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    descs: Dict[str, PDesc] = {}
    if m.q_lora_rank:
        descs["w_dq"] = PDesc((d, m.q_lora_rank), ("embed", None))
        descs["w_uq"] = PDesc((m.q_lora_rank, nq, qk), (None, "heads", None))
    else:
        descs["w_q"] = PDesc((d, nq, qk), ("embed", "heads", None))
    descs["w_dkv"] = PDesc((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None))
    descs["w_uk"] = PDesc((m.kv_lora_rank, nq, m.qk_nope_head_dim), (None, "heads", None))
    descs["w_uv"] = PDesc((m.kv_lora_rank, nq, m.v_head_dim), (None, "heads", None))
    descs["wo"] = PDesc((nq, m.v_head_dim, d), ("heads", None, "embed"))
    return descs


def mla_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, S, D)
    cfg: ModelConfig,
    positions: torch.Tensor,             # (B, S)
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"ckv": (B,Smax,R), "kpe": (B,Smax,P)}
    cache_index: Optional[int] = None,   # write offset, a host int
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Causal MLA over ``positions``; returns ``(out, cache)``, the cache
    written in place at ``cache_index`` as ``attention`` writes its own."""
    m = cfg.mla
    nope = m.qk_nope_head_dim
    if m.q_lora_rank:
        q = torch.einsum("bsd,dr->bsr", x, p["w_dq"])
        q = torch.einsum("bsr,rnh->bsnh", q, p["w_uq"])
    else:
        q = torch.einsum("bsd,dnh->bsnh", x, p["w_q"])
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = rope(q_pe.transpose(1, 2), positions[:, None, :], cfg.rope_theta).transpose(1, 2)

    dkv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])
    ckv, k_pe = dkv[..., : m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    k_pe = rope(k_pe, positions, cfg.rope_theta)  # (B,S,P): shared across heads

    if cache is not None:
        _write_cache(cache, cache_index, ckv=ckv, kpe=k_pe)
        ckv, k_pe = cache["ckv"], cache["kpe"]
        valid = torch.arange(ckv.shape[1], dtype=torch.int32, device=x.device) <= cache_index
        mask = valid[None, None, None, :]
    else:
        mask = positions[:, None, None, :] <= positions[:, None, :, None]  # (B,1,S,T)

    # expand the compressed cache: k_nope (B,T,N,Hn), v (B,T,N,Hv)
    k_nope = torch.einsum("btr,rnh->btnh", ckv, p["w_uk"])
    val = torch.einsum("btr,rnh->btnh", ckv, p["w_uv"])

    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    logits = (torch.einsum("bsnh,btnh->bnst", q_nope, k_nope)
              + torch.einsum("bsnh,bth->bnst", q_pe, k_pe)).to(_at_least_f32(x.dtype)) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bnst,btnh->bsnh", probs, val)
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


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: all zeros where ``idx`` lies outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_descs(cfg: ModelConfig) -> Dict[str, PDesc]:
    mo, d = cfg.moe, cfg.d_model
    descs = {
        "router": PDesc((d, mo.num_experts), ("embed", None), init="small"),
        "w_gate": PDesc((mo.num_experts, d, mo.d_expert), ("experts", "embed", "expert_ffn")),
        "w_up": PDesc((mo.num_experts, d, mo.d_expert), ("experts", "embed", "expert_ffn")),
        "w_down": PDesc((mo.num_experts, mo.d_expert, d), ("experts", "expert_ffn", "embed")),
    }
    if mo.num_shared:
        descs["shared"] = mlp_descs(cfg, d_ff=mo.num_shared * mo.d_expert)
    return descs


def route(probs: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the experts: (gates, ids), each (..., top_k),
    the largest probabilities first and the lower expert id first among
    equal ones (a stable sort; ``torch.topk`` orders ties as it likes). The
    ids carry no gradient; the gates are ``probs`` contracted with the ids'
    one-hot, the same values, whose backward is a product rather than the
    scatter that ``topk``'s or ``gather``'s would be on the card."""
    ids = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[..., :top_k]
    gates = torch.einsum("...e,...ke->...k", probs, _one_hot(ids, probs.shape[-1], probs.dtype))
    return gates, ids


def moe(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
        group_size: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> (out, aux_loss). Token groups of ``group_size`` bound the
    dispatch tensor to (G, Tg, E, C) (GShard section 3.2); each (token,
    slot) takes its place in its expert in (t, k) order and is dropped past
    the capacity C. Under ``Tuning.moe_impl="ep"`` and an EP mesh the routed
    part goes through ``parallel/ep_moe.py`` instead (see ``tuning.py``)."""
    mo = cfg.moe
    if get_tuning().moe_impl == "ep":
        from ..parallel.ep_moe import ep_moe, get_ep_mesh

        if get_ep_mesh() is not None:
            out, aux = ep_moe({k: p[k] for k in ("router", "w_gate", "w_up", "w_down")}, x, cfg)
            if mo.num_shared:
                out = out + mlp(p["shared"], x, cfg.activation)
            return out, aux

    E, k = mo.num_experts, mo.top_k
    B, S, D = x.shape
    T = B * S
    tg = min(group_size, T)
    G = T // tg
    xf = gather_to_merge(x, 0, 2).reshape(G, tg, D)  # a plain tensor as it is

    logits = torch.einsum("gtd,de->gte", xf, p["router"]).to(_at_least_f32(x.dtype))
    probs = torch.softmax(logits, dim=-1)
    gate_w, ids = route(probs, k)                                    # (G,tg,k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): mean prob vs mean assignment per expert
    onehot = _one_hot(ids, E, probs.dtype)                           # (G,tg,k,E)
    me = probs.mean(dim=(0, 1))
    ce = onehot.sum(2).mean(dim=(0, 1)) / k
    aux = E * torch.sum(me * ce) * mo.router_aux_weight

    capacity = int(np.ceil(tg * k / E * mo.capacity_factor))
    # position of each (token, slot) within its expert, in (t, k) priority
    # order: the exclusive cumsum, in integers (exact, as the reference's f32)
    flat = _one_hot(ids, E, torch.int64).reshape(G, tg * k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, tg, k, E)
    pos_sel = torch.gather(pos, -1, ids[..., None])[..., 0]         # (G,tg,k), no gradient
    keep = (pos_sel < capacity).to(x.dtype)
    # under spmd the dispatch is sharded over the experts as the expert
    # weights are (GSPMD propagates it back); a plain tensor as it is
    oh_e = prefer(_one_hot(ids, E, x.dtype) * keep[..., None], 3, p["w_gate"], 0)
    oh_c = _one_hot(pos_sel, capacity, x.dtype)                      # (G,tg,k,C); overflow: 0
    # contract k: never materialises the 5-D (t, k, E, C) tensor
    dispatch = torch.einsum("gtke,gtkc->gtec", oh_e, oh_c)
    combine = torch.einsum("gtk,gtke,gtkc->gtec", gate_w.to(x.dtype), oh_e, oh_c)

    # the shared experts first: the combine below is then the block's last
    # product, which a remat recompute stops before (XLA drops it too)
    shared = mlp(p["shared"], x, cfg.activation) if mo.num_shared else None
    xin = torch.einsum("gtec,gtd->gecd", dispatch, xf)              # (G,E,C,D)
    gate = torch.einsum("gecd,edf->gecf", xin, p["w_gate"])
    gate = F.gelu(gate, approximate="tanh") if cfg.activation == "gelu" else F.silu(gate)
    h = gate * torch.einsum("gecd,edf->gecf", xin, p["w_up"])
    xout = torch.einsum("gecf,efd->gecd", h, p["w_down"])          # (G,E,C,D)
    out = gather_grad_to_merge(torch.einsum("gtec,gecd->gtd", combine, xout).reshape(B, S, D),
                               0, 2)
    return (out if shared is None else out + shared), aux
