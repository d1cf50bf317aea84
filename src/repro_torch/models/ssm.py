"""Mamba-2 mixer via state-space duality (SSD), chunked torch form (port of
``repro/models/ssm.py``).

Train/prefill use the chunked SSD algorithm (arXiv:2405.21060 §6): the
sequence is split into chunks; intra-chunk terms are dense products (the part
the CUDA kernel ``kernels/ssd.py`` computes, reached through ``ssd_impl``),
inter-chunk terms are a first-order recurrence over chunk states, here a
Python loop where the reference uses ``lax.scan``. Decode keeps O(1) state
per layer: a conv ring and the (H, P, N) SSM state. ``jnp.repeat`` over the
group axis is ``torch.repeat_interleave``: head ``h`` reads group
``h // (H/G)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.spmd import (channelwise, chunk_blocks, gather_dims, gather_to_split,
                             is_sharded, prefer)
from .config import ModelConfig
from .params import PDesc

F32 = torch.float32


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The reference takes the decays, states and norms in f32; a float64
    model keeps float64 there (as ``layers.rms_norm`` and ``layers._sdpa``)."""
    return torch.promote_types(dtype, F32)


def ssm_descs(cfg: ModelConfig) -> Dict[str, PDesc]:
    s, d = cfg.ssm, cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gn = s.n_groups * s.d_state
    conv_ch = di + 2 * gn
    return {
        "w_z": PDesc((d, di), ("embed", "ffn")),
        "w_x": PDesc((d, di), ("embed", "ffn")),
        "w_B": PDesc((d, gn), ("embed", None)),
        "w_C": PDesc((d, gn), ("embed", None)),
        "w_dt": PDesc((d, nh), ("embed", None)),
        "conv_w": PDesc((s.d_conv, conv_ch), (None, "ffn")),
        "conv_b": PDesc((conv_ch,), ("ffn",), init="zeros"),
        "A_log": PDesc((nh,), (None,), init="zeros"),
        "D": PDesc((nh,), (None,), init="ones"),
        "dt_bias": PDesc((nh,), (None,), init="zeros"),
        "norm_w": PDesc((di,), ("ffn",), init="zeros"),
        "out_proj": PDesc((di, d), ("ffn", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,C), w (K,C); the K taps are added in the
    reference's order."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i: i + x.shape[1], :] * w[i]
    return out + b


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise decay logits within a chunk.
    dA: (..., L) -> (..., L, L) with out[i, j] = sum_{j < t <= i} dA[t]."""
    L = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(L, device=dA.device)[:, None]
    j = torch.arange(L, device=dA.device)[None, :]
    return torch.where(j <= i, diff, torch.full_like(diff, float("-inf")))


def _recurrence(Bx: torch.Tensor, chunk_decay: torch.Tensor,
                state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk states seen by each chunk's queries (B,nc,H,P,N) from the
    chunks' own Bx (B,nc,H,P,N), their decays (B,nc,H) and the state
    before the first chunk (B,H,P,N); and the state after the last."""
    prev = []
    for c in range(Bx.shape[1]):
        prev.append(state)  # the state seen by this chunk's queries
        state = state * chunk_decay[:, c, :, None, None] + Bx[:, c]
    return torch.stack(prev, dim=1), state


def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)  (post-softplus)
    A: torch.Tensor,      # (H,)       (negative)
    Bm: torch.Tensor,     # (B, S, G, N)
    Cm: torch.Tensor,     # (B, S, G, N)
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    final_state: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N)). With ``final_state``
    False and one chunk, no chunk state is formed (y never reads it) and
    the state returned is None, as XLA drops the dead state of the
    reference's prefill and train steps."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    W = _wide(x.dtype)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    nc = S // chunk

    # under spmd a sequence sharded across chunk boundaries moves its shard
    # to the heads (x, dt) and the state (B, C)
    x, dt = gather_to_split(x, 1, chunk, to=2), gather_to_split(dt, 1, chunk, to=2)
    Bm, Cm = gather_to_split(Bm, 1, chunk, to=3), gather_to_split(Cm, 1, chunk, to=3)
    xr = x.reshape(Bsz, nc, chunk, H, P)
    dtr = dt.reshape(Bsz, nc, chunk, H)
    Br = Bm.reshape(Bsz, nc, chunk, G, N)
    Cr = Cm.reshape(Bsz, nc, chunk, G, N)
    dA = dtr * A  # (B,nc,L,H)

    # intra-chunk (dense; the CUDA kernel computes exactly this term)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))          # (B,nc,H,L,L)
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cr, Br)             # (B,nc,G,L,L)
    CB = torch.repeat_interleave(CB, rep, dim=2)                # (B,nc,H,L,L)
    gate = (CB * Lmat).to(x.dtype)
    y_diag = torch.einsum("bchls,bcsh,bcshp->bclhp", gate, dtr.to(x.dtype), xr)

    dA_cum = torch.cumsum(dA, dim=2)                            # (B,nc,L,H)
    state = (torch.zeros((Bsz, H, P, N), dtype=W, device=x.device)
             if initial_state is None else initial_state.to(W))
    if nc == 1 and not final_state:
        prev_states, state = state[:, None], None
    else:
        # chunk states: decay-to-chunk-end weighted outer products
        decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (B,nc,L,H)
        Bh = torch.repeat_interleave(Br, rep, dim=3)            # (B,nc,L,H,N)
        Bx = torch.einsum(
            "bclhn,bclh,bclhp->bchpn",
            Bh.to(W),
            (dtr * decay_to_end).to(W),
            xr.to(W),
        )  # (B,nc,H,P,N)

        # inter-chunk recurrence over chunk states (under spmd on each
        # device's block, the chunks gathered once)
        chunk_decay = torch.exp(torch.sum(dA, dim=2))           # (B,nc,H)
        prev_states, state = chunk_blocks(_recurrence, Bx, chunk_decay, state)

    # inter-chunk contribution: y += C_t · decayed prev chunk state
    in_decay = torch.exp(dA_cum)                                # (B,nc,L,H)
    Ch = torch.repeat_interleave(Cr, rep, dim=3)                # (B,nc,L,H,N)
    y_inter = torch.einsum("bclhn,bchpn->bclhp", Ch.to(W), prev_states)
    y_inter = y_inter * in_decay[..., None]

    y = (y_diag.to(W) + y_inter).reshape(Bsz, S, H, P)
    return y.to(x.dtype), state


def ssd_decode_step(
    x: torch.Tensor,      # (B, 1, H, P)
    dt: torch.Tensor,     # (B, 1, H)
    A: torch.Tensor,      # (H,)
    Bm: torch.Tensor,     # (B, 1, G, N)
    Cm: torch.Tensor,     # (B, 1, G, N)
    state: torch.Tensor,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    H = x.shape[2]
    G = Bm.shape[2]
    rep = H // G
    W = _wide(x.dtype)
    dA = torch.exp(dt[:, 0, :] * A)                             # (B,H)
    Bh = torch.repeat_interleave(Bm[:, 0], rep, dim=1)          # (B,H,N)
    Ch = torch.repeat_interleave(Cm[:, 0], rep, dim=1)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt[:, 0].to(W), x[:, 0].to(W), Bh.to(W))
    new_state = state.to(W) * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch.to(W))
    return y[:, None].to(x.dtype), new_state.to(state.dtype)


def mamba2_mixer(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,              # (B, S, D)
    cfg: ModelConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"conv": (B,K-1,C), "state": (B,H,P,N)}
    ssd_impl=None,                # optional kernel override (kernels/ops.py)
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    s = cfg.ssm
    B, S, D = x.shape
    di = s.d_inner(D)
    nh = s.n_heads(D)
    gn = s.n_groups * s.d_state
    W = _wide(x.dtype)

    z = torch.einsum("bsd,di->bsi", x, p["w_z"])
    xs = torch.einsum("bsd,di->bsi", x, p["w_x"])
    # under spmd B, C and dt are computed sharded as the heads are (GSPMD
    # propagates the heads' sharding back into them); plain tensors as they are
    Bm = torch.einsum("bsd,dg->bsg", x, prefer(p["w_B"], 1, p["w_x"], 1))
    Cm = torch.einsum("bsd,dg->bsg", x, prefer(p["w_C"], 1, p["w_x"], 1))
    dt = F.softplus(
        torch.einsum("bsd,dh->bsh", x, prefer(p["w_dt"], 1, p["w_x"], 1)).to(W)
        + p["dt_bias"].to(W)
    )
    A = -torch.exp(p["A_log"].to(W))

    new_cache = None
    parts = ((0, di), (di, di + gn), (di + gn, di + 2 * gn))      # xs, B, C channels
    if cache is None and is_sharded(xs):
        # the depthwise conv of each part on its own, the same numbers as
        # the conv of their concatenation: a sharded xs stays sharded
        # (DTensor would gather the concatenation of differently sharded
        # parts), and so do the heads of the scan. Each part runs on its
        # devices' blocks, gathered over the sequence (GSPMD exchanges
        # halos), with the weights gathered once
        w, bias = gather_dims(p["conv_w"]), gather_dims(p["conv_b"])
        xs, Bm, Cm = (F.silu(channelwise(_causal_conv, t, w[:, a:b], bias[a:b]))
                      for t, (a, b) in zip((xs, Bm, Cm), parts))
    else:
        xbc = torch.cat([xs, Bm, Cm], dim=-1)                   # (B,S,C)
        if cache is None:
            xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
        else:
            k = s.d_conv
            window = torch.cat([cache["conv"], xbc], dim=1)     # (B,K-1+S,C)
            conv_out = torch.einsum("bkc,kc->bc", window[:, -k:], p["conv_w"]) + p["conv_b"]
            xbc = F.silu(conv_out)[:, None]                     # (B,1,C)
            new_conv = window[:, -(k - 1):]
        xs, Bm, Cm = (xbc[..., a:b] for a, b in parts)
    xs = xs.reshape(B, S, nh, s.head_dim)
    Bm = Bm.reshape(B, S, s.n_groups, s.d_state)
    Cm = Cm.reshape(B, S, s.n_groups, s.d_state)

    if cache is None:
        args = (xs, dt.to(x.dtype), A.to(W), Bm, Cm, s.chunk_size)
        # the final state is not used here
        y = ssd_impl(*args)[0] if ssd_impl else ssd_chunked(*args, final_state=False)[0]
    else:
        y, new_state = ssd_decode_step(xs, dt.to(W), A, Bm, Cm, cache["state"])
        new_cache = {"conv": new_conv, "state": new_state}

    y = y + xs * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    # gated RMSNorm then down-projection (Mamba-2 block epilogue)
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.to(W)), dim=-1, keepdim=True)
    y = (y.to(W) * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype) * (
        1.0 + p["norm_w"].to(x.dtype)
    )
    return torch.einsum("bsi,id->bsd", y, p["out_proj"]), new_cache
