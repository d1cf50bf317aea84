"""Plain PyTorch reference of the training step the benchmark times.

A frozen copy of the arithmetic of the port's step (the SSM and hybrid
families' forward, the next-token loss with a family's auxiliary loss,
autograd and AdamW), written out again with nothing but ``torch``: it
imports nothing of the system under test, and nothing of JAX. The
benchmark hands it the same initial weights and token batches as the
program and holds the program's readings to its own
(``cardbench/check.py``). It runs in float32 with TF32 off unless a caller
asks for TF32 (the control, ``cardbench/calibrate.py``).

A model is described by the ``model`` object of a configuration file
(``cardbench/configs/<name>.json``): the family, widths and depth. The
family's module (``cardbench/reference/<family>.py``) gives its parameter
layout (``descs``) and its forward (``forward``: logits, or logits and an
auxiliary loss). The ``model`` object's step options (``Tuning``'s fields)
are the program's; the reference reads no such key.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32

#: a leaf: (shape, init, scale, stacked dims); init is normal | zeros | ones.
#: The stacked dims lead the shape (layers, or groups x layers in a group)
Desc = Tuple[Tuple[int, ...], str, float, int]


def vocab_padded(m: dict) -> int:
    """The vocabulary padded to a multiple of 2048, as the model's tables are."""
    return (m["vocab_size"] + 2047) // 2048 * 2048


def d_inner(m: dict) -> int:
    return m["ssm"]["expand"] * m["d_model"]


def n_heads_ssm(m: dict) -> int:
    return d_inner(m) // m["ssm"]["head_dim"]


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


# --------------------------------------------------------------------------- #
# parameter layout
# --------------------------------------------------------------------------- #
def _leaf(shape, init="normal", scale=1.0) -> Desc:
    return (tuple(shape), init, scale, 0)


def stacked(tree: dict, n: int) -> dict:
    return {k: stacked(v, n) if isinstance(v, dict) else
            ((n,) + v[0], v[1], v[2], v[3] + 1) for k, v in tree.items()}


def embed_descs(m: dict) -> dict:
    d, v = m["d_model"], vocab_padded(m)
    out = {"embed": _leaf((v, d)), "ln_f": _leaf((d,), "zeros")}
    if not m.get("tie_embeddings", False):
        out["lm_head"] = _leaf((d, v))
    return out


def ssm_block_descs(m: dict) -> dict:
    s, d = m["ssm"], m["d_model"]
    di, nh, gn = d_inner(m), n_heads_ssm(m), s["n_groups"] * s["d_state"]
    conv_ch = di + 2 * gn
    return {
        "ln1": _leaf((d,), "zeros"),
        "mixer": {
            "w_z": _leaf((d, di)), "w_x": _leaf((d, di)),
            "w_B": _leaf((d, gn)), "w_C": _leaf((d, gn)), "w_dt": _leaf((d, nh)),
            "conv_w": _leaf((s["d_conv"], conv_ch)), "conv_b": _leaf((conv_ch,), "zeros"),
            "A_log": _leaf((nh,), "zeros"), "D": _leaf((nh,), "ones"),
            "dt_bias": _leaf((nh,), "zeros"), "norm_w": _leaf((di,), "zeros"),
            "out_proj": _leaf((di, d)),
        },
    }


def attn_block_descs(m: dict) -> dict:
    d, hd = m["d_model"], head_dim(m)
    nq, nkv, f = m["num_heads"], m["num_kv_heads"], m["d_ff"]
    return {
        "ln1": _leaf((d,), "zeros"),
        "attn": {"wq": _leaf((d, nq, hd)), "wk": _leaf((d, nkv, hd)),
                 "wv": _leaf((d, nkv, hd)), "wo": _leaf((nq, hd, d))},
        "ln2": _leaf((d,), "zeros"),
        "mlp": {"wi_gate": _leaf((d, f)), "wi_up": _leaf((d, f)), "wo": _leaf((f, d))},
    }


def flatten(tree: dict, prefix: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) in sorted-key order, recursively: the order in which the
    weights are drawn and in which AdamW walks the leaves."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(flatten(v, f"{prefix}{k}."))
        else:
            out.append((f"{prefix}{k}", v))
    return out


def unflatten(paths: List[str], leaves: List) -> dict:
    tree: dict = {}
    for p, leaf in zip(paths, leaves):
        node = tree
        *head, last = p.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def leaf_std(desc: Desc) -> float:
    shape, init, scale, _ = desc
    if init != "normal":
        return 0.0
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return scale / math.sqrt(max(fan_in, 1))


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
def rms_norm(x, w, eps):
    xf = x.to(torch.promote_types(x.dtype, F32))
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w.to(x.dtype))


def rope(x, positions, theta):
    h = x.shape[-1]
    exponents = torch.arange(0, h, 2, dtype=F32, device=x.device) / h
    freqs = 1.0 / torch.pow(torch.full_like(exponents, theta), exponents)
    angles = positions[..., None].to(F32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : h // 2], x[..., h // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def attention(p, x, m, positions):
    """Causal self-attention over the whole sequence, kv heads repeated."""
    B, S, _ = x.shape
    nq, nkv, hd = m["num_heads"], m["num_kv_heads"], head_dim(m)
    groups = nq // nkv
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"])
    pos = positions[:, None, :]
    theta = m.get("rope_theta", 10000.0)
    q = rope(q.transpose(1, 2), pos, theta).transpose(1, 2)
    k = rope(k.transpose(1, 2), pos, theta).transpose(1, 2)
    mask = positions[:, None, None, :] <= positions[:, None, :, None]
    if groups > 1:
        T = k.shape[1]
        k = k[:, :, :, None].expand(B, T, nkv, groups, hd).reshape(B, T, nq, hd)
        v = v[:, :, :, None].expand(B, T, nkv, groups, hd).reshape(B, T, nq, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bsnh,btnh->bnst", q, k).to(torch.promote_types(q.dtype, F32)) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bnst,btnh->bsnh", probs, v)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"])


def mlp(p, x):
    gate = F.silu(torch.einsum("bsd,df->bsf", x, p["wi_gate"]))
    h = gate * torch.einsum("bsd,df->bsf", x, p["wi_up"])
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


def _causal_conv(x, w, b):
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i: i + x.shape[1], :] * w[i]
    return out + b


def _segsum(dA):
    L = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(L, device=dA.device)[:, None]
    j = torch.arange(L, device=dA.device)[None, :]
    return torch.where(j <= i, diff, torch.full_like(diff, float("-inf")))


def ssd(x, dt, A, Bm, Cm, chunk):
    """The chunked state-space-duality scan (arXiv:2405.21060 §6) from a zero
    state: x (B,S,H,P), dt (B,S,H), A (H,), Bm and Cm (B,S,G,N) -> y (B,S,H,P)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    W = torch.promote_types(x.dtype, F32)
    nc = S // chunk
    xr = x.reshape(Bsz, nc, chunk, H, P)
    dtr = dt.reshape(Bsz, nc, chunk, H)
    Br = Bm.reshape(Bsz, nc, chunk, G, N)
    Cr = Cm.reshape(Bsz, nc, chunk, G, N)
    dA = dtr * A

    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cr, Br)
    CB = torch.repeat_interleave(CB, rep, dim=2)
    gate = (CB * Lmat).to(x.dtype)
    y_diag = torch.einsum("bchls,bcsh,bcshp->bclhp", gate, dtr.to(x.dtype), xr)

    dA_cum = torch.cumsum(dA, dim=2)
    state = torch.zeros((Bsz, H, P, N), dtype=W, device=x.device)
    if nc == 1:
        prev_states = state[:, None]
    else:
        decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
        Bh = torch.repeat_interleave(Br, rep, dim=3)
        Bx = torch.einsum("bclhn,bclh,bclhp->bchpn", Bh.to(W), (dtr * decay_to_end).to(W),
                          xr.to(W))
        chunk_decay = torch.exp(torch.sum(dA, dim=2))
        prev = []
        for c in range(nc):
            prev.append(state)
            state = state * chunk_decay[:, c, :, None, None] + Bx[:, c]
        prev_states = torch.stack(prev, dim=1)

    in_decay = torch.exp(dA_cum)
    Ch = torch.repeat_interleave(Cr, rep, dim=3)
    y_inter = torch.einsum("bclhn,bchpn->bclhp", Ch.to(W), prev_states)
    y_inter = y_inter * in_decay[..., None]
    y = (y_diag.to(W) + y_inter).reshape(Bsz, S, H, P)
    return y.to(x.dtype)


def mamba2_mixer(p, x, m):
    s = m["ssm"]
    B, S, D = x.shape
    di, nh, gn = d_inner(m), n_heads_ssm(m), s["n_groups"] * s["d_state"]
    W = torch.promote_types(x.dtype, F32)
    z = torch.einsum("bsd,di->bsi", x, p["w_z"])
    xs = torch.einsum("bsd,di->bsi", x, p["w_x"])
    Bm = torch.einsum("bsd,dg->bsg", x, p["w_B"])
    Cm = torch.einsum("bsd,dg->bsg", x, p["w_C"])
    dt = F.softplus(torch.einsum("bsd,dh->bsh", x, p["w_dt"]).to(W) + p["dt_bias"].to(W))
    A = -torch.exp(p["A_log"].to(W))
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:di + 2 * gn]
    xs = xs.reshape(B, S, nh, s["head_dim"])
    Bm = Bm.reshape(B, S, s["n_groups"], s["d_state"])
    Cm = Cm.reshape(B, S, s["n_groups"], s["d_state"])
    y = ssd(xs, dt.to(x.dtype), A.to(W), Bm, Cm, s["chunk_size"])
    y = y + xs * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.to(W)), dim=-1, keepdim=True)
    y = (y.to(W) * torch.rsqrt(var + m["norm_eps"])).to(x.dtype) * (1.0 + p["norm_w"].to(x.dtype))
    return torch.einsum("bsi,id->bsd", y, p["out_proj"])


def ssm_block(lp, x, m):
    return x + mamba2_mixer(lp["mixer"], rms_norm(x, lp["ln1"], m["norm_eps"]), m)


def attn_block(lp, x, m, positions):
    x = x + attention(lp["attn"], rms_norm(x, lp["ln1"], m["norm_eps"]), m, positions)
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"], m["norm_eps"]))


def layer(tree, *idx):
    """The slice ``t[i][j]...`` of every leaf of a stacked tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = layer(v, *idx)
        else:
            for i in idx:
                v = v[i]
            out[k] = v
    return out


def n_stacked(tree) -> int:
    return next(iter(flatten(tree)))[1].shape[0]


def head(params, x, m):
    x = rms_norm(x, params["ln_f"], m["norm_eps"])
    if m.get("tie_embeddings", False):
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


def blockwise(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``), so that the reference holds one block's
    activations at a time: the same arithmetic, bit for bit, in the memory
    that the program's ``remat="full"`` takes at the cell's batch."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def positions_of(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)


def lm_loss(m, logits, labels):
    """Mean next-token cross-entropy in f32, padded vocabulary entries masked."""
    logits = logits.float()
    if vocab_padded(m) != m["vocab_size"]:
        pad = torch.arange(vocab_padded(m), device=logits.device) >= m["vocab_size"]
        logits = torch.where(pad[None, None, :], torch.full_like(logits, -1e30), logits)
    logz = torch.logsumexp(logits, dim=-1)
    B, S = labels.shape
    b_idx = torch.arange(B, device=labels.device)[:, None]
    s_idx = torch.arange(S, device=labels.device)[None, :]
    return torch.mean(logz - logits[b_idx, s_idx, labels.long()])


# --------------------------------------------------------------------------- #
# optimizer and step
# --------------------------------------------------------------------------- #
def adamw_init(leaves: List[torch.Tensor]) -> dict:
    zeros = [torch.zeros(p.shape, dtype=F32, device=p.device) for p in leaves]
    return {"m": zeros, "v": [z.clone() for z in zeros],
            "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}


@torch.no_grad()
def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor], state: dict, opt: dict):
    """Global-norm clip, bias-corrected f32 moments, decoupled weight decay
    on every leaf; leaves in sorted-path order. ``opt`` holds lr, b1, b2,
    eps, weight_decay and grad_clip (the traffic file's optimizer)."""
    c = opt
    step = state["step"] + 1
    gnorm_sq = torch.zeros((), dtype=F32, device=step.device)
    for g in grads:
        gnorm_sq = gnorm_sq + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(gnorm_sq)
    scale = torch.clamp(torch.full_like(gnorm, c["grad_clip"]) / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step_f = step.float()
    bc1 = 1 - torch.pow(torch.full_like(step_f, c["b1"]), step_f)
    bc2 = 1 - torch.pow(torch.full_like(step_f, c["b2"]), step_f)
    new_p, new_m, new_v = [], [], []
    for p, g, mm, vv in zip(params, grads, state["m"], state["v"]):
        g = g.float() * scale
        mm = c["b1"] * mm + (1 - c["b1"]) * g
        vv = c["b2"] * vv + (1 - c["b2"]) * torch.square(g)
        delta = (mm / bc1) / (torch.sqrt(vv / bc2) + c["eps"]) + c["weight_decay"] * p.float()
        new_p.append((p.float() - c["lr"] * delta).to(p.dtype))
        new_m.append(mm)
        new_v.append(vv)
    return new_p, {"m": new_m, "v": new_v, "step": step}


def train_step(forward, m: dict, paths: List[str], leaves: List[torch.Tensor], state: dict,
               tokens: torch.Tensor, opt: dict):
    """One step: forward, loss, gradients by autograd (zero where a leaf is
    not reached), AdamW. -> (new leaves, new state, loss as a 0-d tensor).
    A family's ``forward`` returns its logits, or ``(logits, aux)`` where
    the model adds an auxiliary loss (a router's load balance) to the
    next-token loss, as the program's ``lm_loss(cfg, out, labels, aux)``."""
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        out = forward(m, unflatten(paths, leaves), tokens[:, :-1])
        logits, aux = out if isinstance(out, tuple) else (out, None)
        loss = lm_loss(m, logits, tokens[:, 1:])
        if aux is not None:
            loss = loss + aux
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    new_p, new_state = adamw_update([p.detach() for p in leaves], grads, state, opt)
    return new_p, new_state, loss.detach()
