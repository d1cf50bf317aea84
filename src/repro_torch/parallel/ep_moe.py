"""Expert-parallel MoE dispatch over ``torch.distributed`` (port of
``repro/parallel/ep_moe.py``).

The GShard dispatch of ``models/layers.py::moe`` gathers and scatters every
token through dense one-hot (E, C) products. This is the index-based
alternative: each rank scatters its tokens into per-expert capacity buckets
(O(T·D), no one-hot products), sends each bucket to the rank that owns the
expert with an all-to-all over the mesh's "model" group, runs its experts,
and sends the results back. Reached through ``Tuning.moe_impl="ep"`` under
an ``ep_mesh(...)`` context; equal to the einsum dispatch when nothing
overflows capacity, and on a world of one (same capacity, same drop order).

The reference runs this as ``shard_map`` over a global array; the port runs
it as explicit SPMD. Every rank calls ``ep_moe`` with the full (E, D, F)
expert weights and the replicated router, and with ``x`` its data shard of
the batch, the same on every rank of its model group. Each rank pads E to
a multiple of the group size M and keeps its block of E_pad / M experts;
when S % M == 0 it routes its own S / M slice of the sequence (else the
whole sequence), and the output is gathered back to (B, S, D) on every
rank of the group. The aux loss is the mean over every rank of the mesh.

Gradients. Each collective is an autograd function whose backward is its
conjugate: the sequence slice gathers the gradient, the gather slices it,
the all-to-all's backward is the reverse all-to-all. The router, the expert
weights (and ``x`` when the sequence is not sliced) enter through an
identity whose backward all-reduces over the model group; an output that
every rank of the group computes whole (the unsliced sequence) divides its
gradient by M, and so does the aux mean. So after backward every
parameter's gradient, and ``x``'s, is complete and identical on every rank
of the model group, and a data axis needs only the caller's usual
reduction, the mean over the data ranks.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.config import ModelConfig
from ..models.layers import _at_least_f32, _one_hot, route

# ambient mesh (set by the caller around the forward)
_EP_MESH = None


class ep_mesh:
    def __init__(self, mesh) -> None:
        self.mesh = mesh

    def __enter__(self):
        global _EP_MESH
        self._prev = _EP_MESH
        _EP_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _EP_MESH
        _EP_MESH = self._prev


def get_ep_mesh():
    return _EP_MESH


# --------------------------------------------------------------------------- #
# collectives with their conjugate backward                                    #
# --------------------------------------------------------------------------- #
def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _own_chunk(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    return t.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)].contiguous()


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; all-reduce (sum) over the group backward: a tensor
    replicated over the group whose uses are split among its ranks."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale`` backward: a value that
    every rank of the group computes whole, and whose gradient each holds."""

    @staticmethod
    def forward(ctx, t, scale: float):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _SplitSeq(torch.autograd.Function):
    """The rank's chunk of ``dim`` forward; all-gather along it backward."""

    @staticmethod
    def forward(ctx, t, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _own_chunk(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` forward; the rank's chunk backward."""

    @staticmethod
    def forward(ctx, t, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with equal splits of dim 0: block j goes to
    rank j, and what rank j sent lands in block j. Its own inverse, so the
    backward is the same exchange."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _MeshMean(torch.autograd.Function):
    """The mean over every rank of the mesh forward; the gradient over the
    model group's size backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.m = mesh.size(mesh.mesh_dim_names.index("model"))
        t = t.clone()
        for name in mesh.mesh_dim_names:
            dist.all_reduce(t, group=mesh.get_group(name))
        return t / mesh.size()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.m, None


# --------------------------------------------------------------------------- #
def _local_moe(xf, router, w_gate, w_up, w_down, *, cfg: ModelConfig, group,
               e_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's part. xf: (T_loc, D); expert weights: (E_pad/M, D, F), the
    rank's block. e_pad >= num_experts is the padded expert count (a
    multiple of M); padded experts receive no tokens (the router never
    selects them)."""
    mo = cfg.moe
    T, D = xf.shape
    E, k = mo.num_experts, mo.top_k
    M = dist.get_world_size(group)

    logits = (xf @ router).to(_at_least_f32(xf.dtype))             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, ids = route(probs, k)                                   # (T, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=0)
    ce = _one_hot(ids, E, probs.dtype).sum(1).mean(dim=0) / k
    aux = E * torch.sum(me * ce) * mo.router_aux_weight

    cap = int(np.ceil(T * k / E * mo.capacity_factor))
    # slot within the chosen expert, in (t, k) priority: the count of
    # earlier (token, slot)s that chose it, in integers. Laid out (E, T*k)
    # so that the scan runs along the contiguous dim (along dim 0 of a
    # (T*k, E) tensor it runs E columns wide, 3 ms at granite's shape)
    ids_flat = ids.reshape(1, T * k)
    onehot = (torch.arange(E, device=ids.device)[:, None] == ids_flat).to(torch.int64)
    pos_sel = (torch.gather(torch.cumsum(onehot, dim=1), 0, ids_flat) - 1).reshape(T, k)
    keep = pos_sel < cap
    # a dropped (token, slot) goes to one trash row past the buckets, cut
    # off below; kept slots are unique, so the scatter needs no accumulation
    slot = torch.where(keep, ids * cap + pos_sel, e_pad * cap)
    src = xf.unsqueeze(1).expand(T, k, D).reshape(T * k, D)
    buf = xf.new_zeros((e_pad * cap + 1, D)).index_put((slot.reshape(-1),), src)
    buf = buf[: e_pad * cap].reshape(e_pad, cap, D)

    # ship each expert's bucket to its owner and receive M buckets for each
    # local expert. all_to_all_single stacks what it receives by source
    # rank, (M, E/M, C, D); the reference's tiled all_to_all(split_axis=0,
    # concat_axis=1) gives (E/M, M*C, D), source rank major along dim 1
    e_loc = e_pad // M
    recv = _AllToAll.apply(buf, group).reshape(M, e_loc, cap, D)
    recv = recv.transpose(0, 1).reshape(e_loc, M * cap, D)

    gate = torch.einsum("ecd,edf->ecf", recv, w_gate)
    gate = F.gelu(gate, approximate="tanh") if cfg.activation == "gelu" else F.silu(gate)
    h = gate * torch.einsum("ecd,edf->ecf", recv, w_up)
    out = torch.einsum("ecf,efd->ecd", h, w_down)                  # (E/M, M*C, D)

    # the way back mirrors it: (E/M, M, C, D) -> (M, E/M, C, D) by source
    # rank, exchanged, arrives as (E_pad, C, D) in this rank's own slots
    out = out.reshape(e_loc, M, cap, D).transpose(0, 1)
    out = _AllToAll.apply(out, group).reshape(e_pad * cap, D)
    y_tk = out[torch.where(keep, slot, 0)]                          # (T, k, D)
    y_tk = y_tk * (keep[..., None] * gate_w[..., None]).to(xf.dtype)
    return y_tk.sum(dim=1), aux


def ep_moe(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig):
    """Drop-in for ``layers.moe``'s routed part under an ``ep_mesh`` context.
    ``p`` holds the full router (D, E) and expert weights (E, D, F) / (E, F,
    D); ``x`` (B, S, D) is this rank's data shard, the same on every rank of
    its model group. Returns (y (B, S, D), aux), both the same on every rank
    of the model group."""
    mesh = get_ep_mesh()
    if mesh is None:
        raise RuntimeError("ep_moe requires an ep_mesh(...) context")
    group = mesh.get_group("model")
    M, r = dist.get_world_size(group), dist.get_rank(group)
    S, D = x.shape[1:]
    E = cfg.moe.num_experts
    e_pad = -(-E // M) * M
    e_loc = e_pad // M

    def block(w):
        w = _CopyToGroup.apply(w, group)
        if e_pad != E:
            w = F.pad(w, (0, 0, 0, 0, 0, e_pad - E))
        return w[r * e_loc:(r + 1) * e_loc]

    wg, wu, wd = (block(p[n]) for n in ("w_gate", "w_up", "w_down"))
    router = _CopyToGroup.apply(p["router"], group)
    seq_sliced = S % M == 0
    xb = _SplitSeq.apply(x, group, 1) if seq_sliced else _CopyToGroup.apply(x, group)
    y, aux = _local_moe(xb.reshape(-1, D), router, wg, wu, wd, cfg=cfg, group=group,
                        e_pad=e_pad)
    y = y.reshape(xb.shape)
    y = _GatherSeq.apply(y, group, 1) if seq_sliced else _ScaleGrad.apply(y, 1.0 / M)
    return y, _MeshMean.apply(aux, mesh)
