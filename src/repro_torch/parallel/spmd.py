"""What GSPMD does implicitly, for the port's model code on DTensors.

The reference partitions its steps with GSPMD: it gives the inputs their
shardings and XLA inserts every collective the program needs. The port
gives its inputs DTensor placements (``sharding.tree_shardings``) and runs
the same model code on them under ``spmd(mesh)``. DTensor propagates
shardings operator by operator and refuses what it has no rule for; this
module fills those gaps, in one place:

  * ``implicit_replication``: tensors made inside the forward (positions,
    masks, the optimizer's scalars) act as replicated DTensors;
  * a contraction's partial sum is reduced at once, as GSPMD reduces it:
    DTensor would keep it ``Partial`` and reduce it again at each of its
    non-linear consumers;
  * ``torch.einsum`` on DTensor operands. ``torch.einsum`` flattens a batch
    letter sharded over one mesh dim together with a head letter sharded
    over another into one strided dim, for which DTensor's ``bmm`` has no
    rule. Here, per mesh dim, a letter sharded alike in every operand that
    has it stays sharded (``Partial`` when it is contracted); conflicting or
    one-sided shardings redistribute the operands that make it cheapest
    (a replicated operand is sliced for free, a sharded one is gathered);
    then each device runs the einsum on its local blocks. Two differently
    sharded letters are never flattened into one dim. Where no operand is
    sharded over a mesh dim, a letter the model marks (``prefer``: GSPMD's
    backward propagation, such as the kv heads that follow q's) is sharded
    there, unevenly where the dim does not divide;
  * ``torch.cumsum`` runs on each device's block, its dim gathered;
  * ``torch.logsumexp`` and ``torch.softmax`` over a sharded dim reduce a
    local maximum and a local sum, where DTensor gathers the operand whole
    (the loss over vocab-sharded logits, attention over a sequence-sharded
    decode cache);
  * advanced indexing of a sharded dim (the embedding gather from a
    vocab-sharded table, the loss's label logits): each device gathers the
    entries it holds and the partial results are summed, scattered as the
    indices were sharded (a sequence-sharded embedding stays so, as in
    GSPMD's plan); a table's embed dim sharded over the mesh dim that
    shards the indices (FSDP) stays sharded, and the indices are gathered;
  * the views DTensor cannot take on a sharded dim (``gather_uneven``,
    ``gather_to_split``, ``gather_to_merge``, ``gather_grad_to_merge``):
    the model gathers that dim first, as GSPMD does there;
  * slice assignment into a sharded dim (the decode cache write into a
    sequence-sharded cache): each device writes its part in place, where
    DTensor would write into a gathered copy and lose the write.

The gradients of the local einsum are returned with explicit placements: an
operand replicated over a mesh dim on which another operand's letter is
sharded gets a ``Partial`` gradient there, since each device holds only its
block's contribution.
"""
from __future__ import annotations

import contextlib
import math
import string
from typing import List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication


def _expand(equation: str, ndims: Sequence[int]) -> Tuple[List[str], str]:
    """An explicit einsum equation -> (operand subscripts, output subscript),
    with any ellipsis spelt out in letters the equation does not use."""
    eq = equation.replace(" ", "")
    if "->" not in eq:
        raise ValueError(f"einsum {equation!r}: an explicit output ('->') is required")
    lhs, out = eq.split("->")
    ins = lhs.split(",")
    if len(ins) != len(ndims):
        raise ValueError(f"einsum {equation!r} names {len(ins)} operands, got {len(ndims)}")
    spare = [c for c in string.ascii_letters if c not in eq]
    n_ell = max([nd - (len(s) - 3) for s, nd in zip(ins, ndims) if "..." in s] or [0])
    ell = "".join(spare[:n_ell])
    subs = [s.replace("...", ell[n_ell - (nd - (len(s) - 3)):]) if "..." in s else s
            for s, nd in zip(ins, ndims)]
    return subs, out.replace("...", ell)


def _plain(p) -> bool:
    return type(p) in (Shard, Replicate)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _plan(subs: List[str], out: str, operands: List[DTensor], mesh):
    """Per mesh dim, the letter to keep sharded (or None): the choice that
    moves the fewest bytes. Returns (target placements per operand, output
    placements, gradient placements per operand)."""
    targets = [[None] * mesh.ndim for _ in operands]
    grads = [[None] * mesh.ndim for _ in operands]
    out_pl = []
    out_bytes = 1
    for L in out:
        out_bytes *= max(t.shape[s.index(L)] for s, t in zip(subs, operands) if L in s)
    out_bytes *= operands[0].element_size()
    for m in range(mesh.ndim):
        n = mesh.size(m)
        cur = [t.placements[m] for t in operands]
        letters = []
        for s, p in zip(subs, cur):
            if isinstance(p, Shard) and s[p.dim] not in letters:
                letters.append(s[p.dim])

        def cost(L):
            c = 0.0
            for s, p, t in zip(subs, cur, operands):
                want = Shard(s.index(L)) if L is not None and L in s else Replicate()
                if p == want or (isinstance(p, Replicate) and isinstance(want, Shard)):
                    continue
                c += _bytes(t) * (n - 1) / n / (n if isinstance(want, Shard) else 1)
            if L is not None and L not in out:  # a Partial output is reduced later
                c += 2 * out_bytes * (n - 1) / n
            return c

        if not letters:  # GSPMD's backward propagation, where the model marks it
            letters = [s[t._spmd_prefer[m]] for s, t in zip(subs, operands)
                       if m in getattr(t, "_spmd_prefer", {})]
        best: Optional[str] = min(letters, key=cost) if letters else None
        for i, s in enumerate(subs):
            if best is not None and best in s:
                targets[i][m] = grads[i][m] = Shard(s.index(best))
            else:
                targets[i][m] = Replicate()
                grads[i][m] = Partial() if best is not None else Replicate()
        out_pl.append(Replicate() if best is None else
                      Shard(out.index(best)) if best in out else Partial())
    return targets, out_pl, grads


def prefer(t, dim: int, like, like_dim: int):
    """GSPMD propagates a sharding backward too: a replicated weight whose
    product feeds an operator sharded over a mesh dim gets its product
    computed sharded there. The port's planner looks only at the operands
    of one einsum; the model marks the few places where the backward
    propagation decides the plan. ``t`` replicated over a mesh dim on which
    ``like`` shards its dim ``like_dim`` is returned as an alias marked to
    shard its dim ``dim`` there, which ``sharded_einsum`` takes (a free
    slice, uneven where the dim does not divide) for a mesh dim on which no
    operand is sharded. GSPMD shards a dim only where its size and the mesh
    dim's have a common factor; so does the mark. Anything else, a plain
    tensor included, is returned as it is."""
    if not (isinstance(t, DTensor) and isinstance(like, DTensor)):
        return t
    dim %= t.ndim
    marks = {m: dim for m, (p, q) in enumerate(zip(t.placements, like.placements))
             if p.is_replicate() and isinstance(q, Shard) and q.dim == like_dim % like.ndim
             and math.gcd(t.shape[dim], t.device_mesh.size(m)) > 1}
    if not marks:
        return t
    alias = t.view(t.shape)
    alias._spmd_prefer = marks
    return alias


def shard_batch(t):
    """``t`` with its dim 0 (the batch) sharded over the mesh's batch axes
    ("pod", "data") where it is replicated there and divides (a free
    slice). GSPMD scatters the FSDP-contracted attention inputs so: their
    embed dim's partial sum over "data" lands sharded over the batch, where
    the port's einsum reduces it whole. Anything else is returned as it
    is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    pl = list(t.placements)
    for m, p in enumerate(pl):
        if names[m] not in ("pod", "data") or not p.is_replicate() or mesh.size(m) == 1:
            continue
        # DTensor splits a dim over its mesh dims in their order
        if any(isinstance(q, Shard) and q.dim == 0 for q in pl[m + 1:]):
            return t
        ways = math.prod(mesh.size(k) for k, q in enumerate(pl[:m])
                         if isinstance(q, Shard) and q.dim == 0) * mesh.size(m)
        if t.shape[0] % ways:
            return t
        pl[m] = Shard(0)
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor sharded over some mesh dim."""
    return isinstance(t, DTensor) and any(isinstance(p, Shard) for p in t.placements)


def gather_dims(t, dims=None):
    """``t`` gathered over the mesh dims that shard one of ``dims`` (all its
    dims when None). Anything else is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    dims = None if dims is None else {d % t.ndim for d in dims}
    pl = [Replicate() if isinstance(p, Shard) and (dims is None or p.dim in dims) else p
          for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh, pl)


def channelwise(fn, x, w, b):
    """``fn(x, w, b)`` for an ``fn`` that treats each (row, channel) of ``x``
    (B, S, C) on its own over the whole of S, with ``w`` (K, C) and ``b``
    (C,) (the depthwise causal conv): on each device's block of ``x``,
    gathered over S, with its channels' block of ``w`` and ``b`` gathered
    whole; the result is laid out as ``x`` was. DTensor's own padding of a
    tensor sharded on two dims fails in some torch versions. The gradients
    of ``w`` and ``b`` are partial sums over the mesh dims that shard ``x``.
    Plain tensors go to ``fn`` as they are."""
    if not isinstance(x, DTensor):
        return fn(x, w, b)
    mesh, placements = x.device_mesh, tuple(x.placements)
    x = gather_dims(x, [1])
    sizes, offsets = _local_block(x.shape, mesh, x.placements)
    c0, c1 = offsets[2], offsets[2] + sizes[2]
    part = [Partial() if isinstance(p, Shard) else Replicate() for p in x.placements]
    wl = gather_dims(w).to_local(grad_placements=part)[:, c0:c1]
    bl = gather_dims(b).to_local(grad_placements=part)[c0:c1]
    y = fn(x.to_local(grad_placements=x.placements), wl, bl)
    y = _FromLocal.apply(y, mesh, tuple(x.placements), x.shape, _global_stride(y, x.shape))
    return y if tuple(y.placements) == placements else y.redistribute(mesh, placements)


def chunk_blocks(fn, x, decay, state):
    """``fn(x, decay, state)`` for the SSD scan's recurrence over chunks,
    elementwise in every other dim: ``x`` (B, nc, H, P, N), ``decay``
    (B, nc, H), ``state`` (B, H, P, N). Under DTensors it runs on each
    device's block, the chunks gathered once and ``decay`` and ``state``
    laid out as ``x`` (DTensor would dispatch every step of the loop, and
    index a sharded chunk dim chunk by chunk); returns (fn's outputs) laid
    out as ``x`` and ``state`` then are. Plain tensors go to ``fn`` as they
    are."""
    if not isinstance(x, DTensor):
        return fn(x, decay, state)
    mesh = x.device_mesh
    x = gather_dims(_plain_placements(x), [1])
    xpl = list(x.placements)
    # x's dims (b, c, h, p, n) in decay (b, c, h) and state (b, h, p, n)
    to_decay, to_state = {0: 0, 2: 2}, {0: 0, 2: 1, 3: 2, 4: 3}
    dpl = [Shard(to_decay[p.dim]) if isinstance(p, Shard) and p.dim in to_decay
           else Replicate() for p in xpl]
    spl = [Shard(to_state[p.dim]) if isinstance(p, Shard) else Replicate() for p in xpl]
    decay, state = (_as_dtensor(t, mesh) for t in (decay, state))
    decay, state = (_plain_placements(t) for t in (decay, state))
    decay = decay if list(decay.placements) == dpl else decay.redistribute(mesh, dpl)
    state = state if list(state.placements) == spl else state.redistribute(mesh, spl)
    prev, last = fn(x.to_local(grad_placements=xpl), decay.to_local(grad_placements=dpl),
                    state.to_local(grad_placements=spl))
    return (_FromLocal.apply(prev, mesh, tuple(xpl), x.shape, _global_stride(prev, x.shape)),
            _FromLocal.apply(last, mesh, tuple(spl), state.shape,
                             _global_stride(last, state.shape)))


def gather_uneven(t, dim: int):
    """``t`` with its dim ``dim`` gathered over the mesh dims that shard it
    unevenly (DTensor's views cannot split or merge such a dim: the kv heads
    before their GQA repeat). Anything else is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    ways = math.prod(t.device_mesh.size(m) for m, p in enumerate(t.placements)
                     if isinstance(p, Shard) and p.dim == dim)
    return t if t.shape[dim] % ways == 0 else gather_dims(t, [dim])


def gather_to_split(t, dim: int, inner: int, to: Optional[int] = None):
    """``t`` made ready to split its dim ``dim`` into (size / ``inner``,
    ``inner``) (the SSD scan's chunks). Where ``dim`` is sharded in blocks
    that are not whole multiples of ``inner`` (and the split leaves more
    than one outer block, else the shard moves to the inner dim), its shard
    moves to the dim ``to`` when that divides evenly (an all-to-all; GSPMD
    keeps such a split sharded too), or else the dim is gathered. Anything
    else is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    size = t.shape[dim]
    over = [m for m, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim]
    ways = math.prod(t.device_mesh.size(m) for m in over)
    if ways == 1 or size == inner or (size % ways == 0 and (size // ways) % inner == 0):
        return t
    if to is not None and not any(isinstance(p, Shard) and p.dim == to % t.ndim
                                  for p in t.placements) and t.shape[to] % ways == 0:
        return t.redistribute(t.device_mesh, [Shard(to % t.ndim) if m in over else p
                                              for m, p in enumerate(t.placements)])
    return gather_dims(t, [dim])


def gather_to_merge(t, start: int, end: int):
    """``t`` made ready to merge its dims ``start`` .. ``end - 1`` into one
    (the MoE's tokens (B, S) -> (G, Tg)): an inner dim that is sharded is
    gathered, as GSPMD gathers it there (DTensor would flatten it into a
    strided shard, which its redistribution cannot take apart on fake
    tensors), and so is an outer dim sharded unevenly. Anything else is
    returned as it is."""
    return gather_dims(gather_uneven(t, start), range(start + 1, end))


class _MergeableGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient ready to merge the
    dims ``start`` .. ``end - 1`` (``gather_to_merge``), for a result the
    forward split out of one dim (its view's backward merges them)."""

    @staticmethod
    def forward(ctx, t, start, end):
        ctx.start, ctx.end = start, end
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return gather_to_merge(grad, ctx.start, ctx.end), None, None


def gather_grad_to_merge(t, start: int, end: int):
    """``t`` as it is, its gradient made ready to merge its dims ``start``
    .. ``end - 1`` (the MoE's output (G, Tg) -> (B, S), whose gradient
    arrives sharded as the residual stream is). A plain tensor is returned
    as it is."""
    return _MergeableGrad.apply(t, start, end) if isinstance(t, DTensor) else t


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose backward hands back the local block of
    the gradient laid out as the output (``Partial`` read as
    ``Replicate``), the same in every torch version."""

    @staticmethod
    def forward(ctx, local, mesh, placements, shape, stride):
        ctx.mesh = mesh
        ctx.grad_placements = tuple(Replicate() if p.is_partial() else p for p in placements)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.grad_placements:
            grad = grad.redistribute(ctx.mesh, ctx.grad_placements)
        return grad.to_local(), None, None, None, None


def _wrap(local: torch.Tensor, mesh, placements, shape, reduce_to=None) -> DTensor:
    """A device's local result as a DTensor of global ``shape``, any partial
    sum reduced at once (see the module docstring): to ``Replicate``, or to
    the placement ``reduce_to`` names for its mesh dim (a reduce-scatter)."""
    y = _FromLocal.apply(local, mesh, tuple(placements), torch.Size(shape),
                         _global_stride(local, shape))
    if any(p.is_partial() for p in placements):
        to = reduce_to or [None] * len(placements)
        y = y.redistribute(mesh, [(t or Replicate()) if p.is_partial() else p
                                  for p, t in zip(placements, to)])
    return y


def _global_stride(local: torch.Tensor, shape: Sequence[int]) -> Tuple[int, ...]:
    """Strides of the global tensor ``shape`` laid out in the same dim order
    as ``local`` (einsum and transposes return permuted layouts)."""
    order = sorted(range(len(shape)), key=lambda d: (-local.stride(d), d))
    stride, acc = [0] * len(shape), 1
    for d in reversed(order):
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


def _as_dtensor(t, mesh) -> DTensor:
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _plain_placements(t: DTensor) -> DTensor:
    """Partial sums and strided shards redistributed to ``Replicate``."""
    if all(_plain(p) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [p if _plain(p) else Replicate() for p in t.placements])


def sharded_einsum(equation: str, *operands) -> DTensor:
    """``torch.einsum`` on operands of which at least one is a DTensor; the
    plain ones are replicated (see the module docstring)."""
    mesh = next(t for t in operands if isinstance(t, DTensor)).device_mesh
    ops = [_plain_placements(_as_dtensor(t, mesh)) for t in operands]
    subs, out = _expand(equation, [t.ndim for t in ops])
    targets, out_pl, grads = _plan(subs, out, ops, mesh)
    locals_ = []
    for t, want, g in zip(ops, targets, grads):
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        locals_.append(t.to_local(grad_placements=g))
    shape = [max(t.shape[s.index(L)] for s, t in zip(subs, ops) if L in s) for L in out]
    y = _EINSUM(",".join(subs) + "->" + out, *locals_)
    return _wrap(y, mesh, out_pl, shape)


def sharded_logsumexp(x: DTensor, dim: int, keepdim: bool = False) -> DTensor:
    """``torch.logsumexp`` over a dim that ``x`` shards: the local maximum
    and the local sum of exponentials, each reduced over the mesh dims that
    shard ``dim`` (the shift carries no gradient, as in any logsumexp)."""
    mesh = x.device_mesh
    dim = dim % x.ndim
    x = _plain_placements(x)
    over = {m for m, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim}
    out_pl = [Replicate() if m in over else
              Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > dim and not keepdim else p
              for m, p in enumerate(x.placements)]
    shape = list(x.shape)
    shape[dim] = 1
    if not keepdim:
        del shape[dim]
    local = x.to_local(grad_placements=x.placements)
    mx = torch.amax(local.detach(), dim=dim, keepdim=keepdim)
    mx = _wrap(mx, mesh, [Partial("max") if m in over else p for m, p in enumerate(out_pl)],
               shape).to_local()
    sumexp = torch.sum(torch.exp(local - (mx if keepdim else mx.unsqueeze(dim))), dim=dim,
                       keepdim=keepdim)
    total = _wrap(sumexp, mesh, [Partial() if m in over else p for m, p in enumerate(out_pl)],
                  shape)
    return _wrap(mx, mesh, out_pl, shape) + torch.log(total)


def sharded_softmax(x: DTensor, dim: int, dtype=None) -> DTensor:
    """``torch.softmax`` over a dim that ``x`` shards: exp(x - logsumexp),
    two small reductions where DTensor would gather ``x`` whole."""
    if dtype is not None:
        x = x.to(dtype)
    return torch.exp(x - sharded_logsumexp(x, dim, keepdim=True))


def sharded_cumsum(x: DTensor, dim: int, dtype=None) -> DTensor:
    """``torch.cumsum`` along ``dim`` on each device's block, ``x`` gathered
    over ``dim`` first and the result laid out as ``x`` was (the SSD scan's
    decays along a chunk): the forward and the backward are local, where
    DTensor has no rule for the ``flip`` of cumsum's backward in some torch
    versions."""
    mesh = x.device_mesh
    dim %= x.ndim
    x = _plain_placements(x)
    orig = tuple(x.placements)
    x = gather_dims(x, [dim])
    pl = tuple(x.placements)
    y = _CUMSUM(x.to_local(grad_placements=pl), dim, dtype=dtype)
    y = _FromLocal.apply(y, mesh, pl, x.shape, _global_stride(y, x.shape))
    return y if pl == orig else y.redistribute(mesh, orig)  # laid out as x was


def _local_block(shape, mesh, placements) -> Tuple[List[int], List[int]]:
    """(sizes, offsets) of this device's block of a tensor of global
    ``shape`` laid out as ``placements`` (``torch.chunk``'s split; a dim
    that several mesh dims shard is split in mesh-dim order)."""
    sizes, offsets = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            n, d = mesh.size(m), p.dim
            chunk = -(-sizes[d] // n)
            start = min(coord[m] * chunk, sizes[d])
            offsets[d] += start
            sizes[d] = min(chunk, sizes[d] - start)
    return sizes, offsets


def sharded_getitem(x: DTensor, key) -> DTensor:
    """``x[i0, i1, ...]`` with index tensors for a prefix of ``x``'s dims
    (advanced indexing). Per mesh dim: a dim of ``x`` that is indexed and
    sharded keeps its shard, the indices are gathered whole and each device
    gathers the entries it holds, zero elsewhere (a ``Partial`` sum); a
    sharded dim that is not indexed keeps its shard, and the indices are
    gathered over that mesh dim (GSPMD keeps an FSDP table's embed dim
    sharded and the batch whole); over a mesh dim that does not shard
    ``x``, the indices keep their shard and so does the result. The partial
    sum is scattered over the dim whose index was sharded on that mesh dim
    where there is one. An index outside [0, size) raises ``IndexError``."""
    mesh = x.device_mesh
    idx = [_plain_placements(_as_dtensor(t, mesh)) for t in key]
    k = len(idx)
    bshape = list(torch.broadcast_shapes(*(t.shape for t in idx)))
    nb = len(bshape)
    x = _plain_placements(x)
    x_pl, out_pl, reduce_to = list(x.placements), [], [None] * mesh.ndim
    idx_pl = [[Replicate()] * mesh.ndim for _ in idx]
    for m in range(mesh.ndim):
        p = x_pl[m]
        # the broadcast dims over which an index is sharded on this mesh dim
        sharded_idx = {t.placements[m].dim + nb - t.ndim
                       for t in idx if isinstance(t.placements[m], Shard)}
        if isinstance(p, Shard):
            out_pl.append(Partial() if p.dim < k else Shard(p.dim - k + nb))
            if p.dim < k and len(sharded_idx) == 1:
                # the partial result is scattered as the indices were
                # sharded (GSPMD keeps a sequence-sharded embedding so)
                reduce_to[m] = Shard(next(iter(sharded_idx)))
        elif len(sharded_idx) == 1:
            (j,) = sharded_idx
            for i, t in enumerate(idx):
                d = j + t.ndim - nb
                if d >= 0 and t.shape[d] > 1:
                    idx_pl[i][m] = Shard(d)
            out_pl.append(Shard(j))
        else:
            out_pl.append(Replicate())
    x = x.redistribute(mesh, x_pl) if list(x.placements) != x_pl else x
    # a replicated x gathered by sharded indices holds a partial gradient
    local = x.to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) and isinstance(o, Shard) else p
        for p, o in zip(x_pl, out_pl)])
    sizes, offsets = _local_block(x.shape, mesh, x_pl)
    valid, loc = None, []
    for d, (t, pl) in enumerate(zip(idx, idx_pl)):
        i = (t.redistribute(mesh, pl) if list(t.placements) != pl else t).to_local()
        # a fake tensor has no values to check (the dry run)
        if not isinstance(i, FakeTensor) and bool(((i < 0) | (i >= x.shape[d])).any()):
            raise IndexError(f"index out of range [0, {x.shape[d]}) for dim {d} of a DTensor "
                             f"of shape {tuple(x.shape)} (negative indices are not supported)")
        i = i - offsets[d]
        ok = (i >= 0) & (i < sizes[d])
        valid = ok if valid is None else valid & ok
        loc.append(torch.clamp(i, 0, sizes[d] - 1))
    y = local[tuple(loc)]
    if any(isinstance(p, Shard) and p.dim < k for p in x_pl):
        mask = valid.reshape(valid.shape + (1,) * (y.ndim - valid.ndim))
        y = torch.where(mask, y, torch.zeros((), dtype=y.dtype, device=y.device))
    return _wrap(y, mesh, out_pl, bshape + list(x.shape[k:]), reduce_to)


def sharded_setitem(x: DTensor, key, value) -> None:
    """``x[a:b, c:d, ...] = value`` in place, for slices of step 1: each
    device writes the part of ``value`` that falls in its own block (the
    decode cache write into a cache sharded over its sequence). ``value``
    is gathered over the mesh dims that shard a dim the key slices, and
    keeps the shards of the dims it covers whole."""
    mesh = x.device_mesh
    keys = list(key if isinstance(key, tuple) else (key,))
    keys += [slice(None)] * (x.ndim - len(keys))
    ranges = [k.indices(n)[:2] for k, n in zip(keys, x.shape)]
    full = [lo == 0 and hi == n for (lo, hi), n in zip(ranges, x.shape)]
    v_pl = [p if isinstance(p, Shard) and full[p.dim] else Replicate() for p in x.placements]
    v = _plain_placements(_as_dtensor(value, mesh))
    v_local = (v.redistribute(mesh, v_pl) if list(v.placements) != v_pl else v).to_local()
    sizes, offsets = _local_block(x.shape, mesh, x.placements)
    sharded = {p.dim for p in x.placements if isinstance(p, Shard)}
    local_key, value_key = [], []
    for d, (lo, hi) in enumerate(ranges):
        if d in sharded and not full[d]:
            a, b = max(lo, offsets[d]), min(hi, offsets[d] + sizes[d])
            if a >= b:
                return  # no part of the slice lies in this device's block
            local_key.append(slice(a - offsets[d], b - offsets[d]))
            value_key.append(slice(a - lo, b - lo))
        else:
            local_key.append(slice(lo, hi) if d not in sharded else slice(None))
            value_key.append(slice(None))
    x.to_local()[tuple(local_key)] = v_local[tuple(value_key)]


_EINSUM = torch.einsum
_CUMSUM = torch.cumsum
_LOGSUMEXP = torch.logsumexp
_SOFTMAX = torch.softmax
_GETITEM = DTensor.__getitem__
_SETITEM = DTensor.__setitem__
_MISSING = object()


def _einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    if any(isinstance(t, DTensor) for t in operands):
        return sharded_einsum(equation, *operands)
    return _EINSUM(equation, *operands)


def _cumsum(x, dim, *, dtype=None):
    if isinstance(x, DTensor):
        return sharded_cumsum(x, dim, dtype)
    return _CUMSUM(x, dim, dtype=dtype)


def _logsumexp(x, dim, keepdim=False):
    if _shards(x, dim):
        return sharded_logsumexp(x, dim, keepdim)
    return _LOGSUMEXP(x, dim, keepdim=keepdim)


def _shards(x, dim) -> bool:
    return isinstance(x, DTensor) and isinstance(dim, int) and any(
        isinstance(p, Shard) and p.dim == dim % x.ndim for p in x.placements)


def _softmax(x, dim, dtype=None):
    if _shards(x, dim):
        return sharded_softmax(x, dim, dtype)
    return _SOFTMAX(x, dim, dtype=dtype)


def _getitem(x, key):
    keys = key if isinstance(key, tuple) else (key,)
    if keys and all(isinstance(t, torch.Tensor) and not t.dtype.is_floating_point
                    and t.dtype != torch.bool for t in keys) and len(keys) <= x.ndim:
        return sharded_getitem(x, keys)
    return _GETITEM(x, key)


def _setitem(x, key, value):
    keys = key if isinstance(key, tuple) else (key,)
    if all(isinstance(k, slice) and k.step in (None, 1) for k in keys) and len(keys) <= x.ndim:
        return sharded_setitem(x, keys, value)
    return _SETITEM(x, key, value)


@contextlib.contextmanager
def spmd(mesh):
    """Run the port's model code on DTensors over ``mesh`` (see the module
    docstring). ``torch.einsum``, ``torch.cumsum``, ``torch.logsumexp``,
    ``torch.softmax`` and DTensor indexing and slice assignment are replaced
    for the duration, process-wide, so that the recomputation of a
    checkpointed block in the backward pass, which runs outside any
    torch-function mode, takes the same rules as its forward. Being
    process-wide, it does not nest."""
    if torch.einsum is _einsum:
        raise RuntimeError("spmd() is already open: its rules are process-wide and do not nest")
    saved = (torch.einsum, torch.cumsum, torch.logsumexp, torch.softmax)
    own = {k: vars(DTensor).get(k, _MISSING) for k in ("__getitem__", "__setitem__")}
    torch.einsum, torch.cumsum, torch.logsumexp, torch.softmax = (_einsum, _cumsum, _logsumexp,
                                                                 _softmax)
    DTensor.__getitem__, DTensor.__setitem__ = _getitem, _setitem
    try:
        with implicit_replication():
            yield mesh
    finally:
        torch.einsum, torch.cumsum, torch.logsumexp, torch.softmax = saved
        for k, v in own.items():
            if v is _MISSING:
                delattr(DTensor, k)
            else:
                setattr(DTensor, k, v)
