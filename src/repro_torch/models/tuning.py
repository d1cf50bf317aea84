"""Performance-tuning flags (port of ``repro/models/tuning.py``).

A context-var style switchboard, so one call site can run the same step in
baseline and tuned variants without touching model call signatures:

  decode_seq_constraint — decode attention contracts the query, reshaped to
      (B, S, Nkv, G, H), against the un-repeated K/V cache (the reference's
      flash-decode einsum), the cache pinned to sequence sharding over
      "model" and the query replicated there;
  loss_chunk — compute the LM head + cross-entropy over sequence chunks of
      this size (0 = off), bounding the f32 logits working set;
  microbatch — grad-accumulation microbatches per step (1 = off), dividing
      saved-activation memory;
  constrain_activations — pin the (B, S, D) activations to batch
      sharding at every block's entry (``constrain_batch_sharded``);
  moe_impl — "einsum" (GShard grouped one-hot dispatch, ``layers.moe``) or
      "ep" (the index-based dispatch with expert parallelism over an
      all-to-all, ``parallel/ep_moe.py``). As in the reference, "ep" takes
      that route only under an EP mesh (``ep_mesh(...)``, read by
      ``get_ep_mesh``), a world of one included, and the einsum dispatch
      without one; ``layers.moe`` adds the shared experts outside the route.

The reference's ``constrain*`` helpers (``with_sharding_constraint`` under
the ambient mesh) are DTensor redistributions here: they act on the
DTensors of a step run under ``parallel.spmd`` (the dry run, a process
group) and are exact no-ops on plain tensors, and where a spec names a mesh
axis the mesh lacks or does not divide its dim, as the reference's are off
a mesh. ``"free"`` leaves the placement of the mesh dims that shard that dim
as it is. Only a tuned step calls them: ``transformer._block_apply`` at
every block's entry under ``constrain_activations``, and decode attention
on its cache and query under ``decode_seq_constraint``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

from torch.distributed.tensor import DTensor, Replicate, Shard


@dataclass(frozen=True)
class Tuning:
    decode_seq_constraint: bool = False
    loss_chunk: int = 0
    microbatch: int = 1
    constrain_activations: bool = False
    moe_impl: str = "einsum"


_CURRENT = Tuning()


def get_tuning() -> Tuning:
    return _CURRENT


class tuning:
    def __init__(self, **kw) -> None:
        self._kw = kw

    def __enter__(self) -> Tuning:
        global _CURRENT
        self._prev = _CURRENT
        _CURRENT = replace(_CURRENT, **self._kw)
        return _CURRENT

    def __exit__(self, *exc) -> None:
        global _CURRENT
        _CURRENT = self._prev


def _placements(x: DTensor, entries: Sequence) -> Optional[list]:
    """The placements ``entries`` give ``x`` on its mesh, or None where
    the spec cannot apply (a mesh axis the mesh lacks, a dim it does not
    divide, a mesh axis named twice)."""
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names or ())
    pl, named = list(x.placements), set()
    free = {d for d, e in enumerate(entries) if e == "free"}
    for m, p in enumerate(pl):  # a mesh dim on a dim left free keeps its placement
        if not (isinstance(p, Shard) and p.dim in free) and not p.is_partial():
            pl[m] = Replicate()
    for d, e in enumerate(entries):
        if e is None or e == "free":
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        if any(a not in names or a in named for a in axes):
            return None
        ways = 1
        for a in axes:
            ways *= mesh.size(names.index(a))
        if x.shape[d] % ways:
            return None
        for a in axes:
            pl[names.index(a)] = Shard(d)
        named.update(axes)
    return pl


def constrain(x, entries):
    """``with_sharding_constraint`` for a DTensor: ``entries``, one per dim,
    name a mesh axis (or a tuple of them), None (replicated) or "free"
    (unconstrained). Anything else, and a spec that cannot apply, passes
    unchanged."""
    if not isinstance(x, DTensor):
        return x
    pl = _placements(x, entries)
    if pl is None or pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def constrain_seq_sharded(x, seq_axis: int):
    entries = ["free"] * x.ndim
    entries[seq_axis] = "model"
    for i in range(x.ndim):
        if i != seq_axis and i != 0:
            entries[i] = None  # model axis consumed by seq; rest replicated
    return constrain(x, entries)


def constrain_batch_sharded(x):
    """Pin dim 0 to the batch mesh axes (pod+data where the mesh has a pod
    axis), the rest replicated (Megatron-style activation layout: (B/dp, S,
    D-full)); only under ``constrain_activations``."""
    if not get_tuning().constrain_activations or not isinstance(x, DTensor):
        return x
    for batch_axes in (("pod", "data"), "data"):
        entries = (batch_axes,) + (None,) * (x.ndim - 1)
        if _placements(x, entries) is not None:
            return constrain(x, entries)
    return x


def constrain_replicated_heads(q):
    """Decode flash-decode scheme: q is (B, 1, N, H) and tiny; replicating
    it over the model axis lets QK^T run against sequence-sharded K/V with
    no resharding."""
    return constrain(q, ("free", None, None, None))
