"""Per-device cost of a torch program, counted beneath DTensor (the port's
counterpart of ``repro/analysis/hlo.py`` and of XLA's ``cost_analysis``).

The reference reads the per-device HLO after the SPMD partitioner. The port
has no HLO: it runs the step once on DTensors (``parallel/spmd.py``), and
``OpCounter``, a ``TorchDispatchMode``, sees every operator that a device
runs on its local shard. It returns ``NotImplemented`` for operators on
``DTensor``s, as ``CommDebugMode`` does, so DTensor unwraps them and the
counter sees the local operator once. It counts:

  * dot flops, 2·M·N·K, from ``torch.utils.flop_counter``'s formulas;
  * elementwise flops, one per output element of a pointwise operator
    and of a copy into another dtype (XLA's ``convert``), and one per input
    element of a reduction, which approximates what XLA's
    ``HloCostAnalysis`` adds to "flops" (a copy in the same dtype, such as
    ``clone``, computes nothing);
  * conversion flops, one per element of every bf16 input and output of
    a product or a pointwise operator: XLA's CPU backend, where the
    reference's counts are taken, computes bf16 work in f32 and its cost
    analysis counts the ``convert`` it inserts on each side as a flop (a
    bf16 multiply of n elements costs 3n there). An H100 computes bf16
    natively, so these are kept apart: ``cost_dict()["flops"]`` includes
    them, as XLA's does, and the dry run's roofline leaves them out;
  * bytes accessed, every tensor input and output of an operator that
    moves data (not a view, an allocation or a metadata query; unfused:
    XLA's fusions read and write less);
  * collectives, each functional or c10d collective as
    ``(kind, result_bytes, group_size)`` in the reference's kind names.

DTensor's sharding propagation runs each new operator signature once more
at the *global* shapes, through every active mode, to learn the output's
metadata; it is cached, so a counter that saw it would count a cell's first
trace differently from its second. The counter ignores everything that
runs inside the propagation.

``collective_wire_bytes`` applies the reference's ring factors to the
collective records, unchanged:

  all-gather(result R, groups of n):      R * (n-1)/n          sent per chip
  reduce-scatter(result R, groups of n):  R * (n-1)            (input = R*n)
  all-reduce(result R, groups of n):      2 * R * (n-1)/n      (RS + AG)
  all-to-all(result R, groups of n):      R * (n-1)/n
  collective-permute(result R):           R
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: functional (``_c10d_functional``) and c10d collectives -> the reference's kinds
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")
#: operators that compute nothing and move no tensor data
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
         "lift_fresh", "alias", "_local_scalar_dense", "wait_tensor", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size"}


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _converts(name: str, args, out) -> bool:
    """A copy into another dtype (XLA's ``convert``); a copy in the same
    dtype computes nothing."""
    return (name in ("_to_copy", "copy_") and isinstance(out, torch.Tensor)
            and isinstance(args[-1 if name == "copy_" else 0], torch.Tensor)
            and args[-1 if name == "copy_" else 0].dtype != out.dtype)


def _group_size(func, args) -> int:
    """The size of the process group a collective runs over: its
    ``group_size`` argument where it has one, else its group's size."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a, s in zip(args, func._schema.arguments):
        if s.name == "group_size":
            return int(a)
    for a, s in zip(args, func._schema.arguments):
        if s.name == "group_name":
            return _resolve_process_group(a).size()
        if s.name == "process_group":
            return a.size()
    raise ValueError(f"cannot tell the group of {func}")


class _PropagationGuard:
    """Patches DTensor's sharding propagator so that the counter ignores
    the operators it runs at global shapes to learn output metadata."""

    def __init__(self, counter: "OpCounter") -> None:
        self.counter = counter

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        if not hasattr(ShardingPropagator, name):
            raise RuntimeError(f"this torch's ShardingPropagator has no {name}: the "
                               "counter cannot tell propagation from local work")
        self._cls, self._name = ShardingPropagator, name
        self._orig = getattr(ShardingPropagator, name)
        counter, orig = self.counter, self._orig

        def guarded(prop, *a, **kw):
            counter._paused += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                counter._paused -= 1

        setattr(ShardingPropagator, name, guarded)
        return self

    def __exit__(self, *exc):
        setattr(self._cls, self._name, self._orig)


class OpCounter(TorchDispatchMode):
    """Counts the local operators of one device while active (see the
    module docstring). Use as a context manager; read ``dot_flops``,
    ``elementwise_flops``, ``bytes_accessed``, ``collectives`` and
    ``conversion_flops``, ``cost_dict()``."""

    def __init__(self) -> None:
        super().__init__()
        self.dot_flops = 0
        self.elementwise_flops = 0
        self.conversion_flops = 0
        self.bytes_accessed = 0
        self.collectives: List[Tuple[str, int, int]] = []
        self._paused = 0
        self._guard = _PropagationGuard(self)

    def __enter__(self):
        self._guard.__enter__()
        try:
            return super().__enter__()
        except BaseException:
            self._guard.__exit__(None, None, None)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._guard.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _KINDS.get(name)
            if kind is not None:
                self.collectives.append((kind, _nbytes(out if ns == "_c10d_functional" else args[0]),
                                         _group_size(func, args)))
            return
        if func.is_view or ns == "prim" or name in _FREE:
            return
        formula = flop_registry.get(func.overloadpacket)
        pointwise = torch.Tag.pointwise in func.tags and name != "clone"
        if formula is not None:
            self.dot_flops += int(formula(*args, **kwargs, out_val=out))
        elif pointwise or _converts(name, args, out):
            self.elementwise_flops += sum(t.numel() for t in _tensors(out))
        elif torch.Tag.reduction in func.tags:
            self.elementwise_flops += sum(t.numel() for t in _tensors(args[:1]))
        if formula is not None or pointwise:
            self.conversion_flops += sum(t.numel() for t in _tensors(
                list(args) + list(kwargs.values()) + [out]) if t.dtype == torch.bfloat16)
        self.bytes_accessed += _nbytes(list(args) + list(kwargs.values())) + _nbytes(out)

    def cost_dict(self) -> Dict[str, float]:
        """The reference's ``cost_analysis`` keys ("flops" counts the
        conversions, as XLA's does on the CPU)."""
        return {"flops": float(self.dot_flops + self.elementwise_flops + self.conversion_flops),
                "bytes accessed": float(self.bytes_accessed)}


def collective_wire_bytes(records: Iterable[Tuple[str, int, int]]) -> Dict[str, float]:
    """Per-chip wire bytes, total and per op kind (``repro/analysis/hlo.py``'s
    ring factors, on ``(kind, result_bytes, group_size)`` records)."""
    per_kind: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for kind, rbytes, n in records:
        if n <= 1:
            continue
        if kind == "all-gather":
            b = rbytes * (n - 1) / n
        elif kind == "reduce-scatter":
            b = rbytes * (n - 1)
        elif kind == "all-reduce":
            b = 2 * rbytes * (n - 1) / n
        elif kind == "all-to-all":
            b = rbytes * (n - 1) / n
        else:  # collective-permute
            b = float(rbytes)
        per_kind[kind] += b
        counts[kind] += 1
    total = sum(per_kind.values())
    out = {"total": total}
    for k, v in per_kind.items():
        out[k] = v
        out[f"n_{k}"] = counts[k]
    return out
