"""Parameter descriptors and materialisation (port of ``repro/models/params.py``).

Every model describes its parameters once, as a nested dict whose leaves
are :class:`PDesc`. ``init_params`` draws them with an explicit
``torch.Generator``. Torch cannot reproduce ``jax.random`` streams, so code
that must start from the reference's exact weights loads them with
``params_from_jax``. ``resolve_spec`` turns a leaf's logical axes into mesh
axes by the reference's rules; a spec is a plain tuple with one entry per
dimension up to the last sharded one (``None``, a mesh-axis name or a tuple
of names), which is what ``tuple()`` of the reference's ``PartitionSpec``
gives. ``parallel/sharding.py`` turns specs into DTensor placements.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class PDesc:
    """Parameter leaf descriptor: shape, logical axes, init style."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | small
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_desc(x) -> bool:
    return isinstance(x, PDesc)


def stack(desc: PDesc, n: int, axis_name: Optional[str] = "layers") -> PDesc:
    """Prepend a stacked-layer dimension."""
    return PDesc((n,) + desc.shape, (axis_name,) + desc.axes, desc.init, desc.scale)


def stack_tree(tree, n: int):
    return tree_map(lambda d: stack(d, n), tree)


def _init_leaf(desc: PDesc, gen: torch.Generator, dtype, device) -> torch.Tensor:
    if desc.init == "zeros":
        return torch.zeros(desc.shape, dtype=dtype, device=device)
    if desc.init == "ones":
        return torch.ones(desc.shape, dtype=dtype, device=device)
    fan_in = desc.shape[-2] if len(desc.shape) >= 2 else desc.shape[-1]
    std = desc.scale / np.sqrt(max(fan_in, 1))
    if desc.init == "small":
        std = 0.01 * desc.scale
    x = torch.randn(desc.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * float(std)).to(dtype)


def init_params(descs, generator: torch.Generator, dtype=torch.float32, device=None):
    """Draw every leaf from ``generator``, in flatten order, on ``device``
    (None: the card). The generator must live on the same device."""
    dev = resolve_device(device)
    leaves, td = tree_flatten(descs)
    return tree_unflatten(td, [_init_leaf(d, generator, dtype, dev) for d in leaves])


def zeros_from_descs(descs, dtype=torch.float32, device=None):
    """A tree of zero tensors shaped as ``descs`` (the decode caches: the
    reference maps ``jnp.zeros`` over the tree with ``is_leaf=is_desc``)."""
    dev = resolve_device(device)
    return tree_map(lambda d: torch.zeros(d.shape, dtype=dtype, device=dev), descs)


def params_from_jax(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Nested dict of arrays exported from the JAX package (numpy, or
    anything ``np.asarray`` takes) -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)

    def load(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return tree_map(load, tree)


def param_count(descs) -> int:
    return int(sum(int(np.prod(d.shape)) for d in tree_flatten(descs)[0]))


#: logical axes earlier in this list claim mesh axes first (e.g. kv_heads
#: beats the seq fallback for decode caches; experts beats expert_ffn).
_PRIORITY = {
    "vocab": 0, "heads": 0, "kv_heads": 0, "ffn": 0, "experts": 0,
    "batch": 1, "embed": 2, "expert_ffn": 2, "seq": 3,
}


def resolve_spec(desc: PDesc, rules: Mapping[str, Tuple[str, ...]],
                 mesh_axis_sizes: Mapping[str, int]) -> tuple:
    """Logical axes -> spec. Assignments that do not divide the dimension or
    that reuse a consumed mesh axis are dropped; contested mesh axes go to
    the highest-priority logical axis (fallback chains)."""
    used: set = set()
    out: list = [None] * len(desc.shape)
    order = sorted(
        range(len(desc.shape)),
        key=lambda i: _PRIORITY.get(desc.axes[i], 9) if desc.axes[i] else 99,
    )
    for i in order:
        dim, logical = desc.shape[i], desc.axes[i]
        if logical is None or logical not in rules:
            continue
        mesh_axes = rules[logical]
        mesh_axes = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        total = 1
        for a in mesh_axes:
            total *= mesh_axis_sizes.get(a, 1)
        if mesh_axes and total > 1 and dim % total == 0:
            out[i] = mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
            used.update(mesh_axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def resolve_specs(descs, rules, mesh_axis_sizes):
    """``resolve_spec`` over a descriptor tree. The result's leaves are
    tuples, which ``tree_flatten`` would descend into: read it by the
    descriptor tree's keys."""
    return tree_map(lambda d: resolve_spec(d, rules, mesh_axis_sizes), descs)


def param_bytes(descs, bytes_per_param: int = 2) -> int:
    return param_count(descs) * bytes_per_param
