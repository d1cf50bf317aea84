"""Parameter descriptors and materialisation (port of ``repro/models/params.py``).

Every model describes its parameters once, as a nested dict whose leaves
are :class:`PDesc`. ``init_params`` draws them with an explicit
``torch.Generator``. Torch cannot reproduce ``jax.random`` streams, so code
that must start from the reference's exact weights loads them with
``params_from_jax``. Sharding resolution has no counterpart yet: the port
runs on one card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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
