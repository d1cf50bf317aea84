"""Initial weights from the seed, made on the device in one call a leaf.

Every leaf of the reference's layout (``reference/<family>.py::descs``; a
leaf of the stacked layers is one tensor for all of them) is drawn in
sorted-path order from one ``torch.Generator`` on the device: normal
leaves as N(0, 1) scaled by 1/sqrt(fan-in), the norms' weights, biases and
``A_log`` zeros, ``D`` ones. The program and the reference get the same
tensors; neither draws its own."""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from .reference import common


def seed_bits(seed: int) -> int:
    """Any whole number as a generator seed (63 bits)."""
    return int(seed) & ((1 << 63) - 1)


def leaves(descs: dict, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) in sorted-path order: the same tensors on every call."""
    gen = torch.Generator(device=device).manual_seed(seed_bits(seed))
    for path, desc in common.flatten(descs):
        shape, init = desc[0], desc[1]
        if init == "zeros":
            yield path, torch.zeros(shape, dtype=torch.float32, device=device)
        elif init == "ones":
            yield path, torch.ones(shape, dtype=torch.float32, device=device)
        else:
            x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            yield path, x.mul_(common.leaf_std(desc))


def tree(descs: dict, seed: int, device) -> dict:
    paths, ts = zip(*leaves(descs, seed, device))
    return common.unflatten(list(paths), list(ts))


def flat(descs: dict, seed: int, device) -> Tuple[List[str], List[torch.Tensor]]:
    paths, ts = zip(*leaves(descs, seed, device))
    return list(paths), list(ts)
