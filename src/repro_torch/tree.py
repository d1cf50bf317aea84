"""Nested-container helpers in ``jax.tree_util`` order.

The port keeps parameters and optimizer state as nested dicts of tensors,
as the JAX package keeps them as pytrees. Flattening visits dict keys in
sorted order, recursively, exactly as ``jax.tree_util.tree_flatten`` does,
so the flat streams (checkpoint blobs, parameter digests) interchange with
the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Tuple


@dataclass(frozen=True)
class TreeDef:
    kind: str                       # "leaf" | "dict" | "list" | "tuple"
    keys: Tuple[Any, ...] = ()
    children: Tuple["TreeDef", ...] = ()


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def go(node) -> TreeDef:
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return TreeDef("dict", keys, tuple(go(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return TreeDef(kind, (), tuple(go(c) for c in node))
        leaves.append(node)
        return TreeDef("leaf")

    return leaves, go(tree)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def go(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        kids = [go(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, kids))
        return kids if td.kind == "list" else tuple(kids)

    out = go(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    leaves, td = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])
