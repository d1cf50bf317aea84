"""The comparison that decides ``correct``.

The program's readings of its first steps are held to the reference's
(``reference/``), which follows the same first steps from the same weights
and batches:

- ``loss_rel_gap``: the largest |loss - reference loss| / |reference loss|
  over the compared steps;
- ``grad_norm_gap``: the first gradient as AdamW got it, read back from the
  first moment after one step (m / (1 - b1)); for each leaf, and each layer
  of a stacked leaf, the gap between the program's norm and the reference's,
  over the larger of the reference's norm of that slice and of the median
  slice; the worst slice;
- ``update_norm_gap``: the same for the parameters' change over the compared
  steps. Slices whose reference gradient is under a thousandth of the
  median slice's are left out: Adam moves them by round-off alone.

Besides, the DSE guarantees are held exactly (limit 0), as the system
states them: a run with failures ends bit-identical to one without, and the
metrics SO holds every surviving step exactly once.

- ``replay_loss_diff``: after a trainer kill, the largest |loss| gap between
  a replayed step and the same step before the kill;
- ``replay_state_diff``: the number of parameter and moment tensors whose
  bits differ between the kill point and the replay's return to it (every
  tensor counts as differing when the replay never got there);
- ``metrics_once_gap``: steps of the trainer's history recorded in the
  metrics SO other than exactly once, or with another loss, and records of
  steps the trainer does not hold;
- ``rollback_gap``: |rollbacks the driver saw - kills the traffic made|.
"""
from __future__ import annotations

import statistics
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .reference import common

#: the DSE guarantees are exact
EXACT = ("replay_loss_diff", "replay_state_diff", "metrics_once_gap", "rollback_gap")
#: the reference comparisons; their limits live in each configuration file
COMPARED = ("loss_rel_gap", "grad_norm_gap", "update_norm_gap")
#: a slice whose reference gradient is under this share of the median
#: slice's is left out of the update comparison
TINY_GRAD = 1e-3


def slice_norms(descs: dict, tree: dict, scale: float = 1.0) -> Dict[str, float]:
    """The float64 norm of each leaf of ``tree``, and of each layer of a
    stacked leaf, times ``scale``: {"path[i]": norm}."""
    out: Dict[str, float] = {}
    for (path, desc), (_, t) in zip(common.flatten(descs), common.flatten(tree)):
        n = 1
        for d in desc[0][: desc[3]]:
            n *= d
        norms = torch.linalg.vector_norm(t.detach().reshape(n, -1), dim=1,
                                         dtype=torch.float64).tolist()
        for i, v in enumerate(norms):
            out[f"{path}[{i}]"] = v * scale
    return out


def change_norms(descs: dict, tree: dict, initial: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, float]:
    """``slice_norms`` of ``tree`` less the initial weights, taken one leaf at
    a time from ``initial`` (a stream of (path, tensor) in sorted order)."""
    out: Dict[str, float] = {}
    flat = dict(common.flatten(tree))
    for (path, desc), (p0_path, p0) in zip(common.flatten(descs), initial):
        assert path == p0_path, (path, p0_path)
        out.update(slice_norms({path: desc}, {path: flat[path] - p0}))
    return out


def grad_norms(descs: dict, first_moment: dict, b1: float) -> Dict[str, float]:
    """The first step's gradient as AdamW got it, from m after one step."""
    return slice_norms(descs, first_moment, 1.0 / (1.0 - b1))


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[set] = None) -> Tuple[float, str]:
    med = statistics.median(ref.values())
    worst, where = 0.0, ""
    for k, r in ref.items():
        if keep is not None and k not in keep:
            continue
        p = prog.get(k, float("nan"))
        gap = abs(p - r) / max(r, med, 1e-30)
        if not gap <= worst:  # a NaN is the worst
            worst, where = gap, k
    return worst, where


def compare(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """Readings {"loss": [...], "grad": {...}, "update": {...}} of the program
    and of the reference -> {number: (value, where)}."""
    n = len(ref["loss"])
    if len(prog["loss"]) < n:
        loss = (float("inf"), f"{len(prog['loss'])} of {n} steps")
    else:
        gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
        i = max(range(n), key=lambda j: (gaps[j] != gaps[j], gaps[j]))
        loss = (gaps[i], f"step {i}")
    med = statistics.median(ref["grad"].values())
    moved = {k for k, g in ref["grad"].items() if g >= TINY_GRAD * med}
    return {"loss_rel_gap": loss,
            "grad_norm_gap": _norm_gap(prog["grad"], ref["grad"]),
            "update_norm_gap": _norm_gap(prog["update"], ref["update"], moved)}


def checksums(trees: Iterable[dict]) -> List[int]:
    """One integer a tensor (parameters, then moments) that any change of a
    bit moves: the sum of its 32-bit words, exactly, in int64."""
    out = []
    for tree in trees:
        for _, t in common.flatten(tree):
            out.append(int(t.detach().contiguous().view(torch.int32).sum(dtype=torch.int64)))
    return out


def metrics_once_gap(history: List[Tuple[int, float]], records: List[Tuple[int, float]]) -> int:
    want = dict(history)
    seen = Counter(s for s, _ in records)
    bad = sum(1 for s in want if seen[s] != 1)
    bad += sum(1 for s, l in records if s not in want or (seen[s] == 1 and l != want[s]))
    return bad


def verdict(numbers: Dict[str, Tuple[float, str]], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit", "where"}}); a number with no
    limit fails."""
    out, ok = {}, True
    for name, (value, where) in numbers.items():
        limit = 0.0 if name in EXACT else limits.get(name)
        good = limit is not None and value <= limit
        ok &= good
        out[name] = {"value": value, "limit": limit, "where": where}
    return ok, out
