"""Machine-checked invariants for simulated DSE runs (DESIGN.md §8).

Four checkers, each phrased over artefacts a :class:`~repro.sim.cluster.SimCluster`
run produces:

* :func:`check_linearizable` — Wing–Gong linearizability over a recorded
  operation history against a sequential model (:class:`KVModel`,
  :class:`CounterModel`). Used for fault schedules that never lose
  application state (loss / delay / duplication / partitions / coordinator
  restarts): there, exactly-once transport processing must make the store
  linearizable. Crash schedules instead assert the recovery invariants
  below — the paper's guarantee for *non-barriered* state is a consistent
  prefix, not durability.
* :func:`check_exactly_once_counter` — acknowledged increments form exactly
  1..n (retries and wire duplicates never double-apply).
* :class:`WatermarkMonitor` — the recoverable boundary is monotone within a
  failure epoch (it may retreat only when the failure sequence number
  advances).
* :func:`check_shard_logs` — per-shard durable logs are prefix-consistent:
  decision fsns strictly increase per log, every pair of logs agrees
  byte-for-byte on any fsn they share, and at quiescence every live shard
  log replicates every decision.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple


class InvariantViolation(AssertionError):
    """An invariant checker found a counterexample."""


# --------------------------------------------------------------------------- #
# operation histories                                                          #
# --------------------------------------------------------------------------- #
class _Pending:
    def __repr__(self) -> str:
        return "<pending>"


#: result sentinel for an operation whose response was never observed (call
#: timed out / crashed mid-flight): it may have taken effect or not.
PENDING = _Pending()


@dataclass
class Op:
    client: str
    method: str
    args: Tuple
    result: object
    invoked: float
    returned: Optional[float]  # None => pending (effect unknown)

    @property
    def completed(self) -> bool:
        return self.returned is not None

    def __repr__(self) -> str:
        span = f"[{self.invoked:.4f},{self.returned:.4f}]" if self.completed else f"[{self.invoked:.4f},?)"
        return f"{self.client}:{self.method}{self.args}->{self.result!r}{span}"


class KVModel:
    """Sequential specification of SpeculativeKVStore's service API."""

    initial: Tuple = ()

    @staticmethod
    def apply(state: Tuple, op: Op) -> Tuple[Tuple, object]:
        d = dict(state)
        if op.method == "put":
            key, value = op.args[0], op.args[1]
            d[key] = value
            result: object = "ok"
        elif op.method == "get":
            return state, d.get(op.args[0])
        elif op.method == "delete":
            d.pop(op.args[0], None)
            result = "ok"
        else:
            raise ValueError(f"KVModel cannot apply {op.method!r}")
        return tuple(sorted(d.items())), result


class CounterModel:
    """Sequential specification of CounterStateObject.increment."""

    initial: int = 0

    @staticmethod
    def apply(state: int, op: Op) -> Tuple[int, object]:
        if op.method != "increment":
            raise ValueError(f"CounterModel cannot apply {op.method!r}")
        by = op.args[0] if op.args else 1
        return state + by, state + by


def check_linearizable(history: Sequence[Op], model=KVModel, max_states: int = 2_000_000):
    """Wing–Gong search: find a total order of the operations consistent with
    real-time (an op that completed before another was invoked must come
    first) under which the sequential ``model`` reproduces every recorded
    result. Pending ops may linearize anywhere after their invocation or
    never. Returns None if linearizable, else a human-readable explanation.
    """
    ops = list(history)
    n = len(ops)
    completed = [i for i in range(n) if ops[i].completed]
    # search state: frozenset of applied op indices + model state
    seen = set()
    explored = 0

    def minimal(applied: frozenset) -> List[int]:
        """Ops whose invocation is not preceded by an unapplied completed op's
        return — the only legal next linearization points."""
        floor = min(
            (ops[i].returned for i in completed if i not in applied),
            default=float("inf"),
        )
        return [
            i
            for i in range(n)
            if i not in applied and ops[i].invoked <= floor
        ]

    stack: List[Tuple[frozenset, object]] = [(frozenset(), model.initial)]
    while stack:
        applied, state = stack.pop()
        if all(i in applied for i in completed):
            return None  # every completed op linearized: success
        key = (applied, state)
        if key in seen:
            continue
        seen.add(key)
        explored += 1
        if explored > max_states:
            return (
                f"linearizability search exceeded {max_states} states "
                f"({n} ops) — treat as failure and shrink the scenario"
            )
        for i in minimal(applied):
            op = ops[i]
            try:
                new_state, result = model.apply(state, op)
            except ValueError:
                return f"model cannot apply {op!r}"
            if op.completed and op.result is not PENDING and result != op.result:
                continue  # this linearization point contradicts the response
            stack.append((applied | {i}, new_state))
    # no order worked: report the smallest suspicious completed op set
    return (
        "history is NOT linearizable: no valid total order for "
        + "; ".join(repr(ops[i]) for i in completed[:8])
        + (" ..." if len(completed) > 8 else "")
    )


# --------------------------------------------------------------------------- #
# exactly-once effects                                                         #
# --------------------------------------------------------------------------- #
def check_exactly_once_counter(acks: Sequence[int], final_value: int) -> Optional[str]:
    """Acknowledged increment results must be exactly 1..n and the final
    counter must equal n: a retried or wire-duplicated increment that
    double-applied would produce a gap / repeat / overshoot."""
    n = len(acks)
    if sorted(acks) != list(range(1, n + 1)):
        dupes = sorted({a for a in acks if list(acks).count(a) > 1})
        return f"acks are not a permutation of 1..{n} (duplicates={dupes}, acks={sorted(acks)[:20]})"
    if final_value != n:
        return f"final counter {final_value} != {n} acknowledged increments"
    return None


# --------------------------------------------------------------------------- #
# monotone watermarks                                                          #
# --------------------------------------------------------------------------- #
class WatermarkMonitor:
    """Samples (fsn, recoverable boundary) over virtual time and checks the
    boundary is monotone within each failure epoch."""

    def __init__(self) -> None:
        self.samples: List[Tuple[float, int, Optional[Dict[str, int]]]] = []

    def sample(self, at: float, fsn: int, boundary: Optional[Dict[str, int]]) -> None:
        self.samples.append((at, fsn, dict(boundary) if boundary is not None else None))

    def check(self) -> List[str]:
        errors: List[str] = []
        prev_fsn = -1
        prev_b: Dict[str, int] = {}
        for at, fsn, boundary in self.samples:
            if fsn < prev_fsn:
                errors.append(f"t={at:.4f}: fsn went backwards {prev_fsn}->{fsn}")
            if boundary is None:  # coordinator recovering: no claim made
                prev_fsn = max(prev_fsn, fsn)
                continue
            if fsn == prev_fsn:
                for so, wm in prev_b.items():
                    if boundary.get(so, -1) < wm:
                        errors.append(
                            f"t={at:.4f}: boundary[{so}] retreated "
                            f"{wm}->{boundary.get(so, -1)} within epoch {fsn}"
                        )
            prev_fsn = max(prev_fsn, fsn)
            prev_b = boundary
        return errors


# --------------------------------------------------------------------------- #
# per-shard durable-log prefix consistency                                     #
# --------------------------------------------------------------------------- #
def _durable_decisions(base: Path) -> Tuple[int, List[dict]]:
    """The decision records a (possibly snapshot-rotated) coordinator log
    durably holds, in replay order, plus its ``retired_upto`` watermark:
    snapshot-retained decisions first, then the JSONL suffix (torn tail
    writes tolerated by ``read_durable_log``, same as recovery itself)."""
    from repro_torch.store import decode_snapshot, read_durable_log

    retired = 0
    _, blob, records = read_durable_log(base)
    out: List[dict] = []
    if blob is not None:
        snap = decode_snapshot(blob)
        retired = snap.retired_upto
        out += [{"type": "decision", **d.to_json()} for d in snap.decisions]
    out += [r for r in records if r.get("type") == "decision"]
    return retired, out


def check_shard_logs(coord_root: Path) -> List[str]:
    """Prefix-consistency of the coordinator's durable logs (module docstring).
    Works on a sharded root (``shard*.jsonl`` bases, rotated or not) or a
    singleton log path. Retirement-aware (DESIGN.md §11): a decision absent
    from a log is only an error if that log has NOT retired it — a shard
    whose compactor proved the decision dead is allowed to forget it."""
    coord_root = Path(coord_root)
    if coord_root.is_file() or coord_root.with_name(
        coord_root.name + ".manifest"
    ).exists():
        bases = [coord_root]
    else:
        # a rotated shard's base file is gone — discover via manifests too
        found = set(coord_root.glob("shard*.jsonl"))
        found |= {
            p.with_name(p.name[: -len(".manifest")])
            for p in coord_root.glob("shard*.jsonl.manifest")
        }
        bases = sorted(found)
    errors: List[str] = []
    decisions_by_log: Dict[str, Dict[int, dict]] = {}
    retired_by_log: Dict[str, int] = {}
    for base in bases:
        name = base.name
        retired_by_log[name], records = _durable_decisions(base)
        fsns: List[int] = []
        per: Dict[int, dict] = {}
        for rec in records:
            fsn = int(rec["fsn"])
            fsns.append(fsn)
            per[fsn] = rec
        for a, b in zip(fsns, fsns[1:]):
            if b <= a:
                errors.append(f"{name}: decision fsns not strictly increasing ({a} then {b})")
        decisions_by_log[name] = per
    # pairwise agreement + replication completeness at quiescence
    all_fsns = sorted({f for per in decisions_by_log.values() for f in per})
    names = sorted(decisions_by_log)
    for fsn in all_fsns:
        seen_rec: Optional[Tuple[str, dict]] = None
        for name in names:
            rec = decisions_by_log[name].get(fsn)
            if rec is None:
                if fsn > retired_by_log[name]:
                    errors.append(f"{name}: missing broadcast decision fsn={fsn}")
                continue
            if seen_rec is None:
                seen_rec = (name, rec)
            elif rec != seen_rec[1]:
                errors.append(
                    f"decision fsn={fsn} differs between {seen_rec[0]} and {name}: "
                    f"{seen_rec[1]} != {rec}"
                )
    return errors
