"""Seeded fault schedules (DESIGN.md §8): the ``FaultPlan`` DSL.

A plan is an explicit, serialisable list of timed fault events — crash or
restart a StateObject, restart a coordinator shard or the whole coordinator
service, partition/heal endpoint groups, and degrade links or whole
*message classes* (all ``report`` traffic, say) with loss / duplication /
delay. ``FaultPlan.random(seed, ...)`` derives an entire schedule from one
seed, so a failing run is reproducible from ``(scenario, seed)`` alone, and
``sim/explore.py`` shrinks a failing plan to a minimal repro by deleting
events and re-running.

Plans always end with a *healing epilogue* (heal + clear link overrides) so
every scenario's settle phase sees a clean fabric — liveness assertions
then check convergence, not luck.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

#: faults that lose volatile state (trigger rollback recovery)
STATE_LOSING = ("crash",)
#: faults that only degrade the fabric / control plane
BENIGN = (
    "partition",
    "heal",
    "link",
    "method_link",
    "clear_method_link",
    "restart_shard",
    "restart_coordinator",
    "checkpoint",
)

_METHOD_CLASSES = ("report", "poll", "receive_fragments", "increment", "put", "get")


@dataclass
class FaultEvent:
    at: float  # virtual seconds from scenario start
    kind: str
    arg: Dict[str, object] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"at": self.at, "kind": self.kind, "arg": self.arg}

    @staticmethod
    def from_json(obj: dict) -> "FaultEvent":
        return FaultEvent(at=float(obj["at"]), kind=str(obj["kind"]), arg=dict(obj.get("arg", {})))

    def __repr__(self) -> str:
        return f"@{self.at:.3f}s {self.kind}({self.arg})"


@dataclass
class FaultPlan:
    events: List[FaultEvent] = field(default_factory=list)

    # -- builder DSL ------------------------------------------------------- #
    def crash(self, at: float, so_id: str, restart: bool = True) -> "FaultPlan":
        self.events.append(FaultEvent(at, "crash", {"so_id": so_id, "restart": restart}))
        return self

    def restart_shard(self, at: float, idx: int) -> "FaultPlan":
        self.events.append(FaultEvent(at, "restart_shard", {"idx": idx}))
        return self

    def restart_coordinator(self, at: float) -> "FaultPlan":
        self.events.append(FaultEvent(at, "restart_coordinator", {}))
        return self

    def checkpoint(self, at: float) -> "FaultPlan":
        """Snapshot-compact the coordinator's durable store (DESIGN.md §11)
        — not a fault, but scheduled like one so compaction lands at
        adversarial moments relative to crashes and restarts. A no-op on
        clusters built with compaction disabled (the snapshot-vs-replay
        differential runs the same plan on both)."""
        self.events.append(FaultEvent(at, "checkpoint", {}))
        return self

    def partition(self, at: float, *groups: Sequence[str]) -> "FaultPlan":
        self.events.append(
            FaultEvent(at, "partition", {"groups": [sorted(g) for g in groups]})
        )
        return self

    def heal(self, at: float) -> "FaultPlan":
        self.events.append(FaultEvent(at, "heal", {}))
        return self

    def link(self, at: float, src: str, dst: str, **spec) -> "FaultPlan":
        self.events.append(FaultEvent(at, "link", {"src": src, "dst": dst, "spec": spec}))
        return self

    def method_link(self, at: float, method: str, **spec) -> "FaultPlan":
        self.events.append(
            FaultEvent(at, "method_link", {"method": method, "spec": spec})
        )
        return self

    def clear_method_link(self, at: float, method: str) -> "FaultPlan":
        self.events.append(FaultEvent(at, "clear_method_link", {"method": method}))
        return self

    # -- introspection ------------------------------------------------------ #
    def sorted_events(self) -> List[FaultEvent]:
        return sorted(self.events, key=lambda e: (e.at, e.kind))

    def loses_state(self) -> bool:
        return any(e.kind in STATE_LOSING for e in self.events)

    # -- serialisation (explore.py artifacts, scenario files) --------------- #
    def to_json(self) -> list:
        return [e.to_json() for e in self.sorted_events()]

    @staticmethod
    def from_json(obj: list) -> "FaultPlan":
        return FaultPlan([FaultEvent.from_json(e) for e in obj])

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2)

    @staticmethod
    def loads(text: str) -> "FaultPlan":
        return FaultPlan.from_json(json.loads(text))

    def without(self, indices: Sequence[int]) -> "FaultPlan":
        """A copy with the events at ``indices`` (into sorted_events) removed
        — the shrinking primitive."""
        drop = set(indices)
        return FaultPlan(
            [e for i, e in enumerate(self.sorted_events()) if i not in drop]
        )

    # -- generation --------------------------------------------------------- #
    @staticmethod
    def random(
        seed: int,
        *,
        so_ids: Sequence[str],
        horizon: float,
        n_shards: int = 0,
        endpoints: Optional[Sequence[str]] = None,
        allow_crash: bool = False,
        allow_coordinator_restart: bool = True,
        max_events: int = 6,
        max_loss: float = 0.3,
    ) -> "FaultPlan":
        """Derive a whole schedule from one seed. By default only *benign*
        faults (nothing that loses application state) so linearizability
        holds unconditionally; ``allow_crash=True`` adds crash-restarts for
        scenarios that assert the recovery invariants instead."""
        rng = random.Random(seed)
        plan = FaultPlan()
        kinds: List[str] = ["link", "method_link", "partition"]
        if n_shards:
            kinds.append("restart_shard")
        elif allow_coordinator_restart:
            kinds.append("restart_coordinator")
        if allow_crash:
            kinds += ["crash", "crash"]  # weight crashes up when allowed
        eps = list(endpoints or [f"so/{s}" for s in so_ids])
        coord_eps = (
            [f"coord/{i}" for i in range(n_shards)] if n_shards else ["coord"]
        )
        n = rng.randint(1, max_events)
        for _ in range(n):
            at = rng.uniform(0.05, horizon * 0.8)
            kind = rng.choice(kinds)
            if kind == "crash":
                plan.crash(at, rng.choice(list(so_ids)))
            elif kind == "restart_shard":
                plan.restart_shard(at, rng.randrange(n_shards))
            elif kind == "restart_coordinator":
                plan.restart_coordinator(at)
            elif kind == "partition":
                # cut either the coordinator or one service endpoint off,
                # then heal within the horizon
                victim = (
                    set(coord_eps) if rng.random() < 0.5 else {rng.choice(eps)}
                )
                plan.partition(at, victim)
                plan.heal(min(horizon, at + rng.uniform(0.05, horizon * 0.25)))
            elif kind == "link":
                src = rng.choice(["*"] + eps)
                dst = rng.choice(eps + coord_eps)
                plan.link(
                    at,
                    src,
                    dst,
                    latency_ms=rng.uniform(0, 2.0),
                    jitter_ms=rng.uniform(0, 1.0),
                    loss_prob=rng.uniform(0, max_loss),
                    dup_prob=rng.uniform(0, 0.3),
                    reorder_prob=rng.uniform(0, 0.3),
                )
                plan.link(min(horizon, at + rng.uniform(0.1, horizon * 0.4)), src, dst)
            else:  # method_link
                m = rng.choice(_METHOD_CLASSES)
                plan.method_link(
                    at,
                    m,
                    latency_ms=rng.uniform(0, 2.0),
                    loss_prob=rng.uniform(0, max_loss),
                    dup_prob=rng.uniform(0, 0.4),
                )
                plan.clear_method_link(
                    min(horizon, at + rng.uniform(0.1, horizon * 0.4)), m
                )
        # healing epilogue: the settle phase always sees a clean fabric
        plan.heal(horizon)
        for m in _METHOD_CLASSES:
            plan.clear_method_link(horizon, m)
        return plan
