"""Sharded DSE coordinator (DESIGN.md §7).

The paper's coordinator is a singleton (§4.3); at cluster scale it becomes
the bottleneck — every Refresh round of every StateObject lands on it.
Netherite's answer is partitioning with a cross-partition ordering layer;
we mirror that shape: StateObjects are consistent-hashed across N
:class:`CoordinatorShard`s, each a full Coordinator with **its own durable
log** holding its members' membership records, their graph fragments, and
every rollback decision (decisions are broadcast-replicated to every
shard's log before release). An in-memory :class:`DecisionBus` merges the
per-shard state into the single global view the :class:`~repro.core.runtime.DSERuntime`
already consumes:

* **fsn allocation** — globally ordered failure sequence numbers (the bus
  allocates; replay recovers the counter as ``max`` over shard logs);
* **rollback decisions** — computed on the merged graph (a decision may
  roll back SOs on every shard), durably appended to every live shard's
  log, then released;
* **recoverable boundary** — the fixpoint of per-shard boundaries under
  exchanged watermark estimates: each round, every shard recomputes its
  local boundary treating other shards' current estimates as the durable
  watermarks of external SOs, until nothing changes. The iteration is
  monotonically decreasing from per-shard committed watermarks, so it
  terminates, and it converges to exactly the single-coordinator boundary
  on the union graph (chaotic iteration of a monotone operator).

The bus itself holds no durable state — like the paper's coordinator, its
point of truth is the collective persisted state of the shards, and a full
coordinator-service restart rebuilds it from shard logs + participant
fragment resends.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.clock import Clock, REAL_CLOCK
from ..core.coordinator import ConnectResponse, Coordinator, PollResponse
from ..core.graph import DependencyGraph
from ..core.ids import PersistReport, RollbackDecision


class HashRing:
    """Consistent-hash ring with virtual nodes. Uses md5, not ``hash()``:
    Python's string hash is per-process randomized and would re-shard every
    membership on every run."""

    def __init__(self, nodes: Sequence[object], vnodes: int = 64) -> None:
        if not nodes:
            raise ValueError("HashRing needs at least one node")
        self._ring = sorted(
            (self._h(f"{node}#{i}"), node) for node in nodes for i in range(vnodes)
        )
        self._keys = [h for h, _ in self._ring]

    @staticmethod
    def _h(s: str) -> int:
        return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")

    def lookup(self, key: str):
        i = bisect.bisect(self._keys, self._h(key)) % len(self._ring)
        return self._ring[i][1]


class CoordinatorShard(Coordinator):
    """One coordinator shard: a full Coordinator for its assigned SOs whose
    world/decision/boundary hooks defer to the shared DecisionBus."""

    def __init__(
        self,
        shard_id: int,
        log_path: Path,
        bus: "DecisionBus",
        recovery_timeout: float = 30.0,
        clock: Clock = REAL_CLOCK,
        *,
        checkpoint_records: Optional[int] = 256,
        checkpoint_bytes: int = 1 << 20,
    ) -> None:
        self.shard_id = shard_id
        self._bus = bus
        super().__init__(
            log_path,
            recovery_timeout,
            clock=clock,
            checkpoint_records=checkpoint_records,
            checkpoint_bytes=checkpoint_bytes,
        )
        bus.register_shard(self)

    # -- state the bus reads (never under this shard's lock from the bus
    #    side while a shard thread could hold it and call into the bus) --- #
    def replayed_decisions(self) -> List[RollbackDecision]:
        with self._lock:
            return list(self._decisions)

    def current_fsn(self) -> int:
        """The fsn counter this shard's durable store recovered — may exceed
        max(replayed decisions) when the snapshot retired the whole prefix."""
        with self._lock:
            return self._fsn

    def retired_upto(self) -> int:
        with self._lock:
            return self._retired_upto

    def graph_view(self) -> DependencyGraph:
        return self._graph  # DependencyGraph is internally locked

    def member_ids(self) -> List[str]:
        with self._lock:
            return list(self._members)

    def take_dirty(self) -> bool:
        with self._lock:
            d, self._dirty = self._dirty, False
            return d

    def local_boundary(self, external: Dict[str, int]) -> Dict[str, int]:
        return self._graph.recoverable_boundary(external=external)

    def watermarks(self) -> Dict[str, int]:
        return self._graph.committed_watermarks()

    def prune_to(self, boundary: Dict[str, int]) -> None:
        for so in self.member_ids():
            if so in boundary:
                self._graph.prune(so, boundary[so])

    def commit_decision(self, decision: RollbackDecision) -> None:
        """Broadcast arm: durably append a (possibly remote-origin) decision
        to this shard's log and apply its truncations to local members."""
        with self._lock:
            if decision.fsn <= self._retired_upto:
                # this shard's compactor already proved the decision can
                # never match anything again; re-appending it (a catch-up
                # from a slower shard's replay) would just regrow the log
                return
            i = bisect.bisect_left(self._decision_fsns, decision.fsn)
            if i < len(self._decision_fsns) and self._decision_fsns[i] == decision.fsn:
                return  # already committed to this shard's log
            self._log.append({"type": "decision", **decision.to_json()})
            self._note_decision(decision)
            for so, t in decision.targets.items():
                if so in self._members:
                    self._graph.truncate(so, t)
            self._dirty = True
        self._bus.mark_dirty()

    # -- snapshot + compaction (DESIGN.md §11) ----------------------------- #
    def checkpoint(self, floor: Optional[Dict[str, int]] = None) -> int:
        """Checkpoint this shard at ``floor`` — the cross-shard consistent
        cut (the bus's global exposure-floor estimate). Fetched WITHOUT the
        shard lock held when not supplied (the bus reaches across shards)."""
        if floor is None:
            floor = self._bus.global_boundary() or {}
        with self._lock:
            return self._checkpoint_locked(dict(floor))

    def maybe_checkpoint(self, floor: Dict[str, int]) -> None:
        """Auto-compaction arm, driven by the bus's boundary recompute (the
        base class's trigger rides ``_boundary_locked``, which sharded
        deployments never take — their floor lives on the bus)."""
        with self._lock:
            if self._log.should_checkpoint():
                self._checkpoint_locked(dict(floor))

    # -- merged-view hooks (called WITHOUT self._lock, see Coordinator) --- #
    def _world(self) -> int:
        return self._bus.fsn()

    def _all_decisions(self) -> List[RollbackDecision]:
        return self._bus.all_decisions()

    def _decide(self, so_id: str, surviving: int) -> RollbackDecision:
        return self._bus.decide(so_id, surviving)

    def _boundary_with_seq(self, known_seq=None):
        return self._bus.global_boundary_with_seq(known_seq)

    def _boundary(self) -> Optional[Dict[str, int]]:
        return self._bus.global_boundary()

    def poll(self, so_id: str, known_world: int, known_boundary_seq: int = -1) -> PollResponse:
        # Unlike the base class this cannot be one critical section: the
        # decision/boundary sources live on the DecisionBus and must be
        # reached WITHOUT this shard's lock held (cross-shard deadlock, see
        # the hook comment in Coordinator).
        with self._lock:
            resend = so_id in self._awaiting
        decisions = [d for d in self._all_decisions() if d.fsn > known_world]
        boundary, seq = self._boundary_with_seq(known_boundary_seq)
        return PollResponse(
            decisions=decisions,
            boundary=boundary,
            resend_fragments=resend,
            boundary_seq=seq,
        )

    def _ingest(self, reports) -> None:
        super()._ingest(reports)
        self._bus.mark_dirty()  # plain flag set: safe under self._lock


class DecisionBus:
    """Merges per-shard coordinator state into the single global view.

    Lock discipline (deadlock-freedom): ``_decide_lock`` and ``_boundary_mu``
    are only ever acquired by threads holding NO shard lock, and shard locks
    are acquired inside them one at a time. Shard threads holding their own
    lock only ever touch ``mark_dirty`` (plain attribute write) or
    ``_dlock``-guarded accessors, which never wait on shard locks.
    """

    def __init__(self, recovery_timeout: float = 30.0, clock: Clock = REAL_CLOCK) -> None:
        self._clock = clock
        self._dlock = threading.Lock()  # decisions dict + fsn + shard list
        # Held across waits / cross-shard lock acquisitions => must be
        # clock-sourced (a real lock held by a paused simulation task would
        # deadlock the cooperative scheduler, see core/clock.py).
        self._decide_lock = clock.lock()  # serializes rollback decisions
        self._boundary_mu = clock.lock()  # boundary cache
        self._shards: List[CoordinatorShard] = []
        self._decisions: Dict[int, RollbackDecision] = {}
        self._fsn = 0
        self._recovery_timeout = recovery_timeout
        self._dirty = True
        self._bcache: Dict[str, int] = {}
        #: generation of ``_bcache`` (guarded by _boundary_mu): lets shard
        #: polls answer "nothing moved" without shipping the boundary dict
        self._bseq = 0

    # -- membership ------------------------------------------------------- #
    def register_shard(self, shard: CoordinatorShard) -> None:
        # Serialize with decide(): a shard registering mid-broadcast would
        # replay its log from before the in-flight decision's append AND
        # miss it in the catch-up below (it enters self._decisions only
        # after the broadcast), silently losing the decision.
        with self._decide_lock:
            replayed = shard.replayed_decisions()
            # the shard's recovered counter can exceed its replayed decisions
            # when its snapshot retired the whole prefix (DESIGN.md §11)
            shard_fsn = shard.current_fsn()
            with self._dlock:
                self._shards = [s for s in self._shards if s.shard_id != shard.shard_id]
                self._shards.append(shard)
                self._shards.sort(key=lambda s: s.shard_id)
                for d in replayed:
                    self._decisions.setdefault(d.fsn, d)
                self._fsn = max(self._fsn, shard_fsn)
                if self._decisions:
                    self._fsn = max(self._fsn, max(self._decisions))
            # catch the shard up on decisions it missed while down (its log
            # was not part of the broadcast); commit_decision dedups by fsn.
            for d in self.all_decisions():
                shard.commit_decision(d)
            self._dirty = True

    def shards(self) -> List[CoordinatorShard]:
        with self._dlock:
            return list(self._shards)

    # -- global decision state -------------------------------------------- #
    def fsn(self) -> int:
        with self._dlock:
            return self._fsn

    def all_decisions(self) -> List[RollbackDecision]:
        with self._dlock:
            return sorted(self._decisions.values(), key=lambda d: d.fsn)

    def mark_dirty(self) -> None:
        self._dirty = True

    def decide(self, failed_so: str, surviving: int) -> RollbackDecision:
        """Global rollback decision: merged-graph fixpoint, broadcast-durable
        append to every shard's log, then release."""
        with self._decide_lock:
            self._wait_all_recovered()
            merged = DependencyGraph()
            for shard in self.shards():
                merged.merge_from(shard.graph_view())
            # pre-truncation tops: the retirement witness (see Coordinator._decide)
            tops = merged.committed_watermarks()
            merged.truncate(failed_so, surviving)
            targets = merged.rollback_targets(failed_so, surviving)
            with self._dlock:
                fsn = self._fsn + 1
                self._fsn = fsn
            decision = RollbackDecision(
                fsn=fsn,
                failed=failed_so,
                targets=targets,
                lost={so: tops.get(so, t) for so, t in targets.items()},
            )
            for shard in self.shards():
                shard.commit_decision(decision)
            with self._dlock:
                self._decisions[fsn] = decision
            self._dirty = True
            return decision

    def _wait_all_recovered(self) -> None:
        """A decision on an incomplete global view would erase innocent
        members of a recovering shard; wait for every shard's fragments."""
        deadline = self._clock.now() + self._recovery_timeout
        while any(s.is_awaiting for s in self.shards()):
            if self._clock.now() > deadline:
                stalled = [s.shard_id for s in self.shards() if s.is_awaiting]
                raise TimeoutError(
                    f"decision stalled; shards {stalled} still collecting fragments"
                )
            self._clock.sleep(0.002)

    # -- global boundary --------------------------------------------------- #
    def global_boundary_with_seq(
        self, known_seq: Optional[int] = None
    ) -> Tuple[Optional[Dict[str, int]], int]:
        shards = self.shards()
        if any(s.is_awaiting for s in shards):
            # some shard's view is incomplete: refuse, like §4.3
            with self._boundary_mu:
                return None, self._bseq
        with self._boundary_mu:
            dirty = self._dirty
            self._dirty = False
            for s in shards:
                dirty = s.take_dirty() or dirty
            if dirty:
                est: Dict[str, int] = {}
                for s in shards:
                    est.update(s.watermarks())
                changed = True
                while changed:
                    changed = False
                    for s in shards:
                        for so, w in s.local_boundary(est).items():
                            if w < est.get(so, -1):
                                est[so] = w
                                changed = True
                if est != self._bcache:
                    self._bcache = est
                    self._bseq += 1
                for s in shards:
                    s.prune_to(est)
                    # auto-compaction: same thread that prunes (holds no
                    # shard lock), same consistent cross-shard cut
                    s.maybe_checkpoint(est)
                # a decision every shard's compactor retired is globally
                # dead — drop it from the volatile union too, so Connect
                # responses ship O(retained) decisions
                retired = min((s.retired_upto() for s in shards), default=0)
                if retired:
                    with self._dlock:
                        for fsn in [f for f in self._decisions if f <= retired]:
                            del self._decisions[fsn]
            if known_seq == self._bseq:
                return None, self._bseq  # nothing moved: no dict shipped
            return dict(self._bcache), self._bseq

    def global_boundary(self) -> Optional[Dict[str, int]]:
        return self.global_boundary_with_seq()[0]


class ShardedCoordinator:
    """Drop-in replacement for :class:`~repro.core.coordinator.Coordinator`
    that consistent-hashes StateObjects across N shards. Implements the same
    participant API (connect / report / receive_fragments / poll), so
    ``DSERuntime`` is oblivious to the sharding."""

    def __init__(
        self,
        root: Path,
        n_shards: int = 2,
        *,
        recovery_timeout: float = 30.0,
        vnodes: int = 64,
        clock: Clock = REAL_CLOCK,
        checkpoint_records: Optional[int] = 256,
        checkpoint_bytes: int = 1 << 20,
    ) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.n_shards = n_shards
        self._recovery_timeout = recovery_timeout
        self.clock = clock
        self._store_kw = dict(
            checkpoint_records=checkpoint_records, checkpoint_bytes=checkpoint_bytes
        )
        self.ring = HashRing(list(range(n_shards)), vnodes=vnodes)
        self.bus = DecisionBus(recovery_timeout, clock=clock)
        self.shards: List[CoordinatorShard] = [
            CoordinatorShard(
                i,
                self.root / f"shard{i}.jsonl",
                self.bus,
                recovery_timeout,
                clock=clock,
                **self._store_kw,
            )
            for i in range(n_shards)
        ]

    # -- placement -------------------------------------------------------- #
    def shard_index(self, so_id: str) -> int:
        return self.ring.lookup(so_id)

    def shard_for(self, so_id: str) -> CoordinatorShard:
        return self.shards[self.shard_index(so_id)]

    # -- participant API (Coordinator-compatible) -------------------------- #
    def connect(self, so_id: str, fragments: Sequence[PersistReport]) -> ConnectResponse:
        return self.shard_for(so_id).connect(so_id, fragments)

    def report(self, so_id: str, reports: Sequence[PersistReport]):
        # pass the admission ack (rejected-vertex list) through: a durable
        # runtime on this handle must not mistake "dropped" for "admitted"
        return self.shard_for(so_id).report(so_id, reports)

    def receive_fragments(self, so_id: str, fragments: Sequence[PersistReport]) -> None:
        self.shard_for(so_id).receive_fragments(so_id, fragments)

    def poll(self, so_id: str, known_world: int, known_boundary_seq: int = -1) -> PollResponse:
        return self.shard_for(so_id).poll(so_id, known_world, known_boundary_seq)

    # -- failure injection -------------------------------------------------- #
    def restart_shard(self, idx: int) -> CoordinatorShard:
        """Crash-restart one shard: the replacement replays the shard log and
        refuses to contribute to the global boundary until every one of its
        members has resent fragments (scale-out version of §4.3 recovery)."""
        old = self.shards[idx]
        # Build + register the replacement BEFORE closing the old shard: the
        # bus's shard list must never expose a closed log to a concurrent
        # decision broadcast (register_shard atomically swaps by shard_id).
        self.shards[idx] = CoordinatorShard(
            idx,
            self.root / f"shard{idx}.jsonl",
            self.bus,
            self._recovery_timeout,
            clock=self.clock,
            **self._store_kw,
        )
        old.close()
        return self.shards[idx]

    # -- snapshot + compaction (DESIGN.md §11) ------------------------------- #
    def checkpoint(self) -> List[int]:
        """Checkpoint every shard at one consistent cross-shard cut — the
        bus's current exposure-floor estimate (None while any shard is
        collecting fragments => an empty floor: still rotates, retires
        nothing). Returns the new generation per shard."""
        floor = self.bus.global_boundary() or {}
        return [s.checkpoint(floor) for s in self.shards]

    # -- introspection / lifecycle ------------------------------------------ #
    def current_boundary(self) -> Optional[Dict[str, int]]:
        return self.bus.global_boundary()

    def stats(self) -> Dict[str, object]:
        per_shard = {s.shard_id: s.stats() for s in self.shards}  # one lock trip each
        return {
            "members": sorted(m for st in per_shard.values() for m in st["members"]),
            "fsn": self.bus.fsn(),
            "decisions": len(self.bus.all_decisions()),
            "shards": self.n_shards,
            "per_shard_members": {sid: st["members"] for sid, st in per_shard.items()},
            "awaiting": sorted(
                so for st in per_shard.values() for so in st["awaiting"]
            ),
            "checkpoints": sum(s.checkpoints for s in self.shards),
            # durable store generations survive shard restarts (manifest),
            # unlike the per-object ``checkpoints`` counters
            "log_generations": {sid: st["log_generation"] for sid, st in per_shard.items()},
        }

    def close(self) -> None:
        for s in self.shards:
            s.close()
