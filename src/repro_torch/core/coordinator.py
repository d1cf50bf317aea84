"""Stateless libDSE coordinator (paper §4.3).

The coordinator's *point of truth is the collective persisted state of the
participants*: dependency-graph fragments are persisted inside each
StateObject (via the ``metadata`` argument of ``Persist``) and reported
asynchronously, so the coordinator holds only a (possibly stale) **view**
of the real graph. Nothing is persisted by the coordinator on the
failure-free path — its log records only *membership changes* and
*rollback decisions* (which must be durable before release, as they embody
cluster consensus).

Soundness of the stale view (paper §4.3, Finding Boundaries): the
persistent part of the graph is immutable — future operations add vertices
but never change past dependencies — so any recoverable boundary found on
the coordinator's present view remains recoverable on every later view.
Rollback targets computed on the stale view are *conservative*: a persisted
vertex the coordinator has not yet seen is above its owner's target and is
therefore rolled back (paper §5.3 acknowledges this over-rollback; the
StateObject-side skip mitigation in ``DSERuntime._apply_decision`` recovers
the common case).

Coordinator recovery (paper §4.3): a restarted coordinator replays its
durable store to recover membership + past decisions, then asks every
participant to resend its locally persisted graph fragments; it refuses to
answer boundary queries (returns ``None``) until every participant has
responded, which guarantees a view at least as fresh as the pre-failure one.

Bounded recovery (DESIGN.md §11): the durable store is a
:class:`~repro.store.CompactingLog` — ``checkpoint()`` folds the current
durable cut (graph at the exposure floor, non-retired decisions, world
counter, per-SO flush seqs) into a binary snapshot and rotates the JSONL
log to a suffix, so replay is O(live state + suffix) instead of O(every
record since the cluster was born), and fully-superseded decisions (whose
lost windows every exposure floor has passed) retire from the durable cut,
the in-memory lists, and every future ConnectResponse.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .clock import Clock, REAL_CLOCK
from .graph import DependencyGraph
from .ids import DecisionIndex, PersistReport, RollbackDecision, Vertex
from ..store import CompactingLog, CoordinatorSnapshot, decode_snapshot, encode_snapshot


@dataclass
class ConnectResponse:
    world: int
    decisions: List[RollbackDecision]
    boundary: Optional[Dict[str, int]]
    #: version the connecting incarnation must Restore to; None => fresh start
    restore_to: Optional[int] = None
    #: generation of ``boundary`` — quote back via ``poll(known_boundary_seq=)``
    boundary_seq: int = -1


@dataclass
class PollResponse:
    decisions: List[RollbackDecision] = field(default_factory=list)
    #: None when the view is incomplete (recovery) OR when the caller's
    #: ``known_boundary_seq`` is current — nothing moved, no dict shipped.
    boundary: Optional[Dict[str, int]] = None
    resend_fragments: bool = False
    #: generation counter for delta polls; -1 from pre-seq coordinators
    boundary_seq: int = -1


class Coordinator:
    """Embodies cluster consensus as the (singleton) leader (paper §4.2)."""

    def __init__(
        self,
        log_path: Path,
        recovery_timeout: float = 30.0,
        clock: Clock = REAL_CLOCK,
        *,
        checkpoint_records: Optional[int] = 256,
        checkpoint_bytes: int = 1 << 20,
    ) -> None:
        self.clock = clock
        self._lock = clock.rlock()
        self._recovered_cv = clock.condition(self._lock)
        #: durable store: snapshot + JSONL suffix; the thresholds arm the
        #: auto-compaction trigger (None disables checkpoints entirely).
        self._log = CompactingLog(
            log_path,
            checkpoint_records=checkpoint_records,
            checkpoint_bytes=checkpoint_bytes,
        )
        self._graph = DependencyGraph()
        self._members: Set[str] = set()
        #: decisions sorted by fsn, with a parallel fsn list (bisect) and a
        #: compacted per-SO invalidation index (O(log n) classification)
        self._decisions: List[RollbackDecision] = []
        self._decision_fsns: List[int] = []
        self._dindex = DecisionIndex()
        self._fsn = 0
        #: decisions with fsn <= this were retired by the compactor: every
        #: exposure floor passed their lost windows, so nothing they could
        #: invalidate can ever be reported, resent, or adopted again — and
        #: every live (or future) incarnation's world is already past them.
        self._retired_upto = 0
        #: the exposure floor of the last installed (or recovered) snapshot —
        #: the fallback cut for a checkpoint taken before a live floor exists
        self._snapshot_floor: Dict[str, int] = {}
        self.checkpoints = 0
        self._recovery_timeout = recovery_timeout
        #: so_id -> set of (world, seq) report flushes already processed:
        #: drops the duplicate when a transport retry of a timed-out report
        #: RPC lands after the runtime's requeue path already resent it.
        #: Part of the snapshot's durable cut, so a snapshot-recovered
        #: coordinator still single-counts a pre-crash flush's retry (a
        #: suffix-era duplicate merely re-ingests, which is idempotent).
        self._report_seen: Dict[str, Set[Tuple[int, int]]] = {}
        self.dup_reports_dropped = 0

        # Recover the durable cut, then replay the suffix: membership +
        # decisions (suffix decisions must also re-apply their truncations,
        # because the snapshot's graph predates them).
        snap_blob, suffix = self._log.replay()
        restored = snap_blob is not None
        if restored:
            snap = decode_snapshot(snap_blob)
            self._fsn = snap.fsn
            self._retired_upto = snap.retired_upto
            self._members = set(snap.members)
            for d in snap.decisions:
                self._note_decision(d)
            self._graph.restore_state(snap.graph)
            self._snapshot_floor = dict(snap.floor)
            self._report_seen = {so: set(pairs) for so, pairs in snap.report_seen.items()}
        for rec in suffix:
            if rec.get("type") == "member":
                self._members.add(rec["so_id"])
            elif rec.get("type") == "decision":
                d = RollbackDecision.from_json(rec)
                self._note_decision(d)
                if restored:
                    for so, t in d.targets.items():
                        self._graph.truncate(so, t)
        # If members existed, this is a restarted coordinator: the graph view
        # must be rebuilt from participants before boundaries can be served
        # (the snapshot is the warm O(live) base; resends are the freshness
        # guarantee and, post-GC, ship only the O(live) suffix).
        self._awaiting: Set[str] = set(self._members)
        #: lock-free mirror of ``bool(self._awaiting)`` (read by the sharded
        #: DecisionBus without taking this coordinator's lock).
        self.is_awaiting = bool(self._awaiting)
        for so in self._members:
            self._graph.add_member(so)

        self._dirty = True
        self._boundary_cache: Dict[str, int] = {}
        #: generation of ``_boundary_cache``; bumped on every actual change so
        #: steady-state polls are answered "nothing moved" without a rebuild
        self._boundary_seq = 0
        #: last graph change-counter folded into the cache
        self._graph_version = -1

    # ------------------------------------------------------------------ #
    # helpers                                                            #
    # ------------------------------------------------------------------ #
    def _note_decision(self, d: RollbackDecision) -> None:
        """Record a decision in the fsn-sorted list + compacted index
        (call with self._lock held, or from __init__)."""
        i = bisect.bisect_left(self._decision_fsns, d.fsn)
        if i < len(self._decision_fsns) and self._decision_fsns[i] == d.fsn:
            return  # replayed duplicate
        self._decision_fsns.insert(i, d.fsn)
        self._decisions.insert(i, d)
        self._dindex.add(d)
        self._fsn = max(self._fsn, d.fsn)

    def _decisions_after(self, known_world: int) -> List[RollbackDecision]:
        """Decisions with fsn > known_world — O(log n + delta), not a scan
        (call with self._lock held)."""
        i = bisect.bisect_right(self._decision_fsns, known_world)
        return self._decisions[i:]

    def _ingest(self, reports: Iterable[PersistReport]) -> None:
        """Incorporate persisted-vertex reports, dropping any vertex an
        existing decision has already invalidated (stale blobs / in-flight
        reports from a pre-rollback incarnation)."""
        for r in reports:
            if self._dindex.invalidates(r.vertex):
                continue
            deps = [(d.so_id, d.version) for d in r.deps if d.so_id != r.vertex.so_id]
            self._graph.report_persistent(r.vertex.so_id, r.vertex.version, deps)
            self._dirty = True

    def _boundary_locked(
        self, known_seq: Optional[int] = None
    ) -> Tuple[Optional[Dict[str, int]], int]:
        """(boundary, seq) — None while the view is incomplete (coordinator
        recovery in progress), or when the caller already holds generation
        ``known_seq`` (delta poll: nothing moved, don't even copy the dict).
        Call with self._lock held."""
        if self._awaiting:
            return None, self._boundary_seq
        if self._dirty:
            self._dirty = False
            ver = self._graph.boundary_version()
            if ver != self._graph_version:
                ver, bound = self._graph.incremental_boundary()
                self._graph_version = ver
                if bound != self._boundary_cache:
                    self._boundary_cache = bound
                    self._boundary_seq += 1
                    # Vertices inside the boundary are immortal: prune their
                    # dep lists, keeping only the floor watermark (memory
                    # bound).
                    for so, b in bound.items():
                        self._graph.prune(so, b)
        # Auto-compaction rides the boundary recompute: the floor is fresh
        # here, the lock is held, and log growth (decisions/members) always
        # marks the boundary dirty, so the trigger is visited promptly.
        if self._log.should_checkpoint():
            self._checkpoint_locked(dict(self._boundary_cache))
        if known_seq == self._boundary_seq:
            return None, self._boundary_seq
        return dict(self._boundary_cache), self._boundary_seq

    # Overridden by CoordinatorShard to defer to the DecisionBus (and then
    # called WITHOUT self._lock, like the other merged-view hooks below).
    def _boundary_with_seq(
        self, known_seq: Optional[int] = None
    ) -> Tuple[Optional[Dict[str, int]], int]:
        with self._lock:
            return self._boundary_locked(known_seq)

    def _boundary(self) -> Optional[Dict[str, int]]:
        return self._boundary_with_seq()[0]

    def _awaiting_changed(self) -> None:
        self.is_awaiting = bool(self._awaiting)

    # Hooks a sharded deployment overrides to merge per-shard state into the
    # single global view (repro.net.sharded.CoordinatorShard). They must be
    # called WITHOUT self._lock held: the sharded variants reach across
    # shards, and holding one shard's lock while acquiring another's would
    # deadlock under concurrent failures.
    def _world(self) -> int:
        with self._lock:
            return self._fsn

    def _all_decisions(self) -> List[RollbackDecision]:
        with self._lock:
            return list(self._decisions)

    def _decide(self, so_id: str, surviving: int) -> RollbackDecision:
        """Compute, durably log, and apply a rollback decision."""
        with self._lock:
            # Top persisted label per SO BEFORE any truncation: every vertex
            # this decision can ever invalidate lies in (target, lost[so]] —
            # the retirement witness the snapshot compactor checks floors
            # against (DESIGN.md §11).
            tops = self._graph.committed_watermarks()
            # Remove the failed SO's lost vertices, then find the greatest
            # closure of what remains (iteratively removing dangling refs).
            self._graph.truncate(so_id, surviving)
            targets = self._graph.rollback_targets(so_id, surviving)
            fsn = self._fsn + 1
            decision = RollbackDecision(
                fsn=fsn,
                failed=so_id,
                targets=targets,
                lost={so: tops.get(so, t) for so, t in targets.items()},
            )
            # Consensus step: the decision must be durable before any
            # participant can observe it (paper §4.3, Orchestrating Rollback).
            self._log.append({"type": "decision", **decision.to_json()})
            self._note_decision(decision)
            for so, t in targets.items():
                self._graph.truncate(so, t)
            self._dirty = True
            return decision

    def _wait_recovered(self, exclude: Set[str]) -> None:
        deadline = self.clock.now() + self._recovery_timeout
        while self._awaiting - exclude:
            remaining = deadline - self.clock.now()
            if remaining <= 0:
                raise TimeoutError(
                    f"coordinator recovery stalled; awaiting fragments from "
                    f"{sorted(self._awaiting - exclude)}"
                )
            self._recovered_cv.wait(timeout=min(remaining, 0.05))

    # ------------------------------------------------------------------ #
    # participant API                                                    #
    # ------------------------------------------------------------------ #
    def connect(self, so_id: str, fragments: Sequence[PersistReport]) -> ConnectResponse:
        """Register ``so_id`` as the legitimate incarnation (paper §5.1).

        A connect from an already-registered member indicates a failure and
        triggers the Recovery Protocol: compute the consistent surviving
        prefix, durably log the decision, and release it to the cluster.
        """
        with self._lock:
            self._ingest(fragments)
            is_failure = so_id in self._members
            if is_failure:
                self._awaiting.discard(so_id)  # its fragments just arrived in full
                self._awaiting_changed()
                self._recovered_cv.notify_all()
            else:
                self._log.append({"type": "member", "so_id": so_id})
                self._members.add(so_id)
                self._graph.add_member(so_id)

        if is_failure:
            # -- failure path ---------------------------------------------------
            # Rollback targets on an incomplete view would erase innocent
            # members; wait until every other participant has resent.
            with self._lock:
                self._wait_recovered(exclude={so_id})
            # Snapshot decisions only AFTER the wait: a decision landing
            # during the (up to recovery_timeout) window must filter `valid`.
            decisions = self._all_decisions()
            idx = DecisionIndex(decisions)
            valid = [
                r.vertex.version
                for r in fragments
                if r.vertex.so_id == so_id and not idx.invalidates(r.vertex)
            ]
            surviving = max(valid, default=-1)
            decision = self._decide(so_id, surviving)
            restore_to = decision.targets.get(so_id, -1)
            restore_to = restore_to if restore_to >= 0 else None
            # world must be OUR decision's fsn, not a fresh read: a decision
            # concurrent with the post-_decide window would otherwise ship as
            # world while restore_to predates it — the runtime would set
            # world past its fsn and never apply it. Later decisions in the
            # (fresh) decision list are applied via poll, which is safe.
            boundary, bseq = self._boundary_with_seq()
            return ConnectResponse(
                world=decision.fsn,
                decisions=self._all_decisions(),
                boundary=boundary,
                restore_to=restore_to,
                boundary_seq=bseq,
            )

        # -- first connect ------------------------------------------------------
        # Read world BEFORE decisions: a decision landing between the two
        # reads is then included in `decisions` (filtering `valid`) while
        # `world` predates it, so the runtime still applies it via poll.
        # The unsafe order (fresh world, stale decisions) could adopt a
        # version that decision just invalidated, with world already past
        # its fsn — never applied, permanently wrong state.
        world = self._world()
        decisions = self._all_decisions()
        idx = DecisionIndex(decisions)
        valid = [
            r.vertex.version
            for r in fragments
            if r.vertex.so_id == so_id and not idx.invalidates(r.vertex)
        ]
        # Adoption: an unknown member with durable state (e.g. a fresh
        # coordinator log) resumes from its own latest valid version.
        restore_to = max(valid) if valid else None
        boundary, bseq = self._boundary_with_seq()
        return ConnectResponse(
            world=world,
            decisions=decisions,
            boundary=boundary,
            restore_to=restore_to,
            boundary_seq=bseq,
        )

    def _dedup_reports(
        self, so_id: str, reports: Sequence[PersistReport]
    ) -> List[PersistReport]:
        """Drop reports whose (world, seq) this coordinator already processed
        for ``so_id`` (call with self._lock held). seq=-1 (connect/fragment
        resends rebuilt from disk) is never deduped — full resends must
        always be ingestible."""
        seen = self._report_seen.setdefault(so_id, set())
        out: List[PersistReport] = []
        for r in reports:
            if r.seq >= 0:
                key = (r.vertex.world, r.seq)
                if key in seen:
                    self.dup_reports_dropped += 1
                    continue
                seen.add(key)
            out.append(r)
        if len(seen) > 16384:
            # memory bound: seqs are per-incarnation monotone, so within one
            # world anything far below that world's max can only be a
            # long-stale duplicate whose re-ingest is harmless (graph
            # ingestion is idempotent). The floor is per-world: a restarted
            # incarnation begins a new world at seq 0, and a global floor
            # would erase its live window.
            max_by_world: Dict[int, int] = {}
            for w, s in seen:
                if s > max_by_world.get(w, -1):
                    max_by_world[w] = s
            self._report_seen[so_id] = {
                (w, s) for (w, s) in seen if s >= max_by_world[w] - 8192
            }
        return out

    def report(self, so_id: str, reports: Sequence[PersistReport]) -> List[Vertex]:
        """Ingest persisted-vertex reports; returns the vertices a rollback
        decision has already invalidated (``_ingest`` drops them silently).
        A successful return is therefore an *admission* ack for everything
        not listed — the durable baseline blocks exposure on it, so it must
        not mistake "delivered but dropped" for "inside the view" (an
        invalidated-at-ingest vertex is above its owner's rollback target
        and WILL be rolled back when the decision reaches the runtime)."""
        with self._lock:
            self._ingest(self._dedup_reports(so_id, reports))
            # evaluated over the full incoming batch (including seq-deduped
            # duplicates): admission is a function of the decision set, so a
            # retried flush gets the same verdict its lost ack carried.
            return [r.vertex for r in reports if self._dindex.invalidates(r.vertex)]

    def receive_fragments(self, so_id: str, fragments: Sequence[PersistReport]) -> None:
        """Full fragment resend during coordinator recovery."""
        with self._lock:
            self._ingest(fragments)
            self._awaiting.discard(so_id)
            self._awaiting_changed()
            self._recovered_cv.notify_all()
            self._dirty = True

    def poll(self, so_id: str, known_world: int, known_boundary_seq: int = -1) -> PollResponse:
        # One critical section for resend-check + decision delta + boundary
        # (the seed took the lock three times per poll). CoordinatorShard
        # overrides this with the hook-based variant: its decision/boundary
        # sources live on the DecisionBus and must be reached without the
        # shard lock held (cross-shard deadlock, see the hook comment above).
        with self._lock:
            resend = so_id in self._awaiting
            decisions = self._decisions_after(known_world)
            boundary, seq = self._boundary_locked(known_boundary_seq)
        return PollResponse(
            decisions=decisions,
            boundary=boundary,
            resend_fragments=resend,
            boundary_seq=seq,
        )

    # ------------------------------------------------------------------ #
    # snapshot + compaction (repro.store, DESIGN.md §11)                 #
    # ------------------------------------------------------------------ #
    def checkpoint(self) -> int:
        """Fold the current durable cut into a snapshot and rotate the log;
        returns the new store generation. Safe at any time — the cut is
        taken under the lock, and a crash mid-checkpoint recovers from
        whichever generation the manifest names."""
        with self._lock:
            # freshen the floor first (no-op while the view is incomplete:
            # an empty floor just means nothing retires this round). This
            # may itself fire the auto-compaction trigger — don't snapshot
            # the same cut twice back-to-back if it did.
            gen = self._log.generation
            self._boundary_locked()
            if self._log.generation != gen:
                return self._log.generation
            return self._checkpoint_locked(dict(self._boundary_cache))

    def _retire_decisions_locked(self, floor: Dict[str, int]) -> None:
        """Drop the longest decision prefix whose lost windows every target
        floor has passed (call with self._lock held).

        Soundness (DESIGN.md §11): ``floor[so] > lost[so]`` for a target
        means every vertex the decision could still invalidate is strictly
        below ``so``'s exposure floor — already GC'd from (or about to be
        GC'd from) its fragment store, never resent, never adoptable — and,
        because post-decision reports at the old world are themselves
        invalidated, the floor can only have passed the lost window after
        ``so`` applied the decision, so every live incarnation's world is
        past its fsn and no poll delta can ever need it. Retirement is
        prefix-only so the durable cut records a single ``retired_upto``.
        """
        i = 0
        while i < len(self._decisions):
            d = self._decisions[i]
            if not d.lost or not all(
                floor.get(so, -1) > d.lost.get(so, t) for so, t in d.targets.items()
            ):
                break
            i += 1
        if i:
            self._retired_upto = self._decisions[i - 1].fsn
            del self._decisions[:i]
            del self._decision_fsns[:i]
            self._dindex = DecisionIndex(self._decisions)

    def _checkpoint_locked(self, floor: Dict[str, int]) -> int:
        if self._log.checkpoint_records is None:
            # compaction disabled: no snapshot may be installed, and the
            # in-memory decision list must then match the durable log —
            # don't retire either (the log owns the same contract; this
            # guard just keeps retirement/stats consistent with it)
            return self._log.generation
        if not floor:
            # no live floor (e.g. checkpoint requested right after a restart,
            # before fragment resends complete): fall back to the previous
            # snapshot's floor. Sound because exposure floors never retreat
            # (rollback targets are >= every exposed floor), so the old cut
            # is a valid lower bound and retirement stays conservative.
            floor = dict(self._snapshot_floor)
        self._retire_decisions_locked(floor)
        self._snapshot_floor = dict(floor)
        blob = encode_snapshot(
            CoordinatorSnapshot(
                fsn=self._fsn,
                retired_upto=self._retired_upto,
                members=sorted(self._members),
                decisions=list(self._decisions),
                graph=self._graph.export_state(),
                floor=floor,
                report_seen={so: set(s) for so, s in self._report_seen.items() if s},
            )
        )
        gen = self._log.checkpoint(blob)
        self.checkpoints += 1
        return gen

    # ------------------------------------------------------------------ #
    # introspection                                                      #
    # ------------------------------------------------------------------ #
    def current_boundary(self) -> Optional[Dict[str, int]]:
        return self._boundary()

    def stats(self) -> Dict[str, object]:
        with self._lock:
            _, vertices = self._graph.size()  # counters, not a deep copy
            return {
                "members": sorted(self._members),
                "fsn": self._fsn,
                "decisions": len(self._decisions),
                "retired_upto": self._retired_upto,
                "graph_vertices": vertices,
                "awaiting": sorted(self._awaiting),
                "dup_reports_dropped": self.dup_reports_dropped,
                "checkpoints": self.checkpoints,
                "log_generation": self._log.generation,
                "log_records": self._log.records_since_checkpoint,
            }

    def close(self) -> None:
        self._log.close()
