"""DSERuntime — per-StateObject speculative execution engine (paper §4, §5.1).

Responsibilities (paper §3): (1) persist / recover / roll back the
StateObject by invoking developer-supplied methods, (2) instrument message
headers to establish dependencies, discard rolled-back messages and delay
cross-epoch messages, (3) protect developer state access via epoch-protected
actions.

Commit ordering (Def 4.1) is enforced by *version relabeling*: receiving a
dependency with watermark ``n`` bumps the in-progress version label to
``max(v_cur, n)`` instead of blocking for local persistence (see DESIGN.md
§2 for the equivalence argument; labels are monotonic watermarks and
persisted-label gaps are allowed). ``strict_commit_ordering=True`` restores
the paper's literal blocking behaviour.
"""
from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, TYPE_CHECKING

from .clock import Clock, REAL_CLOCK
from .ids import (
    DecisionIndex,
    Header,
    PersistReport,
    RollbackDecision,
    Vertex,
    decode_metadata,
    encode_metadata,
)
from .epoch import EpochRWLock
from .sthread import DelayMessage, RolledBackError, SThread

if TYPE_CHECKING:  # pragma: no cover
    from .coordinator import Coordinator
    from .state_object import StateObject


@dataclass
class DSEConfig:
    so_id: str
    coordinator: "Coordinator"
    group_commit_interval: float = 0.010  # seconds; paper default 10 ms
    strict_commit_ordering: bool = False
    #: which runtime implementation ``StateObject.Connect`` builds: ``"dse"``
    #: (speculative, this module) or ``"durable"`` (synchronous baseline,
    #: :class:`repro.durable.DurableRuntime`). Same config, same protocol.
    runtime: str = "dse"
    # Jitter persists across the fleet so thousands of nodes do not fsync in
    # lock-step (straggler/burst mitigation; beyond-paper, see DESIGN.md §6).
    persist_jitter: float = 0.0
    barrier_poll_interval: float = 0.002
    user_metadata_fn: Optional[object] = None  # Callable[[], bytes]
    #: time + blocking-primitive source; the simulation harness injects a
    #: virtual clock here (DESIGN.md §8), production uses the real one.
    clock: Clock = REAL_CLOCK


class CrashedError(Exception):
    """Raised by a killed incarnation (failure-injection harness)."""


class DSERuntime:
    #: introspection tag (``"durable"`` in the synchronous baseline subclass)
    kind = "dse"

    def __init__(self, so: "StateObject", config: DSEConfig) -> None:
        self.so = so
        self.config = config
        self.so_id = config.so_id
        self.coordinator = config.coordinator
        self.clock = config.clock

        self._epoch = EpochRWLock(self.clock)
        self._mu = self.clock.rlock()
        self._boundary_cond = self.clock.condition(self._mu)

        self.world = 0
        self._v_cur = 1  # version 0 is the Connect-time snapshot
        self._committed = -1
        self._dirty = False
        self._current_deps: Set[Vertex] = set()
        # deps of persisted-but-not-yet-inside-boundary labels (for the
        # skip-rollback mitigation, paper §5.3) + local label list.
        self._dep_log: Dict[int, FrozenSet[Vertex]] = {}
        self._labels: List[int] = []

        self._decisions: List[RollbackDecision] = []
        #: compacted invalidation index over ``_decisions`` — message
        #: classification is O(deps · log failures), not O(deps · failures)
        self._dindex = DecisionIndex()
        self._boundary: Dict[str, int] = {}
        #: generation of ``_boundary`` as quoted by the coordinator; polls
        #: answering with this seq ship no boundary (nothing moved)
        self._boundary_seq = -1
        self._report_queue: List[PersistReport] = []
        #: per-incarnation flush sequence stamped on each PersistReport so
        #: the coordinator can drop duplicate deliveries (a transport retry
        #: landing after the requeue path already resent the report).
        self._report_seq = 0
        #: world -> highest version whose report the coordinator has ACKED
        #: (a successful ``report`` RPC return); the durable baseline blocks
        #: exposure on this mark.
        self._flushed_marks: Dict[int, int] = {}
        self._last_persist = self.clock.now()
        if config.persist_jitter:
            # crc32, not hash(): PYTHONHASHSEED-salted str hashing would make
            # the jitter offset differ across processes, breaking the
            # (scenario, seed) replay guarantee of DESIGN.md §8
            stable = zlib.crc32(self.so_id.encode())
            self._last_persist += (stable % 1000) / 1000.0 * config.persist_jitter

        self._dead = False
        self._persist_failures: List[BaseException] = []

    # ------------------------------------------------------------------ #
    # lifecycle                                                          #
    # ------------------------------------------------------------------ #
    def connect(self) -> None:
        """Register with the coordinator; adopt rollback state; make an
        initial durable version so a restore floor always exists.

        The fragment list is O(live state), not O(history): the previous
        incarnation's fragment GC (``_apply_prune`` + ``_resend_fragments``)
        keeps the durable store bounded to the exposure floor and above, so
        a reconnect ships only the live window (DESIGN.md §11). No floor
        filter applies here — a fresh incarnation has no boundary yet, and
        the disk it inherits is already the pruned suffix.
        """
        fragments, _, _ = self._list_fragments()
        resp = self.coordinator.connect(self.so_id, fragments)
        idx = DecisionIndex(resp.decisions)
        with self._mu:
            self.world = resp.world
            self._decisions = list(resp.decisions)
            self._dindex = idx
            self._boundary = dict(resp.boundary or {})
            # Adopt the seq only alongside an actual boundary: connecting
            # during an incomplete view (boundary=None) with a current seq
            # would otherwise gate away the first real boundary ship.
            self._boundary_seq = (
                getattr(resp, "boundary_seq", -1) if resp.boundary is not None else -1
            )

        if resp.restore_to is not None:
            # Restarted (or adopted) incarnation: load the prescribed prefix.
            # Stale blobs above the target (from versions a past decision
            # invalidated) stay on disk but are filtered everywhere by the
            # decision list, which the coordinator replays durably.
            self.so.Restore(resp.restore_to)
            valid = {
                r.vertex.version for r in fragments if not idx.invalidates(r.vertex)
            }
            with self._mu:
                self._committed = resp.restore_to
                self._v_cur = resp.restore_to + 1
                self._labels = sorted(v for v in valid if v <= resp.restore_to)
                self._dep_log = {}
        else:
            # Fresh StateObject: synchronously persist version 0.
            self._persist_now(force_label=0, synchronous=True)
        try:
            self._flush_reports()
        except Exception:
            # Transport failure (partitioned/lossy fabric) must not abort the
            # connect: the reports are requeued and the next Refresh retries
            # them. Raising here would strand the cluster with the dead
            # incarnation still registered (restart never completes).
            pass

    def mark_dead(self) -> None:
        self._dead = True

    def _check_alive(self) -> None:
        if self._dead:
            raise CrashedError(f"{self.so_id}: this incarnation has crashed")

    # ------------------------------------------------------------------ #
    # header classification (instrumentation + partition rules)          #
    # ------------------------------------------------------------------ #
    def classify_header(self, header: Optional[Header]) -> str:
        """'ok' | 'discard' | 'delay' per Defs 4.1/4.3."""
        if header is None:
            return "ok"
        with self._mu:
            for dep in header.deps:
                if dep.world > self.world:
                    return "delay"
                if dep.world < self.world:
                    # Either rolled back, or the surviving prefix of an older
                    # epoch whose sender will retry post-recovery — both
                    # discard (Def 4.3, conservative per the paper's rule).
                    return "discard"
                if self._dindex.invalidates(dep):
                    return "discard"
        return "ok"

    def any_invalid(self, deps: Iterable[Vertex]) -> bool:
        with self._mu:
            return any(
                dep.world < self.world or self._dindex.invalidates(dep)
                for dep in deps
            )

    # ------------------------------------------------------------------ #
    # actions (paper §3.1)                                               #
    # ------------------------------------------------------------------ #
    def start_action(self, header: Optional[Header] = None) -> bool:
        self._check_alive()
        self._epoch.acquire_shared()
        try:
            status = self.classify_header(header)
            if status == "delay":
                raise DelayMessage()
            if status == "discard":
                self._epoch.release_shared()
                return False
            if header is not None:
                n = header.max_version_for()
                if self.config.strict_commit_ordering:
                    # Paper-literal Def 4.1: block the action until local
                    # persistence has caught up with the sender watermark.
                    while True:
                        with self._mu:
                            if self._v_cur >= n:
                                break
                        self._epoch.release_shared()
                        self.maybe_persist(force=True)
                        self._epoch.acquire_shared()
                with self._mu:
                    if n > self._v_cur:
                        self._v_cur = n  # relabel (monotone watermark)
                    self._current_deps |= {d for d in header.deps if d.so_id != self.so_id}
            with self._mu:
                self._dirty = True
            return True
        except DelayMessage:
            self._epoch.release_shared()
            raise
        except Exception:
            self._epoch.release_shared()
            raise

    def end_action(self) -> Header:
        with self._mu:
            h = Header.of(Vertex(self.so_id, self.world, self._v_cur))
        self._epoch.release_shared()
        return h

    def abort_action(self) -> None:
        """Release action protection without emitting a header (the effects,
        if any, still belong to the in-progress version)."""
        self._epoch.release_shared()

    def current_vertex(self) -> Vertex:
        with self._mu:
            return Vertex(self.so_id, self.world, self._v_cur)

    # ------------------------------------------------------------------ #
    # sthreads                                                           #
    # ------------------------------------------------------------------ #
    def detach(self) -> SThread:
        """End the calling action, producing an sthread carrying its deps."""
        with self._mu:
            deps = {Vertex(self.so_id, self.world, self._v_cur)}
        self._epoch.release_shared()
        return SThread(self, deps)

    def merge(self, sthread: SThread) -> bool:
        """Logically send sthread -> StateObject and start an action."""
        try:
            header = sthread.Send()
        except RolledBackError:
            return False
        while True:
            try:
                return self.start_action(header)
            except DelayMessage:
                # The sthread observed a future failure epoch; catch up by
                # applying pending decisions, then retry (Def 4.3 delay).
                try:
                    self.refresh()
                except TimeoutError:
                    pass  # fabric hiccup: retry the catch-up next iteration

    # ------------------------------------------------------------------ #
    # persistence (group commit)                                         #
    # ------------------------------------------------------------------ #
    def maybe_persist(self, force: bool = False) -> Optional[int]:
        self._check_alive()
        now = self.clock.now()
        with self._mu:
            due = (now - self._last_persist) >= self.config.group_commit_interval
            if not force and not (due and self._dirty):
                return None
        return self._persist_now()

    def _persist_now(self, force_label: Optional[int] = None, synchronous: bool = False) -> int:
        label, done, _world = self._persist_begin(force_label)
        if synchronous:
            done.wait()
            try:
                self._flush_reports()
            except Exception:
                pass  # connect-time flush: requeued, retried next Refresh
        return label

    def _persist_begin(self, force_label: Optional[int] = None):
        """Snapshot + kick off the async Persist IO; returns ``(label,
        done_event, world)`` — the event sets once the version is durable
        and its report is queued; ``world`` is the epoch the snapshot (and
        its report) actually carries, taken under the exclusive epoch so no
        decision can interleave. The synchronous durable baseline builds
        its per-action commit wait on this hook."""
        self._epoch.acquire_exclusive()
        try:
            with self._mu:
                label = self._v_cur if force_label is None else force_label
                deps = frozenset(self._current_deps)
                self._current_deps = set()
                self._dep_log[label] = deps
                self._labels.append(label)
                self._v_cur = label + 1
                self._dirty = False
                self._last_persist = self.clock.now()
                world = self.world
            user_meta = b""
            if self.config.user_metadata_fn is not None:
                user_meta = self.config.user_metadata_fn()  # type: ignore[operator]
            meta = encode_metadata(world, label, deps, user=user_meta)
            done = self.clock.event()

            def _callback() -> None:
                with self._mu:
                    if label > self._committed:
                        self._committed = label
                    seq = self._report_seq
                    self._report_seq += 1
                    self._report_queue.append(
                        PersistReport(
                            Vertex(self.so_id, world, label), tuple(deps), seq=seq
                        )
                    )
                done.set()

            self.so.Persist(label, meta, _callback)
        finally:
            self._epoch.release_exclusive()
        return label, done, world

    # ------------------------------------------------------------------ #
    # refresh: background protocol driving (paper Table 2)               #
    # ------------------------------------------------------------------ #
    def refresh(self) -> None:
        self._check_alive()
        self.maybe_persist()
        self._flush_reports()
        self._poll_coordinator()

    def _flush_reports(self) -> None:
        with self._mu:
            reports, self._report_queue = self._report_queue, []
        if not reports:
            return
        # Dedup the batch by vertex: requeue interleavings can only ever
        # leave one copy of a fragment in OUR queue, but belt-and-braces here
        # keeps the wire batch canonical (and the coordinator additionally
        # drops cross-batch duplicates by (so_id, world, seq) — a transport
        # retry of a timed-out flush can land AFTER the requeued resend).
        seen = set()
        batch: List[PersistReport] = []
        for r in reports:
            key = (r.vertex.world, r.vertex.version)
            if key in seen:
                continue
            seen.add(key)
            batch.append(r)
        try:
            rejected = self.coordinator.report(self.so_id, batch)
        except Exception:
            # Transport failure (lossy / partitioned fabric): the coordinator
            # may or may not have seen these fragments, so requeue them for
            # the next Refresh round — silently dropping them could stall the
            # boundary forever; the coordinator-side seq dedup makes the
            # at-least-once resend single-count.
            with self._mu:
                self._report_queue = batch + self._report_queue
            raise
        # Admission marks: a delivered report a decision already invalidated
        # is NOT inside the coordinator's view (it will be rolled back), so
        # it must not advance the durable baseline's exposure floor. An
        # old/mocked coordinator returning None means "all admitted".
        dropped = {(v.world, v.version) for v in (rejected or ())}
        with self._mu:
            for r in batch:
                w = r.vertex.world
                if (w, r.vertex.version) in dropped:
                    continue
                if r.vertex.version > self._flushed_marks.get(w, -1):
                    self._flushed_marks[w] = r.vertex.version

    def _poll_coordinator(self) -> None:
        with self._mu:
            known = self.world
            known_seq = self._boundary_seq
        resp = self.coordinator.poll(self.so_id, known, known_seq)
        if resp.resend_fragments:
            self._resend_fragments()
            with self._mu:
                # A resend request means the coordinator restarted: its
                # boundary_seq counter restarted too, so forget ours — the
                # next poll must ship the full boundary again.
                self._boundary_seq = -1
        for d in sorted(resp.decisions, key=lambda d: d.fsn):
            self._apply_decision(d)  # Recovery Sequencing Rule (Def 4.2)
        if resp.boundary is not None:
            with self._mu:
                # Notify only on actual progress: concurrent barriers each
                # drive _poll_coordinator, and unconditional notify_all lets
                # them wake each other in a storm that (under zero-latency
                # virtual time) never lets the poll interval elapse.
                changed = resp.boundary != self._boundary
                self._boundary = dict(resp.boundary)
                self._boundary_seq = resp.boundary_seq
                if changed:
                    self._boundary_cond.notify_all()
            self._apply_prune()

    def _list_fragments(
        self, floor: int = -1, dindex: Optional[DecisionIndex] = None
    ) -> tuple:
        """Rebuild PersistReports from the durable store as ``(fragments,
        dropped, anchor)``, skipping versions that are strictly below the
        durable **anchor** — the greatest persisted label <= the exposure
        floor (the floor is a watermark and may sit in a label gap from
        relabeling; the anchor is the label that actually carries the floor
        state, and always ships) — or that a known rollback decision has
        invalidated (stale blobs above an old target: the coordinator would
        drop them at ingest anyway)."""
        decoded = []
        for version, meta in self.so.ListVersions():
            try:
                world, v, deps, _user = decode_metadata(meta)
            except Exception:
                continue
            decoded.append((v, world, deps))

        def valid(v: int, world: int) -> bool:
            return dindex is None or not dindex.invalidates(Vertex(self.so_id, world, v))

        # the anchor must be elected among VALID labels: a decision-
        # invalidated stale blob sitting in (target, floor] would otherwise
        # win the max, get dropped by the decision filter below, and take
        # the genuine floor carrier (every valid label under it) with it
        anchor = max((v for v, w, _ in decoded if v <= floor and valid(v, w)), default=-1)
        fragments: List[PersistReport] = []
        dropped = 0
        for v, world, deps in decoded:
            if v < anchor or not valid(v, world):
                dropped += 1
                continue
            fragments.append(PersistReport(Vertex(self.so_id, world, v), deps))
        return fragments, dropped, anchor

    def _resend_fragments(self) -> None:
        with self._mu:
            floor = self._boundary.get(self.so_id, -1)
            idx = self._dindex
        fragments, dropped, anchor = self._list_fragments(floor, idx)
        # The coordinator must never need a GC'd fragment: whenever history
        # was dropped, the anchor label (whose watermark the coordinator's
        # durable snapshot already records) must still be in the resend.
        assert not dropped or anchor < 0 or any(
            r.vertex.version == anchor for r in fragments
        ), f"{self.so_id}: fragment GC dropped the anchor ({anchor}, floor={floor})"
        self.coordinator.receive_fragments(self.so_id, fragments)

    def _apply_prune(self) -> None:
        with self._mu:
            b = self._boundary.get(self.so_id, -1)
            floor_candidates = [l for l in self._labels if l <= b]
            if len(floor_candidates) < 2:
                return
            floor = floor_candidates[-1]
            self._labels = [l for l in self._labels if l >= floor]
            for l in [l for l in self._dep_log if l < floor]:
                self._dep_log.pop(l, None)
        self.so.Prune(floor)

    # ------------------------------------------------------------------ #
    # recovery (paper §4.2 Recovery Protocol + §5.3 mitigation)          #
    # ------------------------------------------------------------------ #
    def _apply_decision(self, d: RollbackDecision) -> None:
        with self._mu:
            if d.fsn <= self.world:
                return
        self._epoch.acquire_exclusive()
        try:
            with self._mu:
                if d.fsn <= self.world:
                    return
                target = d.targets.get(self.so_id)
                inmem_deps: Set[Vertex] = set(self._current_deps)
                for label, deps in self._dep_log.items():
                    if target is None or label > target:
                        inmem_deps |= deps
                own_prefix_intact = target is None or target >= self._committed
                clean = not any(d.invalidates(dep) for dep in inmem_deps)
                can_skip = own_prefix_intact and clean
            if can_skip:
                # §5.3: participants not exposed to speculative (now lost)
                # state keep their in-memory content; only the epoch advances.
                with self._mu:
                    self.world = d.fsn
                    self._decisions.append(d)
                    self._dindex.add(d)
            else:
                assert target is not None
                # A decision can assign -1 when our synchronous v0 report was
                # still crossing the fabric when it was computed; our durable
                # floor (the Connect-time snapshot, dependency-free) is always
                # a safe restore point, so clamp up to it.
                with self._mu:
                    floor = self._labels[0] if self._labels else 0
                target = max(target, floor)
                self.so.Restore(target)
                with self._mu:
                    self.world = d.fsn
                    self._decisions.append(d)
                    self._dindex.add(d)
                    self._committed = min(self._committed, target)
                    self._v_cur = target + 1
                    self._current_deps = set()
                    self._dep_log = {l: v for l, v in self._dep_log.items() if l <= target}
                    self._labels = [l for l in self._labels if l <= target]
                    self._dirty = False
                    self._report_queue = [
                        r for r in self._report_queue if r.vertex.version <= target
                    ]
        finally:
            self._epoch.release_exclusive()

    # ------------------------------------------------------------------ #
    # barriers (paper §3.2)                                              #
    # ------------------------------------------------------------------ #
    def barrier(self, deps: FrozenSet[Vertex], timeout: Optional[float] = None) -> None:
        """Block until every vertex in ``deps`` is inside the recoverable
        boundary. Our own pending state is force-persisted once so local
        durability is never the reason a barrier waits a full group-commit
        period."""
        deadline = None if timeout is None else self.clock.now() + timeout
        with self._mu:
            needs_local = any(
                dep.so_id == self.so_id and dep.version > self._committed for dep in deps
            )
        if needs_local:
            self.maybe_persist(force=True)

        while True:
            if self.any_invalid(deps):
                raise RolledBackError("barrier deps were rolled back")
            with self._mu:
                if all(self._boundary.get(dep.so_id, -1) >= dep.version for dep in deps):
                    return
            try:
                self._flush_reports()
                self._poll_coordinator()
            except TimeoutError:
                # Transient fabric failure (partition/loss): transport errors
                # are retryable everywhere else; only the barrier's OWN
                # deadline below may raise TimeoutError to the caller.
                pass
            with self._mu:
                if all(self._boundary.get(dep.so_id, -1) >= dep.version for dep in deps):
                    return
                remaining = self.config.barrier_poll_interval
                if deadline is not None:
                    remaining = min(remaining, deadline - self.clock.now())
                    if remaining <= 0:
                        raise TimeoutError(f"barrier timed out waiting for {set(deps)}")
                self._boundary_cond.wait(timeout=remaining)

    # ------------------------------------------------------------------ #
    # introspection                                                      #
    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, object]:
        with self._mu:
            return {
                "so_id": self.so_id,
                "runtime": self.kind,
                "world": self.world,
                "v_cur": self._v_cur,
                "committed": self._committed,
                "boundary": dict(self._boundary),
                "decisions": len(self._decisions),
                "labels": list(self._labels),
            }

    @property
    def boundary(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._boundary)
