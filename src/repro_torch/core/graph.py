"""Recovery dependency graph and the boundary / rollback fixpoints (paper §4.2–4.3).

The graph is stored in *watermark* form: for each StateObject we keep the
sorted list of persisted version labels and, per label, the dependency list
``[(dep_so, dep_version), ...]``. Prefix-recoverability semantics mean a
dependency on version ``n`` of ``B`` is satisfied by any recovered watermark
``>= n`` of ``B`` — precedence edges (paper: "implicitly by precedence") are
therefore implicit, and persisted-label *gaps* (from version relabeling, see
DESIGN.md §2) are harmless.

Two closely-related fixpoints are computed here:

* ``recoverable_boundary`` — the maximal closure of durable vertices; the
  cut behind which results are non-speculative (Boundary Protocol).
* ``rollback_targets`` — identical computation with the failed SO's durable
  watermark truncated to what actually survived; the consistent prefix every
  participant restores to (Recovery Protocol).

Because the commit ordering rule guarantees dep.version <= vertex.version,
every global watermark set {v : v.version <= t} is a closure, so the
fixpoint always terminates at a non-degenerate cut (no domino effect).

Boundary maintenance is *incremental* (DESIGN.md §9): alongside the graph we
keep the current boundary, a waiters index (reverse dependencies of blocked
vertices), and the pending frontier, so ingesting one PersistReport costs
O(its deps + waiters it unblocks) instead of re-running the global fixpoint.
The from-scratch fixpoint is retained as the slow-path oracle — rollback /
truncation fall back to it, and tests cross-check equivalence.
"""
from __future__ import annotations

import bisect
import heapq
import threading
from collections import deque
from typing import Deque, Dict, Iterable, List, Mapping, Optional, Tuple


DepList = List[Tuple[str, int]]  # [(dep_so_id, dep_version_watermark)]


class DependencyGraph:
    """Coordinator-side (possibly stale) view of the persisted dependency graph.

    Thread-safe; all mutation happens under one lock (the coordinator calls
    are already serialized, but services may query concurrently).
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # so_id -> {version -> deps}
        self._deps: Dict[str, Dict[int, DepList]] = {}
        # so_id -> sorted list of persisted version labels
        self._labels: Dict[str, List[int]] = {}

        # -- incremental boundary state (all guarded by self._lock) --------
        # current boundary watermark per member (== oracle when _inc_valid)
        self._inc_bound: Dict[str, int] = {}
        # waiters index: dep_so -> heap of (required_version, waiting_so);
        # when dep_so's watermark reaches required_version, waiting_so gets
        # another advance attempt.
        self._waiters: Dict[str, List[Tuple[int, str]]] = {}
        # so -> label it is currently registered as blocked at (dedups
        # waiter heap entries across repeated failed attempts at one label)
        self._blocked: Dict[str, int] = {}
        # monotone change counter: bumps whenever the boundary mapping can
        # have changed (watermark advance, new member, rebuild)
        self._inc_version = 0
        # False after truncate/remove_member: the next incremental query
        # rebuilds from the fixpoint oracle (rollback is the rare path)
        self._inc_valid = True
        # set when a blocked dep is persisted-but-unadmitted — the only
        # situation where same-version dependency cycles can stall the
        # bottom-up advance and the frontier rescue pass must run
        self._maybe_cycle = False

    # -- mutation --------------------------------------------------------------
    def add_member(self, so_id: str) -> None:
        with self._lock:
            if so_id not in self._labels:
                self._deps[so_id] = {}
                self._labels[so_id] = []
                self._inc_bound.setdefault(so_id, -1)
                self._inc_version += 1  # boundary mapping gains a key

    def remove_member(self, so_id: str) -> None:
        with self._lock:
            self._deps.pop(so_id, None)
            self._labels.pop(so_id, None)
            self._invalidate_incremental()

    def report_persistent(self, so_id: str, version: int, deps: Iterable[Tuple[str, int]]) -> None:
        with self._lock:
            self.add_member(so_id)
            per = self._deps[so_id]
            dep_list = list(deps)
            if version not in per:
                bisect.insort(self._labels[so_id], version)
            elif per[version] != dep_list and self._blocked.get(so_id) == version:
                # The blocked label's dep list changed (protocol traffic never
                # mutates a persisted vertex, but this public API allows it):
                # drop the registration dedup so the cascade below re-registers
                # waiters for the NEW deps instead of waiting on stale ones.
                self._blocked.pop(so_id, None)
            per[version] = dep_list
            if not self._inc_valid:
                return
            if version > self._inc_bound.get(so_id, -1):
                self._cascade(so_id)
            elif any(
                dep_so != so_id and self._inc_bound.get(dep_so, -1) < dep_version
                for dep_so, dep_version in dep_list
            ):
                # Out-of-order delivery landed a vertex BELOW the admitted
                # watermark with an unsatisfied dep: the admitted prefix is
                # no longer a closure and advance-only maintenance cannot
                # lower it — rebuild from the oracle on the next query.
                self._invalidate_incremental()

    def merge_from(self, other: "DependencyGraph") -> None:
        """Absorb another graph's vertices (sharded-coordinator merge rule:
        the global view is the union of per-shard fragments)."""
        snap = other.snapshot()
        with self._lock:
            for so, per in snap.items():
                self.add_member(so)
                for v, deps in per.items():
                    self.report_persistent(so, v, deps)

    def truncate(self, so_id: str, keep_upto: int) -> None:
        """Drop vertices of ``so_id`` with version > keep_upto (rollback)."""
        with self._lock:
            labels = self._labels.get(so_id, [])
            cut = bisect.bisect_right(labels, keep_upto)
            if cut == len(labels):
                return  # nothing dropped: boundary unaffected
            for v in labels[cut:]:
                self._deps[so_id].pop(v, None)
            self._labels[so_id] = labels[:cut]
            self._invalidate_incremental()

    def prune(self, so_id: str, below: int) -> None:
        """Forget dep lists for versions <= ``below`` (they are inside the
        boundary forever; keeping only the watermark is sufficient)."""
        with self._lock:
            labels = self._labels.get(so_id, [])
            if not labels:
                return
            cut = bisect.bisect_right(labels, below)
            if cut <= 1:
                return
            if self._inc_valid and labels[cut - 1] > self._inc_bound.get(so_id, -1):
                # Pruning past the incremental watermark (a sharded caller
                # pruning to an externally-computed boundary) can remove a
                # blocked label the incremental state still tracks: rebuild.
                # The coordinator's own prune-at-boundary never takes this
                # branch (below == the incremental watermark).
                self._invalidate_incremental()
            # keep the highest pruned label as the floor watermark
            for v in labels[: cut - 1]:
                self._deps[so_id].pop(v, None)
                self._deps[so_id].setdefault(labels[cut - 1], [])
            self._labels[so_id] = labels[cut - 1 :]

    # -- queries ---------------------------------------------------------------
    def members(self) -> List[str]:
        with self._lock:
            return list(self._labels.keys())

    def committed_watermarks(self) -> Dict[str, int]:
        with self._lock:
            return {so: (labels[-1] if labels else -1) for so, labels in self._labels.items()}

    def snapshot(self) -> Dict[str, Dict[int, DepList]]:
        with self._lock:
            return {so: {v: list(d) for v, d in per.items()} for so, per in self._deps.items()}

    def size(self) -> Tuple[int, int]:
        """(members, vertices) — O(members) counters for stats/telemetry,
        without the full deep copy ``snapshot()`` makes."""
        with self._lock:
            return len(self._labels), sum(len(ls) for ls in self._labels.values())

    # -- durable-cut export/restore (repro.store, DESIGN.md §11) ---------------
    def export_state(self) -> Dict[str, List[Tuple[int, DepList]]]:
        """The retained view as ``{so: [(label, deps), ...]}`` (labels
        sorted). Because ``prune`` collapses everything below the exposure
        floor to the floor watermark, this is the graph *at the floor* —
        O(live state), the shape the coordinator snapshot persists."""
        with self._lock:
            return {
                so: [(v, list(self._deps[so].get(v, ()))) for v in labels]
                for so, labels in self._labels.items()
            }

    def restore_state(self, state: Dict[str, List[Tuple[int, DepList]]]) -> None:
        """Install an exported view (snapshot recovery). Replaces same-SO
        content wholesale; the incremental boundary state is rebuilt from
        the fixpoint oracle on the next query — the same fall-back the
        rollback path uses, so the §9 equivalence property covers it."""
        with self._lock:
            for so, entries in state.items():
                self._deps[so] = {v: list(deps) for v, deps in entries}
                self._labels[so] = sorted(self._deps[so])
                self._inc_bound.setdefault(so, -1)
            self._invalidate_incremental()

    # -- fixpoints ---------------------------------------------------------------
    def recoverable_boundary(
        self,
        committed_override: Optional[Mapping[str, int]] = None,
        external: Optional[Mapping[str, int]] = None,
    ) -> Dict[str, int]:
        """Greatest closure of durable vertices, as per-SO version watermarks.

        ``committed_override`` truncates specific SOs' durable watermarks
        (used by the rollback computation for the failed SO's surviving
        prefix). Returns ``{so_id: watermark}``; a watermark of -1 means
        "nothing recoverable yet" (version labels start at 0).

        ``external`` supplies watermark estimates for SOs this graph does not
        own (sharded deployment: each shard holds only its members' fragments,
        and the global boundary is the fixpoint of per-shard boundaries under
        exchanged estimates — see DESIGN.md §7). External SOs are never cut
        by this graph; only this graph's members appear in the result.
        """
        with self._lock:
            return self._fixpoint_locked(committed_override, external)

    def _fixpoint_locked(
        self,
        committed_override: Optional[Mapping[str, int]] = None,
        external: Optional[Mapping[str, int]] = None,
    ) -> Dict[str, int]:
        bound: Dict[str, int] = {}
        for so, labels in self._labels.items():
            b = labels[-1] if labels else -1
            if committed_override and so in committed_override:
                b = min(b, committed_override[so])
            bound[so] = b
        if external:
            for so, w in external.items():
                bound.setdefault(so, w)

        changed = True
        while changed:
            changed = False
            for so, per_version in self._deps.items():
                b = bound.get(so, -1)
                for v in sorted(ver for ver in per_version if ver <= b):
                    for dep_so, dep_version in per_version[v]:
                        if dep_so == so:
                            continue  # precedence is implicit
                        if bound.get(dep_so, -1) < dep_version:
                            # v (and everything after) cannot be in the
                            # closure: cut this SO's watermark below v.
                            bound[so] = v - 1
                            changed = True
                            break
                    if bound[so] < v:
                        break
        return {so: b for so, b in bound.items() if so in self._labels}

    # -- incremental boundary (DESIGN.md §9) ------------------------------------
    def incremental_boundary(self) -> Tuple[int, Dict[str, int]]:
        """Current recoverable boundary via incremental maintenance.

        Returns ``(change_version, {so: watermark})``: ``change_version`` is
        a monotone counter bumped whenever the boundary mapping may have
        changed, so callers can skip rebuilding/diffing the dict (and the
        coordinator can answer polls with "nothing moved") in O(1).
        Equals ``recoverable_boundary()`` — property-tested in
        ``tests/test_incremental_boundary.py``.
        """
        with self._lock:
            if not self._inc_valid:
                self._rebuild_incremental_locked()
            return self._inc_version, {
                so: self._inc_bound.get(so, -1) for so in self._labels
            }

    def boundary_version(self) -> int:
        with self._lock:
            if not self._inc_valid:
                self._rebuild_incremental_locked()
            return self._inc_version

    def _invalidate_incremental(self) -> None:
        # rollback / member removal can LOWER watermarks, which the
        # advance-only incremental state cannot express: fall back to the
        # oracle on the next query (failures are the rare path).
        self._inc_valid = False

    def _rebuild_incremental_locked(self) -> None:
        self._inc_bound = dict(self._fixpoint_locked())
        self._waiters = {}
        self._blocked = {}
        self._inc_valid = True
        self._inc_version += 1
        # Register waiters for every member stuck below its top label so
        # future report ingestions cascade; the oracle is the greatest
        # closure, so these attempts cannot advance anything.
        queue: Deque[str] = deque(self._labels.keys())
        while queue:
            self._advance_one(queue.popleft(), queue)
        self._maybe_cycle = False

    def _cascade(self, so_id: str) -> None:
        """Advance ``so_id``'s watermark as far as possible and ripple
        through registered waiters; run the frontier rescue pass if a
        potential same-version dependency cycle was observed."""
        queue: Deque[str] = deque((so_id,))
        while queue:
            self._advance_one(queue.popleft(), queue)
        if self._maybe_cycle:
            self._maybe_cycle = False
            self._rescue_locked()

    def _advance_one(self, so: str, queue: Deque[str]) -> bool:
        """Admit ``so``'s pending labels in order while their deps are
        satisfied; on a block, cut to v-1 (matching the oracle's cut rule)
        and register a waiter. Returns True if the watermark moved."""
        labels = self._labels.get(so)
        if labels is None:
            return False
        per_version = self._deps[so]
        b = self._inc_bound.get(so, -1)
        start = b
        i = bisect.bisect_right(labels, b)
        unsatisfied: List[Tuple[str, int]] = []
        while i < len(labels):
            v = labels[i]
            for dep_so, dep_version in per_version.get(v, ()):
                if dep_so == so:
                    continue  # precedence is implicit
                if self._inc_bound.get(dep_so, -1) < dep_version:
                    unsatisfied.append((dep_so, dep_version))
            if unsatisfied:
                b = max(b, v - 1)  # oracle cut semantics: everything < v is in
                break
            b = v
            i += 1
        if not unsatisfied:
            self._blocked.pop(so, None)
        else:
            v = labels[i]
            if self._blocked.get(so) != v:
                # Register a waiter on EVERY unsatisfied dep: any of them can
                # be the last to be satisfied, and each such advance must
                # re-attempt this SO. (Once registered at this label, the
                # remaining entries persist in the heaps — entries pop only
                # when their requirement is satisfied — so re-attempts at the
                # same label skip re-registration.)
                self._blocked[so] = v
                for dep_so, dep_version in unsatisfied:
                    heapq.heappush(
                        self._waiters.setdefault(dep_so, []), (dep_version, so)
                    )
            # A blocking dep that is already persisted but not admitted means
            # its owner is itself blocked: only a dependency cycle (all
            # members at equal versions, by the commit ordering rule) or a
            # longer blocked chain looks like this — schedule the rescue.
            # Checked on every attempt, not just at registration: the attempt
            # satisfying the last acyclic dep must trigger it.
            for dep_so, dep_version in unsatisfied:
                dep_labels = self._labels.get(dep_so)
                if dep_labels and dep_labels[-1] >= dep_version:
                    self._maybe_cycle = True
                    break
        if b != start:
            self._inc_bound[so] = b
            self._inc_version += 1
            self._wake(so, b, queue)
            return True
        return False

    def _wake(self, so: str, watermark: int, queue: Deque[str]) -> None:
        heap = self._waiters.get(so)
        while heap and heap[0][0] <= watermark:
            _, waiting = heapq.heappop(heap)
            queue.append(waiting)

    def _rescue_locked(self) -> None:
        """Frontier group admission: same-version dependency cycles (legal —
        the commit ordering rule only forces dep.version <= vertex.version)
        cannot be admitted one vertex at a time. Take the next unadmitted
        label of every member as a candidate set, run the removal fixpoint
        restricted to those candidates, and admit survivors as a group.
        Iterated to quiescence this reaches the oracle's greatest closure
        (DESIGN.md §9) at O(pending frontier) — not O(history) — cost."""
        progressed = True
        while progressed:
            progressed = False
            cand: Dict[str, int] = {}
            for so, labels in self._labels.items():
                i = bisect.bisect_right(labels, self._inc_bound.get(so, -1))
                if i < len(labels):
                    cand[so] = labels[i]
            removed = True
            while removed and cand:
                removed = False
                for so in list(cand):
                    v = cand.get(so)
                    if v is None:
                        continue
                    for dep_so, dep_version in self._deps[so].get(v, ()):
                        if dep_so == so:
                            continue
                        tb = cand.get(dep_so, self._inc_bound.get(dep_so, -1))
                        if tb < dep_version:
                            del cand[so]
                            removed = True
                            break
            if cand:
                progressed = True
                queue: Deque[str] = deque()
                for so, v in cand.items():
                    self._inc_bound[so] = v
                    self._inc_version += 1
                    self._blocked.pop(so, None)
                for so, v in cand.items():
                    self._wake(so, v, queue)
                    queue.append(so)  # keep advancing past the admitted label
                while queue:
                    self._advance_one(queue.popleft(), queue)
        self._maybe_cycle = False

    def snap_to_labels(self, watermarks: Mapping[str, int]) -> Dict[str, int]:
        """Snap each watermark down to the greatest persisted label <= it.

        Restore targets must be loadable versions; -1 means the initial
        (Connect-time) version 0 snapshot does not exist yet, which cannot
        happen in practice because Connect persists version 0 synchronously.
        """
        with self._lock:
            out: Dict[str, int] = {}
            for so, w in watermarks.items():
                labels = self._labels.get(so, [])
                i = bisect.bisect_right(labels, w)
                out[so] = labels[i - 1] if i > 0 else -1
            return out

    def rollback_targets(self, failed_so: str, surviving: int) -> Dict[str, int]:
        """Consistent prefix after ``failed_so`` lost every version > ``surviving``."""
        bound = self.recoverable_boundary({failed_so: surviving})
        return self.snap_to_labels(bound)
