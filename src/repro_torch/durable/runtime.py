"""DurableRuntime — the synchronous durable-execution baseline (paper §2.1,
Figure 9 "current systems" bar), speaking the unmodified DSE protocol.

Semantics: nothing leaves a StateObject — no reply, no outgoing message, no
sthread — until (a) the state it derives from is durable on disk AND (b) the
coordinator has acknowledged the persist report. Every ``EndAction`` /
``Detach`` therefore pays a full synchronous persist + report round-trip,
which is exactly the per-step durability wait Temporal/Beldi/Boki-class
engines charge (and what DSE's speculation removes from the latency path).

Why (b) and not just local durability: the coordinator computes rollback
targets on its *reported* view (paper §4.3); a durable-but-unreported vertex
is above its owner's target and would be rolled back, i.e. an exposed result
could be lost — exactly what "durable execution" promises never happens.
Blocking exposure on the report ack closes that window, and makes the
invariant exact: every header this runtime ever emits references a vertex
inside the coordinator's view, so every rollback decision in an all-durable
cluster is a no-op on durable state (only in-flight action state is lost).
That is the property the differential oracle (``repro.sim.differential``)
leans on.

Implementation: a thin subclass of :class:`~repro.core.runtime.DSERuntime`
— header classification, decision application, recovery, barriers, and the
coordinator protocol are deliberately shared (the baseline must speak the
same wire protocol to run on the same clusters/fabrics); only the action
commit path changes. Select it with ``DSEConfig(runtime="durable")`` or
``LocalCluster/NetCluster/SimCluster(..., runtime="durable")``.
"""
from __future__ import annotations

from ..core.ids import Header, Vertex
from ..core.runtime import DSERuntime
from ..core.sthread import RolledBackError, SThread


class DurableRuntime(DSERuntime):
    kind = "durable"

    # ------------------------------------------------------------------ #
    # action lifecycle: commit synchronously before anything escapes     #
    # ------------------------------------------------------------------ #
    def end_action(self) -> Header:
        self._epoch.release_shared()
        return Header.of(self._commit_sync())

    def detach(self) -> SThread:
        self._epoch.release_shared()
        return SThread(self, {self._commit_sync()})

    def _commit_sync(self) -> Vertex:
        """Persist the current state, wait until it is durable AND its
        report is acknowledged by the coordinator, then return the (now
        non-speculative) vertex the caller may expose.

        Called with no locks held (the shared epoch is released first: the
        persist path takes the exclusive epoch, and holding shared across it
        would deadlock). A concurrent action committing between the release
        and the snapshot only means our effects ride its (also synchronous)
        persist — the label returned always covers our action's effects.
        """
        # ``world`` is the epoch the snapshot actually carries (taken under
        # the exclusive epoch inside _persist_begin, so no decision can
        # interleave): the admission mark, the invalidation check, and the
        # returned vertex below all key on the same (world, label) pair.
        label, done, world = self._persist_begin()
        # durability wait — poll-free except for liveness: a crashed
        # incarnation's store never acks, so re-check aliveness periodically
        # instead of blocking forever.
        while not done.wait(timeout=0.05):
            self._check_alive()
        # admission-ack wait: retry the flush across transport faults (the
        # coordinator-side (world, seq) dedup makes the at-least-once resend
        # single-count). ``report`` returns the vertices a decision already
        # invalidated, and only ADMITTED vertices advance _flushed_marks —
        # "delivered but dropped" must not count as durable (the dropped
        # vertex is above its rollback target and will be rolled back).
        while True:
            with self._mu:
                if self._flushed_marks.get(world, -1) >= label:
                    break  # durable AND inside the coordinator's view
                if self.world != world and self._dindex.invalidates(
                    Vertex(self.so_id, world, label)
                ):
                    # A rollback decision landed mid-commit and took our
                    # label with it. Durable execution fails the request
                    # rather than ack state that no longer exists; the
                    # caller's driver retries against the recovered state.
                    raise RolledBackError(
                        f"{self.so_id}: commit of v{label} interrupted by "
                        f"rollback to epoch {self.world}"
                    )
                pending = bool(self._report_queue)
            self._check_alive()
            if pending:
                try:
                    self._flush_reports()
                    continue
                except Exception:
                    self.clock.sleep(self.config.barrier_poll_interval)
                    continue  # fabric fault: back off, retry
            # Nothing left to flush, yet no admission mark: either a
            # concurrent flusher owns our report (its ack will land), or the
            # coordinator rejected it (a decision exists that we have not
            # applied yet) — poll so the decision/world catches up and the
            # invalidation check above can resolve the wait.
            try:
                self._poll_coordinator()
            except Exception:
                pass  # transient fabric fault: poll again next beat
            self.clock.sleep(self.config.barrier_poll_interval)
        with self._mu:
            vertex = Vertex(self.so_id, world, label)
        # Eager fragment GC (DESIGN.md §11): the durable baseline persists
        # one version per action, so leaving pruning to the background
        # Refresh lets the store (and every reconnect/resend) grow by the
        # full action rate between boundary ships. The floor was durably
        # exposed before this commit returned, so pruning here is sound.
        self._apply_prune()
        return vertex
