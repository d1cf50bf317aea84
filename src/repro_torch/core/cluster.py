"""LocalCluster — in-process deployment + failure-injection harness.

Plays the role Kubernetes plays in the paper's deployment (§5.1): it hosts
StateObject incarnations, drives the background protocol (``Refresh``),
detects "down" services (here: explicit ``kill``), replaces them with fresh
incarnations, and reconnects them to the coordinator — which is exactly the
signal libDSE uses to trigger cluster-level recovery.

Transport note (DESIGN.md §2): services in this repo call each other
in-process, passing :class:`~repro.core.ids.Header` objects where the paper
passes gRPC HTTP headers. The protocol is transport-agnostic; ``call`` below
provides the retry-on-delay semantics a gRPC interceptor would.
"""
from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

from .clock import Clock, REAL_CLOCK, SpawnHandle
from .coordinator import Coordinator
from .runtime import CrashedError, DSEConfig
from .sthread import DelayMessage
from .state_object import StateObject


class LocalCluster:
    def __init__(
        self,
        root: Path,
        *,
        group_commit_interval: float = 0.010,
        refresh_interval: Optional[float] = 0.002,
        strict_commit_ordering: bool = False,
        persist_jitter: float = 0.0,
        barrier_poll_interval: float = 0.002,
        runtime: str = "dse",
        clock: Clock = REAL_CLOCK,
        checkpoint_records: Optional[int] = 256,
        checkpoint_bytes: int = 1 << 20,
    ) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.clock = clock
        #: coordinator durable-store knobs (repro.store, DESIGN.md §11);
        #: checkpoint_records=None disables snapshot compaction entirely
        self._store_kw = dict(
            checkpoint_records=checkpoint_records, checkpoint_bytes=checkpoint_bytes
        )
        self.coordinator = self._make_coordinator()
        # ``runtime`` selects the execution engine every member Connects
        # with: "dse" (speculative) or "durable" (synchronous baseline);
        # per-SO ``add(..., runtime=...)`` overrides win.
        self._defaults = dict(
            group_commit_interval=group_commit_interval,
            strict_commit_ordering=strict_commit_ordering,
            persist_jitter=persist_jitter,
            barrier_poll_interval=barrier_poll_interval,
            runtime=runtime,
            clock=clock,
        )
        # Held across restart_coordinator's rebuild, which can acquire
        # coordinator/bus locks => must be clock-sourced (see core/clock.py).
        self._lock = clock.rlock()
        self._sos: Dict[str, StateObject] = {}
        self._factories: Dict[str, Callable[[], StateObject]] = {}
        self._overrides: Dict[str, dict] = {}
        self._stop = clock.event()
        self._refresher: Optional[SpawnHandle] = None
        if refresh_interval is not None:
            self._refresher = clock.spawn(
                lambda: self._refresh_loop(refresh_interval), name="dse-refresher"
            )

    # ------------------------------------------------------------------ #
    # deployment hooks (overridden by repro.net.NetCluster)              #
    # ------------------------------------------------------------------ #
    def _make_coordinator(self):
        """Build (or rebuild, after restart_coordinator) the coordinator."""
        return Coordinator(
            self.root / "coordinator.jsonl", clock=self.clock, **self._store_kw
        )

    def _coordinator_handle(self, so_id: str):
        """The coordinator handle a StateObject's runtime talks to. The base
        cluster hands out the coordinator object itself (direct in-process
        calls); NetCluster hands out a transport-backed proxy."""
        return self.coordinator

    # ------------------------------------------------------------------ #
    # membership                                                         #
    # ------------------------------------------------------------------ #
    def add(self, so_id: str, factory: Callable[[], StateObject], **overrides) -> StateObject:
        """Deploy a StateObject; ``factory`` is reused to build replacement
        incarnations after ``kill``."""
        so = factory()
        cfg = DSEConfig(
            so_id=so_id,
            coordinator=self._coordinator_handle(so_id),
            **{**self._defaults, **overrides},
        )
        so.Connect(cfg)
        with self._lock:
            self._sos[so_id] = so
            self._factories[so_id] = factory
            self._overrides[so_id] = overrides
        return so

    def get(self, so_id: str) -> StateObject:
        with self._lock:
            return self._sos[so_id]

    def members(self) -> List[str]:
        with self._lock:
            return list(self._sos.keys())

    # ------------------------------------------------------------------ #
    # failure injection                                                  #
    # ------------------------------------------------------------------ #
    def kill(self, so_id: str, *, restart: bool = True) -> Optional[StateObject]:
        """Crash the current incarnation (losing all volatile state) and, by
        default, immediately restart it — which triggers rollback recovery
        when the new incarnation re-Connects."""
        with self._lock:
            old = self._sos[so_id]
        old.runtime.mark_dead()
        crash = getattr(old, "on_crash", None)
        if callable(crash):
            crash()  # drop in-memory tiers / poison the store
        if not restart:
            with self._lock:
                self._sos.pop(so_id, None)
            return None
        return self._restart(so_id)

    def _restart(self, so_id: str) -> StateObject:
        so = self._factories[so_id]()
        cfg = DSEConfig(
            so_id=so_id,
            coordinator=self._coordinator_handle(so_id),
            **{**self._defaults, **self._overrides.get(so_id, {})},
        )
        so.Connect(cfg)
        with self._lock:
            self._sos[so_id] = so
        return so

    def checkpoint(self) -> None:
        """Snapshot-compact the coordinator's durable store (every shard, in
        sharded deployments) — the operator-facing arm of DESIGN.md §11;
        the size-threshold auto-trigger does the same thing unprompted."""
        self.coordinator.checkpoint()

    def restart_coordinator(self) -> None:
        """Simulate coordinator failure + recovery: a new coordinator replays
        the durable log and collects fragments from every participant."""
        with self._lock:
            old = self.coordinator
            self.coordinator = self._make_coordinator()
            for so in self._sos.values():
                so.runtime.coordinator = self._coordinator_handle(so.runtime.so_id)
        old.close()

    # ------------------------------------------------------------------ #
    # protocol driving                                                   #
    # ------------------------------------------------------------------ #
    def refresh_all(self) -> None:
        """One synchronous Refresh round (deterministic driving for tests)."""
        with self._lock:
            sos = list(self._sos.values())
        for so in sos:
            try:
                so.Refresh()
            except (CrashedError, TimeoutError):
                # TimeoutError: the transport fabric dropped this round's
                # coordinator RPCs (loss / partition); retry next round.
                pass

    def _refresh_loop(self, interval: float) -> None:
        while not self._stop.is_set():
            try:
                self.refresh_all()
            except Exception:
                # The background refresher must survive anything a faulty
                # fabric or a mid-restart incarnation throws; a dead refresher
                # silently freezes the boundary and undelivers decisions.
                # (Manual refresh_all still surfaces unexpected errors.)
                pass
            self._stop.wait(interval)

    # ------------------------------------------------------------------ #
    # transport helper                                                   #
    # ------------------------------------------------------------------ #
    @staticmethod
    def call(
        fn: Callable,
        *args,
        retries: int = 200,
        backoff: float = 0.002,
        clock: Clock = REAL_CLOCK,
        **kwargs,
    ):
        """Invoke a service handler with retry-on-delay semantics (what the
        gRPC integration layer does in the paper when a message arrives from
        a future failure epoch, Def 4.3)."""
        for _ in range(retries):
            try:
                return fn(*args, **kwargs)
            except DelayMessage:
                clock.sleep(backoff)
        raise TimeoutError("message delayed past retry budget")

    # ------------------------------------------------------------------ #
    # lifecycle                                                          #
    # ------------------------------------------------------------------ #
    def shutdown(self) -> None:
        self._stop.set()
        if self._refresher is not None:
            self._refresher.join(timeout=2.0)
        # Persist outstanding state so clean shutdown is not a failure
        # (paper §5.1: no explicit disconnect is needed if state is durable),
        # then DRAIN the async persist IO so directory teardown cannot race
        # in-flight writes.
        with self._lock:
            sos = list(self._sos.values())
        labels = []
        for so in sos:
            try:
                labels.append((so, so.runtime.maybe_persist(force=True)))
            except Exception:
                labels.append((so, None))
        deadline = self.clock.now() + 3.0
        for so, label in labels:
            if label is None:
                continue
            while self.clock.now() < deadline:
                try:
                    if so.runtime.stats()["committed"] >= label:
                        break
                except Exception:
                    break
                self.clock.sleep(0.002)
        self.coordinator.close()

    def wipe(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
