"""SimCluster — run any existing DSE service unmodified under deterministic
simulation (DESIGN.md §8).

Wraps a :class:`~repro.net.cluster.NetCluster` whose transport, runtimes,
coordinator shards, and background threads all draw their time and blocking
primitives from one :class:`~repro.sim.scheduler.SimScheduler`. A scenario
is a plain function ``scenario(sim) -> value`` executed as the root
simulation task; a :class:`~repro.sim.faults.FaultPlan` is installed as a
parallel driver task; the run returns a :class:`SimResult` carrying the
value, the byte-exact event trace, recorded operation history, and
watermark samples for the invariant checkers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from ..core.runtime import CrashedError
from ..net import LinkSpec, NetCluster, SimTransport
from .faults import FaultEvent, FaultPlan
from .invariants import Op, PENDING, WatermarkMonitor
from .scheduler import SimScheduler


@dataclass
class SimResult:
    value: Any
    trace: str
    events: int
    virtual_time: float
    transport_stats: Dict[str, float] = field(default_factory=dict)
    history: List[Op] = field(default_factory=list)
    watermarks: Optional[WatermarkMonitor] = None


class SimCluster:
    """One deterministic run of a (possibly sharded) DSE cluster.

    Everything — cluster construction included — happens inside the
    simulation, because ``Connect`` synchronously persists version 0 and
    that wait must be virtual. Use::

        sim = SimCluster(tmp_path, seed=7, n_shards=2)
        result = sim.run(scenario, plan=FaultPlan.random(7, ...))
    """

    def __init__(
        self,
        root: Path,
        *,
        seed: int = 0,
        n_shards: int = 0,
        default_link: Optional[LinkSpec] = None,
        refresh_interval: Optional[float] = 0.005,
        group_commit_interval: float = 0.010,
        retry_timeout: float = 0.01,
        call_timeout: float = 30.0,
        max_virtual_time: float = 600.0,
        runtime: str = "dse",
        **cluster_kw,
    ) -> None:
        #: ``runtime`` picks the execution engine every service Connects
        #: with — "dse" (speculative) or "durable" (synchronous baseline,
        #: repro.durable). The differential oracle (sim/differential.py)
        #: replays one scenario under both and diffs committed results.
        self.root = Path(root)
        self.seed = seed
        self.n_shards = n_shards
        self.scheduler = SimScheduler(seed=seed)
        self.clock = self.scheduler.clock
        self.max_virtual_time = max_virtual_time
        self._transport_kw = dict(
            # independent stream, deterministically derived from the seed
            seed=(seed * 2654435761 + 97) % (2**31),
            default_link=default_link,
            retry_timeout=retry_timeout,
            call_timeout=call_timeout,
        )
        self.runtime = runtime
        self._cluster_kw = dict(
            refresh_interval=refresh_interval,
            group_commit_interval=group_commit_interval,
            runtime=runtime,
            **cluster_kw,
        )
        self.transport: Optional[SimTransport] = None
        self.cluster: Optional[NetCluster] = None
        self.history: List[Op] = []
        self.watermarks = WatermarkMonitor()
        self._monitoring = False

    # ------------------------------------------------------------------ #
    # run harness                                                        #
    # ------------------------------------------------------------------ #
    def run(
        self,
        scenario: Callable[["SimCluster"], Any],
        *,
        plan: Optional[FaultPlan] = None,
        monitor_interval: Optional[float] = 0.02,
    ) -> SimResult:
        box: Dict[str, Any] = {}

        def main() -> None:
            self.transport = SimTransport(clock=self.clock, **self._transport_kw)
            self.cluster = NetCluster(
                self.root / "cluster",
                transport=self.transport,
                n_shards=self.n_shards,
                clock=self.clock,
                **self._cluster_kw,
            )
            if plan is not None:
                self._install_plan(plan)
            if monitor_interval is not None:
                self._start_monitor(monitor_interval)
            try:
                box["value"] = scenario(self)
            finally:
                self._monitoring = False
                try:
                    self.cluster.shutdown()
                except Exception:
                    pass  # teardown under residual faults must not mask results

        self.scheduler.run(main, max_virtual_time=self.max_virtual_time)
        return SimResult(
            value=box.get("value"),
            trace=self.scheduler.trace_text(),
            events=self.scheduler.events,
            virtual_time=self.scheduler.now,
            transport_stats=self.transport.stats() if self.transport else {},
            history=list(self.history),
            watermarks=self.watermarks,
        )

    # ------------------------------------------------------------------ #
    # fault plan driving                                                 #
    # ------------------------------------------------------------------ #
    def _install_plan(self, plan: FaultPlan) -> None:
        events = plan.sorted_events()

        def driver() -> None:
            t0 = self.clock.now()
            for ev in events:
                self.clock.sleep(max(0.0, t0 + ev.at - self.clock.now()))
                try:
                    self.apply_fault(ev)
                except KeyError:
                    pass  # fault targeted a service the scenario never added

        self.clock.spawn(driver, name="fault-driver")

    def apply_fault(self, ev: FaultEvent) -> None:
        assert self.cluster is not None and self.transport is not None
        arg = ev.arg
        if ev.kind == "crash":
            self.cluster.kill(str(arg["so_id"]), restart=bool(arg.get("restart", True)))
        elif ev.kind == "restart_shard":
            if self.n_shards:
                self.cluster.restart_shard(int(arg["idx"]) % self.n_shards)
        elif ev.kind == "restart_coordinator":
            self.cluster.restart_coordinator()
        elif ev.kind == "checkpoint":
            # a no-op on clusters built with compaction disabled — the
            # store owns that contract (CompactingLog.checkpoint), so the
            # snapshot-vs-replay differential can replay one plan on both
            # configurations without per-site guards.
            self.cluster.checkpoint()
        elif ev.kind == "partition":
            self.transport.partition(*[set(g) for g in arg["groups"]])
        elif ev.kind == "heal":
            self.transport.heal()
        elif ev.kind == "link":
            self.transport.set_link(str(arg["src"]), str(arg["dst"]), **dict(arg.get("spec", {})))
        elif ev.kind == "method_link":
            self.transport.set_method_link(str(arg["method"]), **dict(arg.get("spec", {})))
        elif ev.kind == "clear_method_link":
            self.transport.clear_method_link(str(arg["method"]))
        else:
            raise ValueError(f"unknown fault kind {ev.kind!r}")

    # ------------------------------------------------------------------ #
    # watermark monitor                                                  #
    # ------------------------------------------------------------------ #
    def _start_monitor(self, interval: float) -> None:
        self._monitoring = True

        def monitor() -> None:
            while self._monitoring:
                try:
                    boundary = self.cluster.coordinator.current_boundary()
                    fsn = self._fsn()
                    self.watermarks.sample(self.clock.now(), fsn, boundary)
                except Exception:
                    pass  # coordinator mid-restart: skip the sample
                self.clock.sleep(interval)

        self.clock.spawn(monitor, name="watermark-monitor")

    def _fsn(self) -> int:
        coord = self.cluster.coordinator
        if self.n_shards:
            return coord.bus.fsn()
        return int(coord.stats()["fsn"])

    # ------------------------------------------------------------------ #
    # scenario-side conveniences (delegate to the wrapped cluster)       #
    # ------------------------------------------------------------------ #
    def add(self, so_id: str, factory, **overrides):
        return self.cluster.add(so_id, factory, **overrides)

    def get(self, so_id: str):
        return self.cluster.get(so_id)

    def send(self, src_id, dst_id, method, *args, **kwargs):
        return self.cluster.send(src_id, dst_id, method, *args, **kwargs)

    def sleep(self, seconds: float) -> None:
        self.clock.sleep(seconds)

    def spawn(self, fn, *, name: Optional[str] = None):
        return self.clock.spawn(fn, name=name)

    def boundary(self) -> Optional[Dict[str, int]]:
        return self.cluster.coordinator.current_boundary()

    def settle(
        self,
        predicate: Callable[[], bool],
        *,
        timeout: float = 30.0,
        interval: float = 0.02,
    ) -> bool:
        """Deadline-poll ``predicate`` in virtual time, driving refresh
        rounds — the simulation twin of ``tests/conftest.settle``."""
        deadline = self.clock.now() + timeout
        while self.clock.now() < deadline:
            self.cluster.refresh_all()
            if predicate():
                return True
            self.clock.sleep(interval)
        return predicate()


class RecordingClient:
    """A client task identity that records every operation (invocation /
    response in virtual time) into ``sim.history`` for the linearizability
    checker, chaining DSE headers per client."""

    def __init__(self, sim: SimCluster, store_id: str, name: str) -> None:
        self.sim = sim
        self.store_id = store_id
        self.name = name
        self.header = None

    def _record(self, method: str, args: tuple, result, invoked, returned) -> None:
        self.sim.history.append(
            Op(self.name, method, args, result, invoked, returned)
        )

    def op(self, method: str, *args):
        """Issue ``method(*args, header)`` against the store; returns the
        service result, or None if the op is pending (timeout/crash)."""
        invoked = self.sim.clock.now()
        try:
            res = self.sim.send(self.name, self.store_id, method, *args, self.header)
        except (TimeoutError, CrashedError):
            # the request may or may not have been applied: pending forever
            self._record(method, args, PENDING, invoked, None)
            self.header = None
            return None
        returned = self.sim.clock.now()
        if res is None:
            # discarded (our header's deps were rolled back): no effect — do
            # not record; the client restarts its causal chain.
            self.header = None
            return None
        if method == "get":
            value, self.header = res
            self._record(method, args, value, invoked, returned)
            return value
        if method == "increment":
            value, self.header = res
            self._record(method, args, value, invoked, returned)
            return value
        # put / delete / stock: result is just the response header
        self.header = res
        self._record(method, args, "ok", invoked, returned)
        return res

    # sugar for the KV scenarios
    def put(self, key: str, value: str):
        return self.op("put", key, value)

    def get(self, key: str):
        return self.op("get", key)

    def delete(self, key: str):
        return self.op("delete", key)
