"""repro.sim — deterministic simulation for the whole DSE stack
(DESIGN.md §8).

FoundationDB-style: virtual time + a seeded cooperative scheduler
(:mod:`~repro.sim.scheduler`), seeded fault schedules
(:mod:`~repro.sim.faults`), machine-checked invariants including a
Wing–Gong linearizability checker (:mod:`~repro.sim.invariants`), a
:class:`~repro.sim.cluster.SimCluster` facade that runs any existing
service unmodified under simulation, and a seed-sweep driver with fault
plan shrinking (:mod:`~repro.sim.explore`).
"""
from .scheduler import (
    SimClock,
    SimDeadlock,
    SimScheduler,
    SimTaskError,
    SimTimeout,
    TaskCancelled,
)
from .faults import FaultEvent, FaultPlan
from .invariants import (
    CounterModel,
    InvariantViolation,
    KVModel,
    Op,
    PENDING,
    WatermarkMonitor,
    check_exactly_once_counter,
    check_linearizable,
    check_shard_logs,
)
from .cluster import RecordingClient, SimCluster, SimResult

#: explore is imported lazily: eager import here would make the documented
#: ``python -m repro.sim.explore`` CLI execute the module twice (runpy's
#: found-in-sys.modules RuntimeWarning, with duplicated module state).
_EXPLORE_EXPORTS = ("SCENARIOS", "default_plan", "run_one", "shrink", "sweep")


def __getattr__(name):
    if name in _EXPLORE_EXPORTS:
        from . import explore

        return getattr(explore, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "SimClock",
    "SimDeadlock",
    "SimScheduler",
    "SimTaskError",
    "SimTimeout",
    "TaskCancelled",
    "FaultEvent",
    "FaultPlan",
    "CounterModel",
    "InvariantViolation",
    "KVModel",
    "Op",
    "PENDING",
    "WatermarkMonitor",
    "check_exactly_once_counter",
    "check_linearizable",
    "check_shard_logs",
    "RecordingClient",
    "SimCluster",
    "SimResult",
    "SCENARIOS",
    "default_plan",
    "run_one",
    "shrink",
    "sweep",
]
