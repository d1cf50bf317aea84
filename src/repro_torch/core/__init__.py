"""libDSE core — the paper's contribution: distributed speculative execution
via message-passing StateObjects, atomic actions, sthreads, speculation
barriers, and a DPR-derived recovery protocol with a stateless coordinator.
"""
from .clock import Clock, REAL_CLOCK, RealClock
from .ids import DecisionIndex, Header, PersistReport, RollbackDecision, Vertex
from .epoch import EpochRWLock
from .graph import DependencyGraph
from .state_object import StateObject, VersionStore
from .runtime import CrashedError, DSEConfig, DSERuntime
from .sthread import DelayMessage, RolledBackError, SThread
from .coordinator import ConnectResponse, Coordinator, PollResponse
from .cluster import LocalCluster

__all__ = [
    "Clock",
    "REAL_CLOCK",
    "RealClock",
    "DecisionIndex",
    "Header",
    "PersistReport",
    "RollbackDecision",
    "Vertex",
    "EpochRWLock",
    "DependencyGraph",
    "StateObject",
    "VersionStore",
    "CrashedError",
    "DSEConfig",
    "DSERuntime",
    "DelayMessage",
    "RolledBackError",
    "SThread",
    "ConnectResponse",
    "Coordinator",
    "PollResponse",
    "LocalCluster",
]
