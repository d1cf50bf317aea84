"""Speculative cloud building blocks (paper §5.2): write-ahead log,
key-value store, workflow engine, event broker — plus the two-phase commit
application (paper §6.1) built from them."""
from .spec_log import LogCore, SpeculativeLog
from .kv_store import SpeculativeKVStore
from .workflow import WorkflowEngine
from .broker import EventBroker
from .two_phase_commit import TwoPCCoordinator, TwoPCParticipant, TwoPCClient

__all__ = [
    "LogCore",
    "SpeculativeLog",
    "SpeculativeKVStore",
    "WorkflowEngine",
    "EventBroker",
    "TwoPCCoordinator",
    "TwoPCParticipant",
    "TwoPCClient",
]
