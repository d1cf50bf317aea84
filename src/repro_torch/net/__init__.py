"""repro.net — simulated transport fabric + sharded coordinator for
cluster-scale DSE (DESIGN.md §7).

Layers on top of ``repro.core``: the protocol is transport-agnostic (the
core passes ``Header`` objects where the paper passes gRPC HTTP headers);
this package supplies the fabric those headers ride on, with injectable
faults, batched delivery, and coordinator scale-out.
"""
from .transport import (
    DirectTransport,
    Envelope,
    LinkSpec,
    SimTransport,
    Transport,
    TransportError,
)
from .sharded import CoordinatorShard, DecisionBus, HashRing, ShardedCoordinator
from .cluster import NetCluster, RemoteCoordinator

__all__ = [
    "DirectTransport",
    "Envelope",
    "LinkSpec",
    "SimTransport",
    "Transport",
    "TransportError",
    "CoordinatorShard",
    "DecisionBus",
    "HashRing",
    "ShardedCoordinator",
    "NetCluster",
    "RemoteCoordinator",
]
