"""NetCluster — LocalCluster whose protocol traffic flows over a Transport.

Where :class:`~repro.core.cluster.LocalCluster` wires every StateObject and
the coordinator together with direct in-process calls, NetCluster routes
``call`` (service→service), ``report``, ``poll``, and fragment-resend
traffic through a :class:`~repro.net.transport.Transport` — by default a
:class:`~repro.net.transport.SimTransport`, so tests and benchmarks can
inject loss, latency, reordering, and partitions, and measure batched
delivery. ``Connect`` stays on the direct control plane: it is the rare
membership operation (the paper's Kubernetes-triggered path), not the hot
protocol loop, and in the real deployment it rides the orchestrator's
reliable channel.

With ``n_shards >= 1``, the coordinator is a
:class:`~repro.net.sharded.ShardedCoordinator`: each shard is a transport
endpoint (``coord/<i>``), and every StateObject's runtime talks to its home
shard through a :class:`RemoteCoordinator` proxy.

Runtime choice rides the same path as every other deployment knob: pass
``runtime="durable"`` (cluster-wide, via LocalCluster) or per-SO
``add(..., runtime="durable")`` and the member runs the synchronous
durable-execution baseline (:class:`~repro.durable.DurableRuntime`) over
exactly the same transport, proxies, and shard endpoints — its per-action
commit blocks on the report RPC through :class:`RemoteCoordinator`, so the
baseline pays real fabric round-trips where DSE pays none.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

from ..core import ids
from ..core.clock import Clock, REAL_CLOCK
from ..core.cluster import LocalCluster
from ..core.coordinator import Coordinator
from ..core.state_object import StateObject
from .sharded import ShardedCoordinator
from .transport import SimTransport, Transport


class RemoteCoordinator:
    """Participant-side coordinator handle whose hot-path traffic (report /
    poll / fragment resend) crosses the cluster transport. Resolves the
    cluster's *current* coordinator dynamically, so coordinator restarts do
    not strand stale references."""

    def __init__(self, cluster: "NetCluster", so_id: str) -> None:
        self._cluster = cluster
        self.so_id = so_id

    def _src(self) -> str:
        return f"so/{self.so_id}"

    def connect(self, so_id: str, fragments):
        # control plane: direct (see module docstring)
        return self._cluster.coordinator.connect(so_id, fragments)

    def report(self, so_id: str, reports):
        # Batch-encoded with one shared so_id table (DESIGN.md §9) — a
        # fragment resend names each dep SO once, not once per vertex.
        # Returns the coordinator's rejected-vertex list (admission ack).
        return self._cluster.transport.call(
            self._src(),
            self._cluster.coordinator_endpoint(so_id),
            "report",
            so_id,
            ids.encode_reports(list(reports)),
        )

    def receive_fragments(self, so_id: str, fragments) -> None:
        self._cluster.transport.call(
            self._src(),
            self._cluster.coordinator_endpoint(so_id),
            "receive_fragments",
            so_id,
            ids.encode_reports(list(fragments)),
        )

    def poll(self, so_id: str, known_world: int, known_boundary_seq: int = -1):
        return self._cluster.transport.call(
            self._src(),
            self._cluster.coordinator_endpoint(so_id),
            "poll",
            so_id,
            known_world,
            known_boundary_seq,
        )


class NetCluster(LocalCluster):
    def __init__(
        self,
        root: Path,
        *,
        transport: Optional[Transport] = None,
        n_shards: int = 0,
        clock: Clock = REAL_CLOCK,
        **kw,
    ) -> None:
        self.transport = transport if transport is not None else SimTransport(clock=clock)
        self.n_shards = n_shards
        super().__init__(root, clock=clock, **kw)

    # ------------------------------------------------------------------ #
    # deployment hooks                                                   #
    # ------------------------------------------------------------------ #
    def _make_coordinator(self):
        if self.n_shards:
            coord = ShardedCoordinator(
                self.root / "coord",
                n_shards=self.n_shards,
                clock=self.clock,
                **self._store_kw,
            )
            for shard in coord.shards:
                self.transport.register(
                    f"coord/{shard.shard_id}", self._shard_handler(shard.shard_id)
                )
        else:
            coord = Coordinator(self.root / "coordinator.jsonl", **self._store_kw)
            self.transport.register("coord", self._coord_handler())
        return coord

    def _coordinator_handle(self, so_id: str) -> RemoteCoordinator:
        return RemoteCoordinator(self, so_id)

    def coordinator_endpoint(self, so_id: str) -> str:
        if self.n_shards:
            return f"coord/{self.coordinator.shard_index(so_id)}"
        return "coord"

    # Handlers resolve through ``self.coordinator`` on every message so a
    # restarted coordinator (fresh object, same endpoint) keeps working.
    @staticmethod
    def _decode_args(method: str, args: tuple) -> tuple:
        """Report/fragment traffic arrives batch-encoded (see
        RemoteCoordinator); decode back to PersistReport lists."""
        if (
            method in ("report", "receive_fragments")
            and len(args) == 2
            and isinstance(args[1], (bytes, bytearray))
        ):
            return (args[0], ids.decode_reports(bytes(args[1])))
        return args

    def _coord_handler(self) -> Callable:
        def handle(method: str, *args, **kwargs):
            args = self._decode_args(method, args)
            return getattr(self.coordinator, method)(*args, **kwargs)

        return handle

    def _shard_handler(self, idx: int) -> Callable:
        def handle(method: str, *args, **kwargs):
            args = self._decode_args(method, args)
            return getattr(self.coordinator.shards[idx], method)(*args, **kwargs)

        return handle

    # ------------------------------------------------------------------ #
    # membership + service traffic                                       #
    # ------------------------------------------------------------------ #
    def add(self, so_id: str, factory: Callable[[], StateObject], **overrides) -> StateObject:
        self.transport.register(f"so/{so_id}", self._so_handler(so_id))
        return super().add(so_id, factory, **overrides)

    def _so_handler(self, so_id: str) -> Callable:
        def handle(method: str, *args, **kwargs):
            return getattr(self.get(so_id), method)(*args, **kwargs)

        return handle

    def send(self, src_id: Optional[str], dst_id: str, method: str, *args, **kwargs):
        """Service→service RPC across the fabric (the paper's instrumented
        gRPC call): DSE Headers ride in ``args``, delay-epoch messages are
        retried by the transport, and lost messages are retried with
        receiver-side dedup (exactly-once processing)."""
        src = f"so/{src_id}" if src_id else "client"
        return self.transport.call(src, f"so/{dst_id}", method, *args, **kwargs)

    # ------------------------------------------------------------------ #
    # failure injection                                                  #
    # ------------------------------------------------------------------ #
    def restart_shard(self, idx: int) -> None:
        """Crash-restart a single coordinator shard (sharded mode only)."""
        self.coordinator.restart_shard(idx)

    # ------------------------------------------------------------------ #
    # lifecycle                                                          #
    # ------------------------------------------------------------------ #
    def shutdown(self) -> None:
        super().shutdown()
        self.transport.close()
