"""Speculative event broker (paper §5.2, "Event Broker") — Kafka/EventHubs
style topics over speculative logs, with DARQ-style exactly-once consumption
(consume → process → ack) and the Fig. 10 storage-bandwidth optimization:
events produced, consumed, and acked within a speculation window never
reach storage (their bytes are flushed as holes; the dependency recorded by
consuming the ack header makes this automatically safe — see spec_log.py).
"""
from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..core.ids import Header
from ..core.state_object import StateObject, VersionStore
from .spec_log import LogCore


class EventBroker(StateObject):
    def __init__(self, root: Path, topics: List[str], partitions: int = 1) -> None:
        super().__init__()
        self.root = Path(root)
        self.partitions = partitions
        self._cores: Dict[Tuple[str, int], LogCore] = {
            (t, p): LogCore(self.root / t / f"p{p}")
            for t in topics
            for p in range(partitions)
        }
        # (group, topic, partition) -> next offset to consume
        self._offsets: Dict[str, int] = {}
        self._offsets_store = VersionStore(self.root / "_offsets")
        self._mu = threading.Lock()

    @staticmethod
    def _okey(group: str, topic: str, part: int) -> str:
        return f"{group}/{topic}/{part}"

    # -- persistence backend -------------------------------------------------
    def Persist(self, version: int, metadata: bytes, callback: Callable[[], None]) -> None:
        world = self.runtime.world if self.connected else 0
        ios = [core.flush(world, version, metadata) for core in self._cores.values()]
        with self._mu:
            offsets_payload = json.dumps(self._offsets).encode()

        def _run() -> None:
            try:
                for io in ios:
                    io()
                # offsets last: a version is listable only once every
                # partition segment for it is already durable.
                self._offsets_store.write(version, offsets_payload, metadata)
            except RuntimeError:
                return
            callback()

        self.spawn_io(_run)

    def Restore(self, version: int) -> bytes:
        for core in self._cores.values():
            core.restore(version)
        payload, meta = self._offsets_store.read(version)
        with self._mu:
            self._offsets = json.loads(payload.decode())
        return meta

    def ListVersions(self) -> List[Tuple[int, bytes]]:
        return self._offsets_store.list_versions()

    def Prune(self, version: int) -> None:
        self._offsets_store.prune(version)
        for core in self._cores.values():
            core.prune(version)

    def on_crash(self) -> None:
        self._offsets_store.poison()
        self._offsets_store.drop_memory()
        for core in self._cores.values():
            core.poison()
            core.drop_memory()
        with self._mu:
            self._offsets = {}

    # -- service API ------------------------------------------------------------
    def produce(self, topic: str, events: List[bytes], header: Optional[Header] = None, part: int = 0):
        if not self.StartAction(header):
            return None
        core = self._cores[(topic, part)]
        offs = [core.append(e) for e in events]
        return offs, self.EndAction()

    def consume(self, group: str, topic: str, max_n: int = 64,
                header: Optional[Header] = None, part: int = 0):
        """Peek up to ``max_n`` events for ``group`` (offset advances at ack
        — DARQ-style exactly-once). Consuming REGISTERS the group: the
        speculative-prune floor only advances past offsets every registered
        group has acked, so a slow group never loses unacked events.
        Returns ([(offset, data)...], header)."""
        if not self.StartAction(header):
            return None
        core = self._cores[(topic, part)]
        with self._mu:
            key = self._okey(group, topic, part)
            start = self._offsets.setdefault(key, 0)
        events = core.scan(start, start + max_n)
        return events, self.EndAction()

    def ack(self, group: str, topic: str, upto: int,
            header: Optional[Header] = None, part: int = 0):
        """Advance ``group``'s offset past ``upto``. The consumer's header is
        consumed here, recording the dependency that makes speculative
        pruning of the acked prefix safe."""
        if not self.StartAction(header):
            return None
        key = self._okey(group, topic, part)
        core = self._cores[(topic, part)]
        with self._mu:
            self._offsets[key] = max(self._offsets.get(key, 0), upto + 1)
            # prune watermark = min over all groups consuming this partition
            floor = min(
                (
                    off
                    for k, off in self._offsets.items()
                    if k.split("/")[1] == topic and k.endswith(f"/{part}")
                ),
                default=0,
            )
        core.mark_consumed(floor)
        return self.EndAction()

    # -- accounting (Fig. 10) -----------------------------------------------------
    def storage_bytes_written(self) -> int:
        return sum(c.bytes_written for c in self._cores.values())

    def entries_skipped(self) -> int:
        return sum(c.entries_skipped for c in self._cores.values())

    def topic_tail(self, topic: str, part: int = 0) -> int:
        return self._cores[(topic, part)].tail()
