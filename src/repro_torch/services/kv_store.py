"""Speculative key-value store (paper §5.2, FASTER-based in the original).

State is a hash map; ``Persist`` snapshots it into a multi-version store
(in-memory fast tier + durable blobs), mirroring FASTER's CPR-style
checkpointing at our abstraction level. Includes the stored procedures used
by the TravelReservations workload (paper §6.1): conditional reserve /
release over inventory counts.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..core.ids import Header
from ..core.state_object import StateObject, VersionStore


class SpeculativeKVStore(StateObject):
    def __init__(self, root: Path, io_ms: float = 0.0) -> None:
        super().__init__()
        self.store = VersionStore(root, simulate_io_ms=io_ms)
        self._map: Dict[str, str] = {}
        self._mu = threading.Lock()

    # -- persistence backend -------------------------------------------------
    def Persist(self, version: int, metadata: bytes, callback: Callable[[], None]) -> None:
        with self._mu:
            payload = json.dumps(self._map).encode()

        def _io() -> None:
            try:
                self.store.write(version, payload, metadata)
            except RuntimeError:
                return
            callback()

        self.spawn_io(_io)

    def Restore(self, version: int) -> bytes:
        payload, meta = self.store.read(version)
        with self._mu:
            self._map = json.loads(payload.decode())
        return meta

    def ListVersions(self) -> List[Tuple[int, bytes]]:
        return self.store.list_versions()

    def Prune(self, version: int) -> None:
        self.store.prune(version)

    def on_crash(self) -> None:
        self.store.poison()
        self.store.drop_memory()
        with self._mu:
            self._map = {}

    # -- service API -----------------------------------------------------------
    def get(self, key: str, header: Optional[Header] = None):
        if not self.StartAction(header):
            return None
        with self._mu:
            val = self._map.get(key)
        return val, self.EndAction()

    def put(self, key: str, value: str, header: Optional[Header] = None):
        if not self.StartAction(header):
            return None
        with self._mu:
            self._map[key] = value
        return self.EndAction()

    def delete(self, key: str, header: Optional[Header] = None):
        if not self.StartAction(header):
            return None
        with self._mu:
            self._map.pop(key, None)
        return self.EndAction()

    # -- stored procedures (TravelReservations, paper §6.1) ---------------------
    def stock(self, item: str, count: int, header: Optional[Header] = None):
        if not self.StartAction(header):
            return None
        with self._mu:
            self._map[f"inv:{item}"] = str(count)
        return self.EndAction()

    def try_reserve(self, item: str, owner: str, header: Optional[Header] = None):
        """Atomically decrement inventory; returns (ok, header) or None.

        Idempotent per (item, owner): a retried step whose first application
        survived (driver retry after a lost reply / workflow resume) must not
        double-decrement — the standard idempotency-key requirement of
        durable-execution activities (Temporal/Beldi), and what keeps the
        DSE-vs-durable differential oracle exact under crash faults.
        """
        if not self.StartAction(header):
            return None
        with self._mu:
            if self._map.get(f"res:{item}:{owner}") == "1":
                ok = True  # already applied: ack again without re-decrementing
            else:
                left = int(self._map.get(f"inv:{item}", "0"))
                ok = left > 0
                if ok:
                    self._map[f"inv:{item}"] = str(left - 1)
                    self._map[f"res:{item}:{owner}"] = "1"
        return ok, self.EndAction()

    def release(self, item: str, owner: str, header: Optional[Header] = None):
        """Saga compensation: undo a reservation."""
        if not self.StartAction(header):
            return None
        with self._mu:
            if self._map.pop(f"res:{item}:{owner}", None) is not None:
                self._map[f"inv:{item}"] = str(int(self._map.get(f"inv:{item}", "0")) + 1)
        return self.EndAction()
