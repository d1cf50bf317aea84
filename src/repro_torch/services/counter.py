"""The paper's running example (Figs. 1/3/4): an increment-counter service.
Used by tests, microbenchmarks, and the quickstart example."""
from __future__ import annotations

import threading
from pathlib import Path
from typing import Callable, List, Optional, Tuple

from ..core.ids import Header
from ..core.state_object import StateObject, VersionStore


class CounterStateObject(StateObject):
    def __init__(self, root: Path, io_ms: float = 0.0) -> None:
        super().__init__()
        self.store = VersionStore(root, simulate_io_ms=io_ms)
        self.value = 0
        self._vlock = threading.Lock()

    # -- persistence backend (paper Table 1 / Fig. 3) ----------------------
    def Persist(self, version: int, metadata: bytes, callback: Callable[[], None]) -> None:
        payload = self.value.to_bytes(8, "little", signed=True)

        def _io() -> None:
            try:
                self.store.write(version, payload, metadata)
            except RuntimeError:
                return  # crashed incarnation never acks durability
            callback()

        self.spawn_io(_io)

    def Restore(self, version: int) -> bytes:
        payload, meta = self.store.read(version)
        self.value = int.from_bytes(payload, "little", signed=True)
        return meta

    def ListVersions(self) -> List[Tuple[int, bytes]]:
        return self.store.list_versions()

    def Prune(self, version: int) -> None:
        self.store.prune(version)

    def on_crash(self) -> None:
        self.store.poison()
        self.store.drop_memory()

    # -- service API (paper Fig. 4) ------------------------------------------
    def increment(self, header: Optional[Header] = None, by: int = 1):
        """Returns (new_value, response_header), or None if the sender's
        state was rolled back (message discarded)."""
        if not self.StartAction(header):
            return None
        with self._vlock:
            self.value += by
            v = self.value
        return v, self.EndAction()
