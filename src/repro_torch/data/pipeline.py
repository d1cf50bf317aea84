"""Deterministic, checkpointable synthetic LM data pipeline.

``batch_at(step)`` is a pure function of (seed, step): any replay after a
rollback reproduces the exact byte-identical batch, which is what makes the
end-to-end determinism test (failure run == failure-free run) meaningful.
The cursor is a libDSE StateObject so batch lineage participates in the
recovery dependency graph: the trainer consumes the cursor's header each
step, giving the data->trainer edge from DESIGN.md §2.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..core.ids import Header
from ..core.state_object import StateObject, VersionStore


class SyntheticLMData:
    """Zipf-ish token stream with a little structure (ngram repetition) so
    losses actually decrease during the example runs."""

    def __init__(self, vocab_size: int, global_batch: int, seq_len: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        # zipf-like marginal over the vocab
        u = rng.random((self.global_batch, self.seq_len + 1))
        toks = np.floor((self.vocab_size - 1) * u ** 3.0).astype(np.int32)
        # inject determinism-friendly structure: repeat the first half-gram
        half = (self.seq_len + 1) // 2
        toks[:, half : 2 * half] = toks[:, :half]
        return toks


class DataPipelineStateObject(StateObject):
    """Checkpointable stream cursor. ``next_batch`` is an action producing
    the batch AND a header the trainer consumes (lineage edge)."""

    def __init__(self, root: Path, data: SyntheticLMData) -> None:
        super().__init__()
        self.store = VersionStore(root)
        self.data = data
        self.cursor = 0
        self._mu = threading.Lock()

    # -- persistence ---------------------------------------------------------
    def Persist(self, version: int, metadata: bytes, callback: Callable[[], None]) -> None:
        with self._mu:
            payload = json.dumps({"cursor": self.cursor}).encode()

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
            self.cursor = json.loads(payload.decode())["cursor"]
        return meta

    def ListVersions(self) -> List[Tuple[int, bytes]]:
        return self.store.list_versions()

    def Prune(self, version: int) -> None:
        self.store.prune(version)

    def on_crash(self) -> None:
        self.store.poison()
        self.store.drop_memory()
        with self._mu:
            self.cursor = 0

    # -- service API -----------------------------------------------------------
    def next_batch(self, header: Optional[Header] = None):
        """Returns (step, tokens, header) or None if sender rolled back."""
        if not self.StartAction(header):
            return None
        with self._mu:
            step = self.cursor
            self.cursor += 1
        tokens = self.data.batch_at(step)
        return step, tokens, self.EndAction()

    def peek_cursor(self) -> int:
        with self._mu:
            return self.cursor

    def seek(self, step: int, header: Optional[Header] = None):
        """Reset the cursor (used when the trainer resumes from an older
        checkpoint than the cursor — control flow is persisted state)."""
        if not self.StartAction(header):
            return None
        with self._mu:
            self.cursor = step
        return self.EndAction()
