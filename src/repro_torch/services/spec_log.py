"""Speculative write-ahead log (paper §5.2, "Speculative Log").

Mirrors the paper's FasterLog wrapper: *commit records* (one per Persist)
carry the libDSE metadata and mark the durable frontier; recovering or
rolling back "simply drops all log entries after the latest surviving
commit record", driven by an in-memory commit map for speed (the paper's
multiversioning fast path).

On disk each commit is one *segment* file holding the entries appended
since the previous commit. Rolled-back versions can be re-persisted under
the same numeric label by a later incarnation; segments are therefore named
``seg_<world>_<version>`` and readers dedupe by version keeping the highest
world (new labels always start above the rollback target, so duplicates can
only involve rolled-back versions — see DESIGN.md §2).

Speculative pruning (the paper's Fig. 10 storage-bandwidth saving): a
consumer may ``mark_consumed`` a prefix *inside an action*, making the
producer's next Persist skip those entries' bytes ("holes"). Correctness is
automatic from the dependency graph: consuming the ack header inside an
action makes the skipping version depend on the consumer's vertex, so if
the consumption is ever lost, the hole-bearing version is rolled back with
it and the entries are regenerated upstream.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..core.ids import Header
from ..core.state_object import StateObject


class LogCore:
    """Embeddable speculative log (no DSE wiring) — the broker reuses this
    per (topic, partition); :class:`SpeculativeLog` wraps exactly one."""

    def __init__(self, root: Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        self._entries: List[Optional[bytes]] = []  # None = pruned hole
        self._flushed_upto = 0                     # entries covered by segments
        self._prune_upto = 0                       # speculative-prune watermark
        self._commits: Dict[int, int] = {}         # version -> commit offset
        self._poisoned = False
        self.bytes_written = 0                     # Fig. 10 accounting
        self.entries_skipped = 0

    # -- appends / reads ---------------------------------------------------
    def append(self, data: bytes) -> int:
        with self._lock:
            self._entries.append(data)
            return len(self._entries) - 1

    def read(self, offset: int) -> Optional[bytes]:
        with self._lock:
            return self._entries[offset]

    def scan(self, start: int, end: Optional[int] = None) -> List[Tuple[int, bytes]]:
        with self._lock:
            end = len(self._entries) if end is None else min(end, len(self._entries))
            return [
                (i, self._entries[i])
                for i in range(start, end)
                if self._entries[i] is not None
            ]

    def tail(self) -> int:
        with self._lock:
            return len(self._entries)

    def mark_consumed(self, upto: int) -> None:
        """Entries below ``upto`` need not reach storage (caller must record
        the dependency on the consumer by receiving its header in the same
        action that triggers this)."""
        with self._lock:
            self._prune_upto = max(self._prune_upto, upto)

    # -- persistence -------------------------------------------------------
    def poison(self) -> None:
        self._poisoned = True

    def drop_memory(self) -> None:
        with self._lock:
            self._entries = []
            self._commits = {}
            self._flushed_upto = 0
            self._prune_upto = 0

    def flush(self, world: int, version: int, metadata: bytes) -> Callable[[], None]:
        """Capture the commit snapshot; return the (synchronous) IO closure.

        Must be called with actions quiesced (the runtime's exclusive epoch);
        the returned closure may run on any thread.
        """
        with self._lock:
            commit_offset = len(self._entries)
            start = self._flushed_upto
            batch: List[Optional[bytes]] = []
            skipped = 0
            for i in range(start, commit_offset):
                e = self._entries[i]
                if e is not None and i < self._prune_upto:
                    # speculatively-pruned: write a hole, not the bytes
                    self._entries[i] = None
                    e = None
                if e is None:
                    skipped += 1
                batch.append(e)
            self._flushed_upto = commit_offset
            self._commits[version] = commit_offset
        rec = {
            "world": world,
            "version": version,
            "start": start,
            "count": len(batch),
            "meta": metadata.hex(),
            "entries": [None if e is None else e.hex() for e in batch],
        }
        self.entries_skipped += skipped

        def _io() -> None:
            if self._poisoned:
                raise RuntimeError("LogCore poisoned (incarnation crashed)")
            data = json.dumps(rec).encode()
            tmp = self.root / f".seg_{world:04d}_{version:010d}.tmp"
            final = self.root / f"seg_{world:04d}_{version:010d}.json"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            if self._poisoned:  # never PUBLISH from a crashed incarnation
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise RuntimeError("LogCore poisoned (incarnation crashed)")
            os.replace(tmp, final)
            self.bytes_written += len(data)

        return _io

    # -- recovery ----------------------------------------------------------
    def _disk_segments(self) -> List[dict]:
        """All segments, deduped by version keeping the highest world."""
        best: Dict[int, dict] = {}
        for p in sorted(self.root.glob("seg_*.json")):
            try:
                rec = json.loads(p.read_text())
            except Exception:
                continue
            v = rec["version"]
            if v not in best or rec["world"] > best[v]["world"]:
                best[v] = rec
        return [best[v] for v in sorted(best)]

    def restore(self, version: int) -> bytes:
        """Roll back (fast path: in-memory truncate) or reload from disk."""
        with self._lock:
            if version in self._commits and self._commits[version] <= len(self._entries):
                # fast path: multiversioned in-memory rollback
                off = self._commits[version]
                self._entries = self._entries[:off]
                self._flushed_upto = min(self._flushed_upto, off)
                self._prune_upto = min(self._prune_upto, off)
                self._commits = {v: o for v, o in self._commits.items() if v <= version}
                meta = b""
                for rec in self._disk_segments():
                    if rec["version"] == version:
                        meta = bytes.fromhex(rec["meta"])
                return meta
            # crash path: rebuild the entry list from the segment chain
            entries: List[Optional[bytes]] = []
            commits: Dict[int, int] = {}
            meta = b""
            for rec in self._disk_segments():
                if rec["version"] > version:
                    break
                assert rec["start"] == len(entries), "segment chain mismatch"
                entries.extend(
                    None if e is None else bytes.fromhex(e) for e in rec["entries"]
                )
                commits[rec["version"]] = len(entries)
                if rec["version"] == version:
                    meta = bytes.fromhex(rec["meta"])
            self._entries = entries
            self._flushed_upto = len(entries)
            self._prune_upto = 0
            self._commits = commits
            return meta

    def _floor(self) -> int:
        try:
            return int((self.root / "floor").read_text())
        except (FileNotFoundError, ValueError):
            return -1

    def list_versions(self) -> List[Tuple[int, bytes]]:
        """Commit records at or above the durable floor's anchor — the
        greatest persisted version <= the floor stays listable (the anchor
        contract of ``StateObject.Prune``), everything below it is pruned
        from the listing so reconnects/resends ship O(live), not the whole
        segment history (DESIGN.md §11)."""
        recs = self._disk_segments()
        floor = self._floor()
        anchor = max((r["version"] for r in recs if r["version"] <= floor), default=None)
        return [
            (rec["version"], bytes.fromhex(rec["meta"]))
            for rec in recs
            if anchor is None or rec["version"] >= anchor
        ]

    def prune(self, version: int) -> None:
        """Older *commit records* may be forgotten. Data segments are kept —
        they are the restore chain — but their commit entries drop from the
        in-memory map and from ListVersions via a floor marker."""
        floor = self.root / "floor"
        tmp = self.root / ".floor.tmp"
        tmp.write_text(str(version))
        os.replace(tmp, floor)


class SpeculativeLog(StateObject):
    """One LogCore exposed as a libDSE StateObject service."""

    def __init__(self, root: Path) -> None:
        super().__init__()
        self.core = LogCore(root)

    # -- persistence backend ------------------------------------------------
    def Persist(self, version: int, metadata: bytes, callback: Callable[[], None]) -> None:
        world = self.runtime.world if self.connected else 0
        io = self.core.flush(world, version, metadata)

        def _run() -> None:
            try:
                io()
            except RuntimeError:
                return
            callback()

        self.spawn_io(_run)

    def Restore(self, version: int) -> bytes:
        return self.core.restore(version)

    def ListVersions(self) -> List[Tuple[int, bytes]]:
        return self.core.list_versions()

    def Prune(self, version: int) -> None:
        self.core.prune(version)

    def on_crash(self) -> None:
        self.core.poison()
        self.core.drop_memory()

    # -- service API ---------------------------------------------------------
    def append(self, data: bytes, header: Optional[Header] = None):
        """Append one entry. Returns (offset, response_header) or None if the
        sender's state was rolled back (message must be discarded)."""
        if not self.StartAction(header):
            return None
        off = self.core.append(data)
        return off, self.EndAction()

    def read(self, offset: int, header: Optional[Header] = None):
        if not self.StartAction(header):
            return None
        data = self.core.read(offset)
        return data, self.EndAction()

    def scan(self, start: int, end: Optional[int] = None, header: Optional[Header] = None):
        if not self.StartAction(header):
            return None
        out = self.core.scan(start, end)
        return out, self.EndAction()

    def truncate_consumed(self, upto: int, header: Optional[Header] = None):
        """Consumer ack: entries below ``upto`` may skip storage. The ack
        header is consumed in this action so the dependency is recorded."""
        if not self.StartAction(header):
            return None
        self.core.mark_consumed(upto)
        return self.EndAction()
