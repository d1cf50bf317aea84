"""CompactingLog — the coordinator's durable store: a JSONL write-ahead log
with atomic snapshot + log-rotation checkpoints (DESIGN.md §11).

Layout, for a base path ``<p>`` (e.g. ``coord/shard0.jsonl``):

* generation 0 (the pre-snapshot legacy layout): the WAL is ``<p>`` itself,
  there is no snapshot and no manifest — a seed-era log directory recovers
  unchanged;
* generation ``N >= 1``: snapshot ``<p>.snap.N``, WAL ``<p>.wal.N``, and a
  manifest ``<p>.manifest`` naming ``N``.

``checkpoint(blob)`` is crash-safe by construction: the snapshot is written
to a temp file, fsynced, renamed into place and the directory fsynced;
a fresh empty WAL is created; only then is the manifest atomically swapped
(temp + fsync + rename). The manifest swap is the *commit point* — a crash
at any earlier step leaves the old manifest naming the old generation,
whose snapshot and WAL are untouched (appends during a checkpoint are
serialized out by the coordinator lock, and the old WAL keeps receiving
them until the swap), so recovery sees either the full old generation or
the full new one, never a mix. Orphaned files from an interrupted
checkpoint are deleted on the next open/checkpoint. The exhaustive
crash-point test (``tests/test_store.py``) kills the checkpoint after
every step via ``_failpoint`` and asserts recovery from every prefix.

Replay order is ``(snapshot blob, suffix records)``: the caller restores
state from the snapshot, then applies the JSONL suffix (same torn-tail
tolerance as the seed-era log).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional, Tuple

from .snapshot import decode_manifest, encode_manifest


class CheckpointCrash(RuntimeError):
    """Raised by ``checkpoint(_failpoint=...)`` to simulate a crash after
    the named step completed (test-only; the instance must be discarded)."""


#: ordered checkpoint steps a crash can land after (see checkpoint())
FAILPOINTS = (
    "begin",
    "snap-tmp-written",
    "snap-renamed",
    "snap-dir-synced",
    "wal-created",
    "manifest-tmp-written",
    "manifest-swapped",
    "rotated",
)


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir-open support
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# -- layout resolution + parsing, shared by CompactingLog.replay() and the  --
# -- read-only helper below: one implementation, one torn-tail semantics   --
def _manifest_path(base: Path) -> Path:
    return base.with_name(base.name + ".manifest")


def _wal_path(base: Path, gen: int) -> Path:
    return base if gen == 0 else base.with_name(f"{base.name}.wal.{gen}")


def _snap_path(base: Path, gen: int) -> Path:
    return base.with_name(f"{base.name}.snap.{gen}")


def _read_generation(base: Path) -> int:
    try:
        return decode_manifest(_manifest_path(base).read_bytes())
    except FileNotFoundError:
        return 0
    # a corrupt manifest is NOT silently treated as generation 0: the swap
    # is atomic, so corruption means real storage damage and a gen-0
    # fallback could resurrect long-compacted state. Let it raise.


def _read_jsonl(path: Path) -> List[dict]:
    out: List[dict] = []
    try:
        raw = path.read_bytes()
    except FileNotFoundError:
        return out
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line.decode()))
        except Exception:
            break  # torn tail write: ignore the partial record
    return out


class CompactingLog:
    """Synchronous durable appends + atomic snapshot/rotate checkpoints.

    The interface the coordinator needs is unchanged from the seed-era
    ``CoordinatorLog`` (ordered, durable ``append`` + full ``replay``) plus
    ``checkpoint`` and the size counters that drive auto-compaction; in
    production the same interface maps onto Netherite-style partition
    checkpoints over a commit log (paper Fig. 8).
    """

    def __init__(
        self,
        path: Path,
        *,
        checkpoint_records: Optional[int] = 256,
        checkpoint_bytes: int = 1 << 20,
    ) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._manifest = _manifest_path(self.path)
        self.checkpoint_records = checkpoint_records
        self.checkpoint_bytes = checkpoint_bytes
        self.generation = _read_generation(self.path)
        self._cleanup_stale()
        wal = self._wal_path(self.generation)
        self._fh = open(wal, "a+b")
        # suffix length since the last checkpoint, for the auto trigger
        with open(wal, "rb") as f:
            self._records = sum(1 for _ in f)
        self._wal_bytes = wal.stat().st_size

    # -- layout ---------------------------------------------------------- #
    def _wal_path(self, gen: int) -> Path:
        return _wal_path(self.path, gen)

    def _snap_path(self, gen: int) -> Path:
        return _snap_path(self.path, gen)

    def _cleanup_stale(self) -> None:
        """Delete files of every generation but the current one — leftovers
        of a checkpoint that crashed before (orphans) or after (previous
        generation) its manifest swap."""
        keep = {self._wal_path(self.generation), self._snap_path(self.generation)}
        if self.generation > 0:
            stale = [self.path]  # the legacy gen-0 WAL
        else:
            stale = []
        stale += list(self.path.parent.glob(f"{self.path.name}.snap.*"))
        stale += list(self.path.parent.glob(f"{self.path.name}.wal.*"))
        stale += list(self.path.parent.glob(f"{self.path.name}.manifest.tmp"))
        for p in stale:
            if p not in keep:
                try:
                    p.unlink()
                except OSError:
                    pass

    # -- WAL ------------------------------------------------------------- #
    def append(self, record: dict) -> None:
        data = json.dumps(record).encode() + b"\n"
        self._fh.write(data)
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._records += 1
        self._wal_bytes += len(data)

    def should_checkpoint(self) -> bool:
        if self.checkpoint_records is None:
            return False
        return (
            self._records >= self.checkpoint_records
            or self._wal_bytes >= self.checkpoint_bytes
        )

    @property
    def records_since_checkpoint(self) -> int:
        return self._records

    def replay(self) -> Tuple[Optional[bytes], List[dict]]:
        """(snapshot blob or None, JSONL suffix records)."""
        blob: Optional[bytes] = None
        if self.generation > 0:
            # the manifest names this generation, so its snapshot was fully
            # written + fsynced before the swap; a read failure here is
            # storage corruption and must fail recovery loudly.
            blob = self._snap_path(self.generation).read_bytes()
        return blob, _read_jsonl(self._wal_path(self.generation))

    # -- checkpoint ------------------------------------------------------ #
    def checkpoint(self, snapshot_blob: bytes, *, _failpoint: Optional[str] = None) -> int:
        """Atomically install ``snapshot_blob`` as the new recovery base and
        rotate the WAL. Returns the new generation. Callers must serialize
        this with ``append`` (the coordinator holds its lock across both).

        ``_failpoint`` (test-only) raises :class:`CheckpointCrash` after the
        named step, simulating a process kill at that exact prefix.

        ``checkpoint_records=None`` disables compaction *entirely* — this
        method is then a no-op returning the current generation, so the
        contract is owned by the store, not re-checked at every call site
        (the snapshot-vs-replay differential's full-replay side depends on
        a disabled store never rotating).
        """
        if self.checkpoint_records is None:
            return self.generation

        def crash(step: str) -> None:
            if _failpoint == step:
                raise CheckpointCrash(step)

        crash("begin")
        gen = self.generation + 1
        snap, wal = self._snap_path(gen), self._wal_path(gen)
        tmp = snap.with_name(snap.name + ".tmp")
        # 1. durable snapshot under a temp name
        with open(tmp, "wb") as f:
            f.write(snapshot_blob)
            f.flush()
            os.fsync(f.fileno())
        crash("snap-tmp-written")
        # 2. publish the snapshot file (atomic), then make the name durable
        os.replace(tmp, snap)
        crash("snap-renamed")
        _fsync_dir(self.path.parent)
        crash("snap-dir-synced")
        # 3. fresh empty WAL for the new generation
        new_fh = open(wal, "a+b")
        try:
            _fsync_dir(self.path.parent)
            crash("wal-created")
            # 4. COMMIT: atomically swap the manifest to the new generation
            mtmp = self._manifest.with_name(self._manifest.name + ".tmp")
            with open(mtmp, "wb") as f:
                f.write(encode_manifest(gen))
                f.flush()
                os.fsync(f.fileno())
            crash("manifest-tmp-written")
            os.replace(mtmp, self._manifest)
            _fsync_dir(self.path.parent)
        except BaseException:
            # pre-commit failure (or a test failpoint): the old generation
            # is still the manifest's truth and its WAL handle stays active;
            # drop the would-be new WAL handle so nothing writes to it.
            new_fh.close()
            raise
        # -- committed: everything below is post-crash-safe cleanup -------- #
        old_gen = self.generation
        self.generation = gen
        old_fh, self._fh = self._fh, new_fh
        old_fh.close()
        self._records = 0
        self._wal_bytes = 0
        try:
            crash("manifest-swapped")
            for p in (self._wal_path(old_gen), self._snap_path(old_gen)):
                try:
                    p.unlink()
                except OSError:
                    pass
            crash("rotated")
        except CheckpointCrash:
            raise
        return gen

    def close(self) -> None:
        try:
            self._fh.close()
        except Exception:
            pass


# --------------------------------------------------------------------------- #
# read-side helper for external checkers (sim/invariants.py)                  #
# --------------------------------------------------------------------------- #
def read_durable_log(path: Path) -> Tuple[int, Optional[bytes], List[dict]]:
    """Read a (possibly rotated) coordinator log without opening it for
    append: ``(generation, snapshot blob or None, suffix records)`` — the
    exact layout resolution and torn-tail semantics of ``replay()``, via
    the shared helpers above (external checkers must never drift from what
    recovery itself would read)."""
    path = Path(path)
    gen = _read_generation(path)
    blob = _snap_path(path, gen).read_bytes() if gen > 0 else None
    return gen, blob, _read_jsonl(_wal_path(path, gen))
