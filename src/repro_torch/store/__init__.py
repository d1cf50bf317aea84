"""repro.store — snapshot + log-compaction subsystem (DESIGN.md §11).

Bounded, O(live-state) coordinator recovery: a :class:`CompactingLog`
periodically folds the coordinator's durable state into a binary
:class:`CoordinatorSnapshot` (graph at the exposure floor, non-retired
decisions, world counter, per-SO flush seqs) and rotates the JSONL log to
a suffix, crash-safely via an atomic manifest swap. Restart then loads
snapshot + suffix instead of replaying the whole history, and runtimes GC
their fragment stores below the durable floor.
"""
from .compact import CheckpointCrash, CompactingLog, FAILPOINTS, read_durable_log
from .snapshot import (
    SNAPSHOT_VERSION,
    CoordinatorSnapshot,
    decode_manifest,
    decode_snapshot,
    encode_manifest,
    encode_snapshot,
)

__all__ = [
    "CheckpointCrash",
    "CompactingLog",
    "CoordinatorSnapshot",
    "FAILPOINTS",
    "SNAPSHOT_VERSION",
    "decode_manifest",
    "decode_snapshot",
    "encode_manifest",
    "encode_snapshot",
    "read_durable_log",
]
