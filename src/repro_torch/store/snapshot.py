"""Coordinator snapshot + manifest binary formats (DESIGN.md §11).

A snapshot captures one coordinator (or coordinator shard)'s **durable
cut**: everything a restarted coordinator needs so that recovery is
``load snapshot + replay log suffix`` instead of replaying the whole
history — the world counter, membership, the non-retired decision suffix,
the dependency-graph view at the exposure floor (per-StateObject committed
snapshots: live labels + dep lists), the floor itself, and the per-SO
report-flush dedup seqs.

Both blobs follow the ``core/ids.py`` wire conventions exactly: magic byte
``0xD5``, a kind byte (``K_SNAPSHOT`` / ``K_MANIFEST``, reserved there), a
per-blob so_id string table, zigzag varints, and strict truncated-buffer
rejection — a short read raises ``ValueError``, it never silently yields a
shortened durable cut (a torn snapshot must fail recovery loudly so the
manifest's previous generation is used instead; see ``compact.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from ..core.ids import (
    K_MANIFEST,
    K_SNAPSHOT,
    WIRE_MAGIC,
    RollbackDecision,
    _begin,
    _expect,
    _finish,
    _r_svarint,
    _r_uvarint,
    _read_decision_body,
    _str_at,
    _w_svarint,
    _w_uvarint,
    _write_decision_body,
)

#: bumped on any layout change; per the DESIGN.md §9 versioning rule a new
#: layout takes a new kind byte OR a new version value here — readers must
#: reject versions they do not understand (recovery then falls back to the
#: previous generation, never mis-parses).
SNAPSHOT_VERSION = 1

#: graph entry: sorted live labels with their dependency lists
GraphState = Dict[str, List[Tuple[int, List[Tuple[str, int]]]]]


@dataclass
class CoordinatorSnapshot:
    """In-memory form of one durable cut (see module docstring)."""

    fsn: int = 0
    retired_upto: int = 0  # decisions with fsn <= this were compacted away
    members: List[str] = field(default_factory=list)
    decisions: List[RollbackDecision] = field(default_factory=list)
    graph: GraphState = field(default_factory=dict)
    floor: Dict[str, int] = field(default_factory=dict)
    #: so_id -> set of (world, seq) report flushes already processed
    report_seen: Dict[str, Set[Tuple[int, int]]] = field(default_factory=dict)


def encode_snapshot(s: CoordinatorSnapshot) -> bytes:
    prefix, body, tab = _begin(K_SNAPSHOT)
    _w_uvarint(body, SNAPSHOT_VERSION)
    _w_uvarint(body, s.fsn)
    _w_uvarint(body, s.retired_upto)
    _w_uvarint(body, len(s.members))
    for so in sorted(s.members):
        _w_uvarint(body, tab.index(so))
    _w_uvarint(body, len(s.decisions))
    for d in sorted(s.decisions, key=lambda d: d.fsn):
        _write_decision_body(body, tab, d)
    _w_uvarint(body, len(s.graph))
    for so in sorted(s.graph):
        entries = s.graph[so]
        _w_uvarint(body, tab.index(so))
        _w_uvarint(body, len(entries))
        for version, deps in sorted(entries):
            _w_svarint(body, version)
            _w_uvarint(body, len(deps))
            for dep_so, dep_version in deps:
                _w_uvarint(body, tab.index(dep_so))
                _w_svarint(body, dep_version)
    _w_uvarint(body, len(s.floor))
    for so in sorted(s.floor):
        _w_uvarint(body, tab.index(so))
        _w_svarint(body, s.floor[so])
    _w_uvarint(body, len(s.report_seen))
    for so in sorted(s.report_seen):
        pairs = sorted(s.report_seen[so])
        _w_uvarint(body, tab.index(so))
        _w_uvarint(body, len(pairs))
        for world, seq in pairs:
            _w_svarint(body, world)
            _w_svarint(body, seq)
    return _finish(prefix, body, tab)


def decode_snapshot(raw: bytes) -> CoordinatorSnapshot:
    strings, i = _expect(raw, K_SNAPSHOT)
    version, i = _r_uvarint(raw, i)
    if version != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot version {version}")
    s = CoordinatorSnapshot()
    s.fsn, i = _r_uvarint(raw, i)
    s.retired_upto, i = _r_uvarint(raw, i)
    n, i = _r_uvarint(raw, i)
    for _ in range(n):
        si, i = _r_uvarint(raw, i)
        s.members.append(_str_at(strings, si))
    n, i = _r_uvarint(raw, i)
    for _ in range(n):
        d, i = _read_decision_body(raw, i, strings)
        s.decisions.append(d)
    n, i = _r_uvarint(raw, i)
    for _ in range(n):
        si, i = _r_uvarint(raw, i)
        ne, i = _r_uvarint(raw, i)
        entries: List[Tuple[int, List[Tuple[str, int]]]] = []
        for _ in range(ne):
            version, i = _r_svarint(raw, i)
            nd, i = _r_uvarint(raw, i)
            deps: List[Tuple[str, int]] = []
            for _ in range(nd):
                di, i = _r_uvarint(raw, i)
                dv, i = _r_svarint(raw, i)
                deps.append((_str_at(strings, di), dv))
            entries.append((version, deps))
        s.graph[_str_at(strings, si)] = entries
    n, i = _r_uvarint(raw, i)
    for _ in range(n):
        si, i = _r_uvarint(raw, i)
        w, i = _r_svarint(raw, i)
        s.floor[_str_at(strings, si)] = w
    n, i = _r_uvarint(raw, i)
    for _ in range(n):
        si, i = _r_uvarint(raw, i)
        np, i = _r_uvarint(raw, i)
        pairs: Set[Tuple[int, int]] = set()
        for _ in range(np):
            world, i = _r_svarint(raw, i)
            seq, i = _r_svarint(raw, i)
            pairs.add((world, seq))
        s.report_seen[_str_at(strings, si)] = pairs
    if i != len(raw):
        raise ValueError(f"malformed snapshot: {len(raw) - i} trailing bytes")
    return s


# --------------------------------------------------------------------------- #
# manifest: the one-word commit record of the compactor                        #
# --------------------------------------------------------------------------- #
def encode_manifest(generation: int) -> bytes:
    out = bytearray((WIRE_MAGIC, K_MANIFEST))
    _w_uvarint(out, generation)
    return bytes(out)


def decode_manifest(raw: bytes) -> int:
    if len(raw) < 2 or raw[0] != WIRE_MAGIC or raw[1] != K_MANIFEST:
        raise ValueError(f"not a manifest blob (starts {raw[:2]!r})")
    gen, i = _r_uvarint(raw, 2)
    if i != len(raw):
        raise ValueError(f"malformed manifest: {len(raw) - i} trailing bytes")
    return gen
