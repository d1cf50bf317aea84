"""Vertex / header / decision wire types for the DSE protocol.

A *vertex* on the recovery dependency graph is a recoverable point,
uniquely identified by (StateObject id, global failure counter ``world``,
local persistence counter ``version``) — the paper's :math:`A^x_y`.

Message *headers* carry the dependency set of the sending entity. A
StateObject-originated message carries exactly its current in-progress
vertex; an sthread-originated message carries the sthread's accumulated
dependency set (paper §4.2, Instrumentation Protocol).

Wire encoding (DESIGN.md §9): every protocol blob is struct-packed binary
with per-blob so_id interning — first byte ``0xD5``, then a kind byte, a
string table, and varint-packed vertices. JSON is kept as the *versioned
fallback*: blobs whose first byte is ``{`` or ``[`` are legacy JSON and
decode transparently (old persisted metadata, old coordinator logs).
"""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Mapping, Optional, Sequence, Tuple


# --------------------------------------------------------------------------- #
# binary primitives: varints + per-blob string interning                      #
# --------------------------------------------------------------------------- #
WIRE_MAGIC = 0xD5  # cannot start a JSON document (``{`` = 0x7B, ``[`` = 0x5B)

K_HEADER = 1
K_METADATA = 2
K_REPORT = 3  # legacy report body (no seq field) — read-only fallback
K_REPORTS = 4  # legacy batch — read-only fallback
K_DECISION = 5
K_DECISIONS = 6
K_BOUNDARY = 7
#: report bodies gained a per-incarnation flush ``seq`` (PR 4); per the
#: versioning rule (DESIGN.md §9) the layout change takes a NEW kind byte —
#: writers emit v2, readers accept both so pre-seq blobs stay decodable.
K_REPORT2 = 8
K_REPORTS2 = 9
#: decision bodies gained per-SO ``lost`` watermarks (PR 5, snapshot
#: retirement rule — DESIGN.md §11); same versioning rule: new kind bytes,
#: readers accept the pre-lost kinds with ``lost={}`` (never retirable).
K_DECISION2 = 10
K_DECISIONS2 = 11
#: reserved by repro.store (DESIGN.md §11): coordinator snapshot + manifest
K_SNAPSHOT = 12
K_MANIFEST = 13


def _w_uvarint(out: bytearray, n: int) -> None:
    if n < 0:
        raise ValueError(f"uvarint cannot encode negative {n}")
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _r_uvarint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    n = 0
    while True:
        if i >= len(buf):
            raise ValueError(f"truncated blob: varint runs past end at byte {i}")
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed blob: varint wider than 10 bytes")


def _r_bytes(buf: bytes, i: int, n: int) -> Tuple[bytes, int]:
    """Bounds-checked slice: a truncated buffer must raise, never silently
    yield a shortened string/user-bytes payload."""
    if n < 0 or i + n > len(buf):
        raise ValueError(
            f"truncated blob: need {n} bytes at {i}, have {len(buf) - i}"
        )
    return buf[i : i + n], i + n


def _str_at(strings: List[str], idx: int) -> str:
    if idx >= len(strings):
        raise ValueError(
            f"malformed blob: string index {idx} out of table of {len(strings)}"
        )
    return strings[idx]


def _w_svarint(out: bytearray, n: int) -> None:
    # zigzag: small negatives (watermark -1) stay 1 byte
    _w_uvarint(out, (n << 1) if n >= 0 else ((-n) << 1) - 1)


def _r_svarint(buf: bytes, i: int) -> Tuple[int, int]:
    z, i = _r_uvarint(buf, i)
    return (z >> 1) ^ -(z & 1), i


class _StrTable:
    """Encode-side so_id interning: each distinct string is written once in
    the blob's string table and referenced by index everywhere else."""

    def __init__(self) -> None:
        self._idx: Dict[str, int] = {}
        self.strings: List[str] = []

    def index(self, s: str) -> int:
        i = self._idx.get(s)
        if i is None:
            i = self._idx[s] = len(self.strings)
            self.strings.append(s)
        return i

    def write(self, out: bytearray) -> None:
        _w_uvarint(out, len(self.strings))
        for s in self.strings:
            raw = s.encode("utf-8")
            _w_uvarint(out, len(raw))
            out += raw

    @staticmethod
    def read(buf: bytes, i: int) -> Tuple[List[str], int]:
        n, i = _r_uvarint(buf, i)
        strings: List[str] = []
        for _ in range(n):
            ln, i = _r_uvarint(buf, i)
            raw, i = _r_bytes(buf, i, ln)
            strings.append(raw.decode("utf-8"))
        return strings, i


def _begin(kind: int) -> Tuple[bytearray, bytearray, _StrTable]:
    """Returns (prefix, body, table); finish with ``_finish``. The table is
    written between prefix and body so decoders can resolve indices."""
    return bytearray((WIRE_MAGIC, kind)), bytearray(), _StrTable()


def _finish(prefix: bytearray, body: bytearray, tab: _StrTable) -> bytes:
    tab.write(prefix)
    return bytes(prefix + body)


def _expect(raw: bytes, kind: int) -> Tuple[List[str], int]:
    if len(raw) < 2 or raw[0] != WIRE_MAGIC or raw[1] != kind:
        raise ValueError(f"not a binary kind={kind} blob (starts {raw[:2]!r})")
    return _StrTable.read(raw, 2)


@dataclass(frozen=True, order=True)
class Vertex:
    """A recoverable point :math:`A^{world}_{version}` on the dependency graph."""

    so_id: str
    world: int
    version: int

    def to_json(self) -> list:
        return [self.so_id, self.world, self.version]

    @staticmethod
    def from_json(obj: Iterable) -> "Vertex":
        so_id, world, version = obj
        return Vertex(str(so_id), int(world), int(version))

    def __repr__(self) -> str:  # A_y^x notation from the paper
        return f"{self.so_id}_{self.version}^{self.world}"


def _write_vertex(out: bytearray, tab: _StrTable, v: Vertex) -> None:
    _w_uvarint(out, tab.index(v.so_id))
    _w_svarint(out, v.world)
    _w_svarint(out, v.version)


def _read_vertex(buf: bytes, i: int, strings: List[str]) -> Tuple[Vertex, int]:
    si, i = _r_uvarint(buf, i)
    world, i = _r_svarint(buf, i)
    version, i = _r_svarint(buf, i)
    return Vertex(_str_at(strings, si), world, version), i


@dataclass(frozen=True)
class Header:
    """Opaque libDSE message header (paper Table 2).

    ``deps`` is the set of vertices the receiver will depend on if it
    consumes this message. StateObject sends produce a single-vertex set;
    sthread sends may carry many.
    """

    deps: FrozenSet[Vertex] = frozenset()

    def encode(self) -> bytes:
        prefix, body, tab = _begin(K_HEADER)
        _w_uvarint(body, len(self.deps))
        for v in sorted(self.deps):  # canonical order: equal headers, equal bytes
            _write_vertex(body, tab, v)
        return _finish(prefix, body, tab)

    @staticmethod
    def decode(raw: bytes) -> "Header":
        if raw[:1] == b"[":  # legacy JSON header
            return Header(frozenset(Vertex.from_json(o) for o in json.loads(raw.decode())))
        strings, i = _expect(raw, K_HEADER)
        n, i = _r_uvarint(raw, i)
        deps = []
        for _ in range(n):
            v, i = _read_vertex(raw, i, strings)
            deps.append(v)
        return Header(frozenset(deps))

    def merge(self, other: "Header") -> "Header":
        return Header(self.deps | other.deps)

    @staticmethod
    def of(*vertices: Vertex) -> "Header":
        return Header(frozenset(vertices))

    def max_version_for(self, exclude_so: Optional[str] = None) -> int:
        """Largest version watermark carried (commit ordering rule input)."""
        versions = [v.version for v in self.deps if v.so_id != exclude_so]
        return max(versions, default=-1)


@dataclass(frozen=True)
class RollbackDecision:
    """A coordinator rollback decision, synchronously persisted (paper §4.3).

    ``fsn``      — failure sequence number; becomes the new ``world``.
    ``targets``  — per-SO version watermark to restore to (surviving prefix).
    ``failed``   — the SO whose failure triggered this decision.
    ``lost``     — per-SO top *persisted* label at decision time: every
                   vertex this decision can ever invalidate has version in
                   ``(targets[so], lost[so]]``. Once the exposure floor of
                   every target passes its ``lost`` watermark, the decision
                   can never match anything again and the snapshot compactor
                   retires it (DESIGN.md §11). Empty => unknown (a legacy
                   decision): never retired.
    """

    fsn: int
    failed: str
    targets: Mapping[str, int] = field(default_factory=dict)
    lost: Mapping[str, int] = field(default_factory=dict)

    def invalidates(self, v: Vertex) -> bool:
        """True iff this decision rolled back vertex ``v``."""
        if v.world >= self.fsn:
            return False  # v was created after (or by) this recovery
        target = self.targets.get(v.so_id)
        if target is None:
            return False  # SO not a participant of this rollback
        return v.version > target

    def to_json(self) -> dict:
        out = {"fsn": self.fsn, "failed": self.failed, "targets": dict(self.targets)}
        if self.lost:
            out["lost"] = dict(self.lost)
        return out

    @staticmethod
    def from_json(obj: dict) -> "RollbackDecision":
        return RollbackDecision(
            fsn=int(obj["fsn"]),
            failed=str(obj["failed"]),
            targets={str(k): int(v) for k, v in obj["targets"].items()},
            lost={str(k): int(v) for k, v in obj.get("lost", {}).items()},
        )


def vertex_rolled_back(v: Vertex, decisions: Iterable[RollbackDecision]) -> bool:
    """True iff any decision in ``decisions`` invalidates ``v``."""
    return any(d.invalidates(v) for d in decisions)


class DecisionIndex:
    """Compacted per-SO invalidation index over a set of rollback decisions.

    ``vertex_rolled_back`` scans every decision per vertex — O(failures) on
    the message hot path. This index compacts the decision list into, per
    SO, the fsns that target it plus suffix-minimum targets, making
    ``invalidates`` O(log failures):

        v invalidated  ⇔  ∃d: d.fsn > v.world ∧ v.version > d.targets[v.so_id]
                       ⇔  v.version > min{ d.targets[so] : d.fsn > v.world }

    and the suffix minimum over fsn-sorted targets answers the RHS with one
    bisect. Soundness: exact by construction — see DESIGN.md §9.

    Not internally locked: callers mutate/read under their own mutex (the
    coordinator lock / the runtime ``_mu``), matching the lists it replaces.
    """

    __slots__ = ("_fsns", "_targets", "_sufmin", "max_fsn", "count")

    def __init__(self, decisions: Iterable[RollbackDecision] = ()) -> None:
        # so_id -> parallel fsn-sorted lists
        self._fsns: Dict[str, List[int]] = {}
        self._targets: Dict[str, List[int]] = {}
        self._sufmin: Dict[str, List[int]] = {}
        self.max_fsn = 0
        self.count = 0
        for d in decisions:
            self.add(d)

    def add(self, d: RollbackDecision) -> None:
        self.max_fsn = max(self.max_fsn, d.fsn)
        self.count += 1
        for so, target in d.targets.items():
            fsns = self._fsns.setdefault(so, [])
            targets = self._targets.setdefault(so, [])
            i = bisect.bisect_right(fsns, d.fsn)
            fsns.insert(i, d.fsn)
            targets.insert(i, int(target))
            # rebuild the suffix minima for this SO (appends are rare — one
            # per cluster failure — while lookups are per-message)
            suf: List[int] = [0] * len(targets)
            m = targets[-1]
            for j in range(len(targets) - 1, -1, -1):
                m = min(m, targets[j])
                suf[j] = m
            self._sufmin[so] = suf

    def invalidates(self, v: Vertex) -> bool:
        fsns = self._fsns.get(v.so_id)
        if not fsns:
            return False
        i = bisect.bisect_right(fsns, v.world)  # first decision with fsn > world
        if i >= len(fsns):
            return False
        return v.version > self._sufmin[v.so_id][i]

    def any_invalid(self, deps: Iterable[Vertex]) -> bool:
        return any(self.invalidates(dep) for dep in deps)


@dataclass
class PersistReport:
    """StateObject → coordinator report: vertex became durable with deps.

    ``seq`` is a per-incarnation flush sequence number (-1 = unknown, e.g. a
    Connect/fragment-resend report rebuilt from disk). The coordinator drops
    a report whose ``(world, seq)`` it has already processed for this SO —
    the requeue path can legitimately resend a report whose original
    delivery succeeded after its RPC timed out (at-least-once wire).
    """

    vertex: Vertex
    deps: Tuple[Vertex, ...]
    seq: int = -1

    def to_json(self) -> dict:
        out = {"v": self.vertex.to_json(), "deps": [d.to_json() for d in self.deps]}
        if self.seq >= 0:
            out["seq"] = self.seq
        return out

    @staticmethod
    def from_json(obj: dict) -> "PersistReport":
        return PersistReport(
            vertex=Vertex.from_json(obj["v"]),
            deps=tuple(Vertex.from_json(d) for d in obj["deps"]),
            seq=int(obj.get("seq", -1)),
        )


# --------------------------------------------------------------------------- #
# binary wire codec (DESIGN.md §9)                                            #
# --------------------------------------------------------------------------- #
def _write_report_body(body: bytearray, tab: _StrTable, r: PersistReport) -> None:
    _write_vertex(body, tab, r.vertex)
    _w_svarint(body, r.seq)
    _w_uvarint(body, len(r.deps))
    for d in r.deps:
        _write_vertex(body, tab, d)


def _read_report_body(
    raw: bytes, i: int, strings: List[str], with_seq: bool
) -> Tuple[PersistReport, int]:
    vertex, i = _read_vertex(raw, i, strings)
    seq = -1
    if with_seq:
        seq, i = _r_svarint(raw, i)
    n, i = _r_uvarint(raw, i)
    deps = []
    for _ in range(n):
        d, i = _read_vertex(raw, i, strings)
        deps.append(d)
    return PersistReport(vertex, tuple(deps), seq=seq), i


def _expect_either(raw: bytes, kind_v2: int, kind_legacy: int) -> Tuple[List[str], int, bool]:
    """(strings, offset, is_v2) for a v2-or-legacy blob (reports: v2 adds
    the seq field; decisions: v2 adds the lost watermarks)."""
    if len(raw) >= 2 and raw[0] == WIRE_MAGIC and raw[1] == kind_legacy:
        strings, i = _StrTable.read(raw, 2)
        return strings, i, False
    strings, i = _expect(raw, kind_v2)
    return strings, i, True


def encode_report(r: PersistReport) -> bytes:
    prefix, body, tab = _begin(K_REPORT2)
    _write_report_body(body, tab, r)
    return _finish(prefix, body, tab)


def decode_report(raw: bytes) -> PersistReport:
    strings, i, with_seq = _expect_either(raw, K_REPORT2, K_REPORT)
    r, _ = _read_report_body(raw, i, strings, with_seq)
    return r


def encode_reports(reports: Sequence[PersistReport]) -> bytes:
    """Batch encoding with ONE shared string table: a fragment resend of a
    whole SO history names each dep SO once, not once per vertex."""
    prefix, body, tab = _begin(K_REPORTS2)
    _w_uvarint(body, len(reports))
    for r in reports:
        _write_report_body(body, tab, r)
    return _finish(prefix, body, tab)


def decode_reports(raw: bytes) -> List[PersistReport]:
    strings, i, with_seq = _expect_either(raw, K_REPORTS2, K_REPORTS)
    n, i = _r_uvarint(raw, i)
    out: List[PersistReport] = []
    for _ in range(n):
        r, i = _read_report_body(raw, i, strings, with_seq)
        out.append(r)
    return out


def _write_watermarks(body: bytearray, tab: _StrTable, wm: Mapping[str, int]) -> None:
    _w_uvarint(body, len(wm))
    for so, t in sorted(wm.items()):
        _w_uvarint(body, tab.index(so))
        _w_svarint(body, t)


def _read_watermarks(raw: bytes, i: int, strings: List[str]) -> Tuple[Dict[str, int], int]:
    n, i = _r_uvarint(raw, i)
    out: Dict[str, int] = {}
    for _ in range(n):
        si, i = _r_uvarint(raw, i)
        t, i = _r_svarint(raw, i)
        out[_str_at(strings, si)] = t
    return out, i


def _write_decision_body(body: bytearray, tab: _StrTable, d: RollbackDecision) -> None:
    _w_uvarint(body, d.fsn)
    _w_uvarint(body, tab.index(d.failed))
    _write_watermarks(body, tab, d.targets)
    _write_watermarks(body, tab, d.lost)


def _read_decision_body(
    raw: bytes, i: int, strings: List[str], with_lost: bool = True
) -> Tuple[RollbackDecision, int]:
    fsn, i = _r_uvarint(raw, i)
    fi, i = _r_uvarint(raw, i)
    targets, i = _read_watermarks(raw, i, strings)
    lost: Dict[str, int] = {}
    if with_lost:
        lost, i = _read_watermarks(raw, i, strings)
    return (
        RollbackDecision(fsn=fsn, failed=_str_at(strings, fi), targets=targets, lost=lost),
        i,
    )


def encode_decision(d: RollbackDecision) -> bytes:
    prefix, body, tab = _begin(K_DECISION2)
    _write_decision_body(body, tab, d)
    return _finish(prefix, body, tab)


def decode_decision(raw: bytes) -> RollbackDecision:
    strings, i, with_lost = _expect_either(raw, K_DECISION2, K_DECISION)
    d, _ = _read_decision_body(raw, i, strings, with_lost)
    return d


def encode_decisions(decisions: Sequence[RollbackDecision]) -> bytes:
    prefix, body, tab = _begin(K_DECISIONS2)
    _w_uvarint(body, len(decisions))
    for d in decisions:
        _write_decision_body(body, tab, d)
    return _finish(prefix, body, tab)


def decode_decisions(raw: bytes) -> List[RollbackDecision]:
    strings, i, with_lost = _expect_either(raw, K_DECISIONS2, K_DECISIONS)
    n, i = _r_uvarint(raw, i)
    out: List[RollbackDecision] = []
    for _ in range(n):
        d, i = _read_decision_body(raw, i, strings, with_lost)
        out.append(d)
    return out


def encode_boundary(boundary: Mapping[str, int]) -> bytes:
    prefix, body, tab = _begin(K_BOUNDARY)
    _w_uvarint(body, len(boundary))
    for so, w in sorted(boundary.items()):
        _w_uvarint(body, tab.index(so))
        _w_svarint(body, w)
    return _finish(prefix, body, tab)


def decode_boundary(raw: bytes) -> Dict[str, int]:
    strings, i = _expect(raw, K_BOUNDARY)
    n, i = _r_uvarint(raw, i)
    out: Dict[str, int] = {}
    for _ in range(n):
        si, i = _r_uvarint(raw, i)
        w, i = _r_svarint(raw, i)
        out[_str_at(strings, si)] = w
    return out


def encode_metadata(world: int, version: int, deps: Iterable[Vertex], user: bytes = b"") -> bytes:
    """Serialize the dependency-graph fragment persisted with each version.

    The paper (§4.3, Finding Boundaries) persists graph fragments inside each
    StateObject via the ``metadata`` argument of ``Persist`` — this is the
    distributed point of truth that a recovering coordinator reassembles.
    ``user`` carries service-specific metadata piggybacked on the same blob
    (as raw bytes; the legacy JSON format hex-doubled them).
    """
    prefix, body, tab = _begin(K_METADATA)
    _w_svarint(body, world)
    _w_svarint(body, version)
    deps = list(deps)
    _w_uvarint(body, len(deps))
    for d in deps:
        _write_vertex(body, tab, d)
    _w_uvarint(body, len(user))
    body += user
    return _finish(prefix, body, tab)


def encode_metadata_json(world: int, version: int, deps: Iterable[Vertex], user: bytes = b"") -> bytes:
    """Legacy (pre-binary) metadata format, retained as the versioned
    fallback writer so tests can pin old-blob compatibility forever."""
    blob = {
        "world": world,
        "version": version,
        "deps": [d.to_json() for d in deps],
        "user": user.hex(),
    }
    return json.dumps(blob).encode()


def decode_metadata(raw: bytes) -> Tuple[int, int, Tuple[Vertex, ...], bytes]:
    if raw[:1] == b"{":  # legacy JSON blob persisted by an older build
        obj = json.loads(raw.decode())
        return (
            int(obj["world"]),
            int(obj["version"]),
            tuple(Vertex.from_json(d) for d in obj["deps"]),
            bytes.fromhex(obj.get("user", "")),
        )
    strings, i = _expect(raw, K_METADATA)
    world, i = _r_svarint(raw, i)
    version, i = _r_svarint(raw, i)
    n, i = _r_uvarint(raw, i)
    deps = []
    for _ in range(n):
        d, i = _read_vertex(raw, i, strings)
        deps.append(d)
    ulen, i = _r_uvarint(raw, i)
    user, i = _r_bytes(raw, i, ulen)
    return world, version, tuple(deps), bytes(user)
