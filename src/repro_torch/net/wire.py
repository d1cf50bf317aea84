"""Wire serialization for the transport fabric (DESIGN.md §9).

The fabric used to pickle every envelope payload wholesale; protocol
objects (headers on service calls, persist reports, rollback decisions,
poll responses) dominated that traffic and pickled as generic class dumps
— class path + attribute dict per object. This module keeps pickle as the
*container* (service args/kwargs are arbitrary user values) but routes
every DSE protocol type through the struct-packed binary codec in
:mod:`repro.core.ids` via a pickler dispatch table, so a protocol object
on the wire costs its varint-packed bytes plus a single reconstructor
reference.

The loader functions below are resolved by module path at unpickle time,
which doubles as the codec version gate: a blob produced by an older
(JSON) build decodes through the codec's legacy fallbacks.
"""
from __future__ import annotations

import io
import pickle
from typing import Any, Optional

from ..core import ids
from ..core.coordinator import PollResponse
from ..core.ids import Header, PersistReport, RollbackDecision


# -- reconstructors (must stay module-level: pickled by reference) ---------- #
def _load_header(raw: bytes) -> Header:
    return Header.decode(raw)


def _load_report(raw: bytes) -> PersistReport:
    return ids.decode_report(raw)


def _load_decision(raw: bytes) -> RollbackDecision:
    return ids.decode_decision(raw)


def _load_poll(
    decisions: bytes, boundary: Optional[bytes], resend: bool, seq: int
) -> PollResponse:
    return PollResponse(
        decisions=ids.decode_decisions(decisions),
        boundary=None if boundary is None else ids.decode_boundary(boundary),
        resend_fragments=resend,
        boundary_seq=seq,
    )


_DISPATCH = {
    Header: lambda h: (_load_header, (h.encode(),)),
    PersistReport: lambda r: (_load_report, (ids.encode_report(r),)),
    RollbackDecision: lambda d: (_load_decision, (ids.encode_decision(d),)),
    PollResponse: lambda p: (
        _load_poll,
        (
            ids.encode_decisions(p.decisions),
            None if p.boundary is None else ids.encode_boundary(p.boundary),
            p.resend_fragments,
            p.boundary_seq,
        ),
    ),
}


class _WirePickler(pickle.Pickler):
    dispatch_table = _DISPATCH


def dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _WirePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def loads(raw: bytes) -> Any:
    return pickle.loads(raw)
