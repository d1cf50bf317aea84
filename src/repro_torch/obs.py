"""The port's recorder of spans and counters.

One process-wide recorder, off by default. Spans name the port's phases
where the work happens (the train step's phases, the DSE actions, the
persist, the restore); counters count bytes, rounds and nanoseconds there.
Both stay in memory until ``drain()`` hands them out.

    from repro_torch import obs

    obs.enable()
    with obs.span("trainer.train_on", step=3):   # request identifier "step=3"
        with obs.span("trainer.step"):           # child: same request
            ...
    obs.count("persist.stored_bytes", len(blob))
    rec = obs.drain()   # {"spans": [Span, ...], "counters": {...}, "threads": {...}}

A span records its name, start and end in ``time.perf_counter_ns()``, its
own id, its parent's id, the native id of its thread and the request
identifier: the ``key=value`` of its ids, or its parent's. The parent is the
innermost span open on the same thread; work handed to another thread
passes it as ``parent=``. Off, ``span()`` returns one shared no-op object
and the counters return at once: no allocation, no clock read.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

_clock = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    t0: int              # perf_counter ns
    t1: int
    sid: int
    parent: Optional[int]
    tid: int             # threading.get_native_id() of the thread that ran it
    req: Optional[str]   # request identifier, shared by one step, persist or recovery


class _Off:
    """The shared span of a disabled recorder."""
    __slots__ = ()
    sid = None
    req = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def tag(self, **ids) -> None:
        pass


_OFF = _Off()


class _Thread(threading.local):
    def __init__(self) -> None:
        self.stack: List["_Open"] = []
        self.tid = threading.get_native_id()
        _threads[self.tid] = threading.current_thread().name


class _Open:
    __slots__ = ("name", "req", "parent", "sid", "t0")

    def __init__(self, name: str, req: Optional[str], parent) -> None:
        self.name, self.req, self.parent = name, req, parent

    def tag(self, **ids) -> None:
        """Set the request identifier after the start (a value known only then)."""
        self.req = _req(ids)

    def __enter__(self):
        stack = _local.stack
        if self.parent is None and stack:
            self.parent = stack[-1]
        if self.req is None and self.parent is not None:
            self.req = self.parent.req
        self.sid = next(_ids)
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _clock()
        local = _local
        local.stack.pop()
        _spans.append(Span(self.name, self.t0, t1, self.sid,
                           self.parent.sid if self.parent is not None else None,
                           local.tid, self.req))
        return False


def _req(ids: dict) -> Optional[str]:
    return ",".join(f"{k}={v}" for k, v in ids.items()) or None


_on = False
_ids = itertools.count(1)
_spans: List[Span] = []
_counters: Dict[str, int] = {}
_threads: Dict[int, str] = {}
_mu = threading.Lock()
_local = _Thread()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, parent=None, **ids):
    """A context manager that records ``name`` from entry to exit.
    ``ids`` (``step=3``, ``version=0``, ``world=2``) set the request
    identifier; ``parent`` is a span opened on another thread."""
    if not _on:
        return _OFF
    return _Open(name, _req(ids), parent if parent is not _OFF else None)


def count(name: str, n: int = 1) -> None:
    if not _on:
        return
    with _mu:
        _counters[name] = _counters.get(name, 0) + n


def add_ns(name: str, ns: int) -> None:
    """A timed counter: ``ns`` nanoseconds more under ``name``."""
    count(name, ns)


def counters() -> Dict[str, int]:
    """The counters' totals so far, left in place (a reader takes two and
    subtracts to count a window)."""
    with _mu:
        return dict(_counters)


def drain() -> dict:
    """Hand out and forget what was recorded: ``spans`` (in order of their
    end) and ``counters`` (totals); ``threads`` (native id -> name of every
    thread that has opened a span) is kept."""
    global _spans
    with _mu:
        spans, _spans = _spans, []
        out = {"spans": spans, "counters": dict(_counters), "threads": dict(_threads)}
        _counters.clear()
    return out
