"""sthreads: lightweight speculative threads of execution (paper §3.2).

An sthread encodes the speculative state of its parent StateObject at
creation time as a dependency *set*; it does not own graph vertices.
sthreads interact with every participant — including the parent — only via
instrumented message passing (``Receive``/``Send``) and can ``Barrier()``
to wait until everything they observed is non-speculative.
"""
from __future__ import annotations

import threading
from typing import Optional, Set, TYPE_CHECKING

from .ids import Header, Vertex

if TYPE_CHECKING:  # pragma: no cover
    from .runtime import DSERuntime


class RolledBackError(Exception):
    """The speculative state this entity derives from has been rolled back."""


class DelayMessage(Exception):
    """Message is from a future failure epoch; redeliver after catching up
    (Recovery Partition Rule, paper Def 4.3)."""


class SThread:
    def __init__(self, runtime: "DSERuntime", deps: Set[Vertex]) -> None:
        self._runtime = runtime
        self._deps: Set[Vertex] = set(deps)
        self._lock = threading.Lock()
        self._rolled_back = False

    # ------------------------------------------------------------------ #
    def _check_self(self) -> None:
        if self._rolled_back or self._runtime.any_invalid(self._deps):
            self._rolled_back = True
            raise RolledBackError("sthread derives from rolled-back state")

    def Receive(self, header: Header) -> bool:
        """Consume a message header. False => discard the message.
        Raises :class:`RolledBackError` if this sthread itself is stale."""
        self._check_self()
        status = self._runtime.classify_header(header)
        if status == "delay":
            raise DelayMessage()
        if status == "discard":
            return False
        with self._lock:
            self._deps |= header.deps
        return True

    def Send(self) -> Header:
        self._check_self()
        with self._lock:
            return Header(frozenset(self._deps))

    def Barrier(self, timeout: Optional[float] = None) -> None:
        """Block until all observed state is non-speculative (paper §3.2).
        Clears the dependency set afterwards to bound growth."""
        self._check_self()
        with self._lock:
            deps = frozenset(self._deps)
        self._runtime.barrier(deps, timeout=timeout)
        self._check_self()
        with self._lock:
            self._deps.clear()

    @property
    def deps(self) -> Set[Vertex]:
        with self._lock:
            return set(self._deps)
