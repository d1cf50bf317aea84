"""StateObject abstraction (paper §3.1, Tables 1 & 2).

Developers implement the four persistence methods (``Persist``, ``Restore``,
``Prune``, ``ListVersions``); the runtime-provided methods (``Connect``,
``StartAction``, ``EndAction``, ``Detach``, ``Merge``, ``Refresh``) are
concrete here and delegate to the attached :class:`~repro.core.runtime.DSERuntime`.
Method names deliberately mirror the paper's API.
"""
from __future__ import annotations

import abc
import os
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .runtime import DSEConfig, DSERuntime
    from .sthread import SThread
    from .ids import Header


class StateObject(abc.ABC):
    """A stateful, message-passing, fail-restart entity (paper §3)."""

    def __init__(self) -> None:
        self._runtime: Optional["DSERuntime"] = None

    # ------------------------------------------------------------------ #
    # Developer-implemented persistence backend (paper Table 1)          #
    # ------------------------------------------------------------------ #
    @abc.abstractmethod
    def Persist(self, version: int, metadata: bytes, callback: Callable[[], None]) -> None:
        """Persist current state + ``metadata`` as ``version``; invoke
        ``callback`` once durable. May return before completion (async),
        but MUST capture a consistent snapshot before returning — the
        runtime guarantees no action interleaves with this call."""

    @abc.abstractmethod
    def Restore(self, version: int) -> bytes:
        """Recover (or roll back) to ``version``; return its metadata."""

    def Prune(self, version: int) -> None:  # optional
        """Versions *preceding* ``version`` may be discarded; ``version``
        itself must stay listable — it is the durable floor anchor the
        fragment-GC'd resend path ships to a recovering coordinator
        (DESIGN.md §11)."""

    @abc.abstractmethod
    def ListVersions(self) -> List[Tuple[int, bytes]]:
        """All unpruned durable versions with their metadata."""

    # ------------------------------------------------------------------ #
    # Runtime-provided API (paper Table 2)                               #
    # ------------------------------------------------------------------ #
    def Connect(self, config: "DSEConfig") -> None:
        from .runtime import DSERuntime

        if self._runtime is not None:
            raise RuntimeError("Connect must be invoked exactly once")
        kind = getattr(config, "runtime", "dse")
        if kind == "durable":
            # lazy import: repro.durable depends on repro.core, not vice versa
            from ..durable.runtime import DurableRuntime as runtime_cls
        elif kind == "dse":
            runtime_cls = DSERuntime
        else:
            raise ValueError(f"unknown runtime {kind!r} (expected 'dse' or 'durable')")
        self._runtime = runtime_cls(self, config)
        # stores exist before the clock does (service constructors run
        # first): bind every VersionStore to the runtime's injected clock
        for attr in vars(self).values():
            if isinstance(attr, VersionStore):
                attr.bind_clock(self._runtime.clock)
        self._runtime.connect()

    def StartAction(self, header: Optional["Header"] = None) -> bool:
        return self.runtime.start_action(header)

    def EndAction(self) -> "Header":
        return self.runtime.end_action()

    def Detach(self) -> "SThread":
        return self.runtime.detach()

    def Merge(self, sthread: "SThread") -> bool:
        return self.runtime.merge(sthread)

    def Refresh(self) -> None:
        self.runtime.refresh()

    def spawn_io(self, fn: Callable[[], None], name: str = "persist-io") -> None:
        """Run ``fn`` on an independent thread of control via the runtime's
        injected clock — a real daemon thread in production, a scheduled
        task under deterministic simulation (DESIGN.md §8). Persistence
        backends use this for their async IO instead of raw
        ``threading.Thread`` so ``Persist`` completion is simulatable."""
        if self._runtime is not None:
            self._runtime.clock.spawn(fn, name=f"{self._runtime.so_id}:{name}")
        else:
            threading.Thread(target=fn, name=name, daemon=True).start()

    def wait_durable(self, timeout: Optional[float] = None) -> bool:
        """Convenience: must be called *inside* an action. Blocks until the
        action's state (and everything it observed) is non-speculative, then
        re-enters an action. Returns False if the state was rolled back.
        This is how non-speculative baselines emulate synchronous persistence
        (durable-execution semantics) on top of libDSE."""
        t = self.Detach()
        try:
            t.Barrier(timeout=timeout)
        except Exception:
            return False
        return self.Merge(t)

    @property
    def runtime(self) -> "DSERuntime":
        if self._runtime is None:
            raise RuntimeError("StateObject is not Connected")
        return self._runtime

    @property
    def connected(self) -> bool:
        return self._runtime is not None


class VersionStore:
    """Durable multi-version blob store with an in-memory fast tier.

    A reusable persistence backend for services: each version is an opaque
    ``bytes`` snapshot written atomically (tmp + rename => a crashed writer
    never yields a listable version) plus metadata sidecar. The in-memory
    tier makes rollback cheap (paper §3.1 encourages built-in
    multiversioning); the disk tier is the durable point of truth used by a
    restarted incarnation.
    """

    def __init__(
        self,
        root: Path,
        keep_in_memory: int = 8,
        simulate_io_ms: float = 0.0,
        clock=None,
    ) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._mem: Dict[int, Tuple[bytes, bytes]] = {}
        self._mem_order: List[int] = []
        self._keep = keep_in_memory
        self._lock = threading.Lock()
        self._simulate_io_ms = simulate_io_ms
        self._clock = clock  # None => real time.sleep for simulated IO delay
        self._poisoned = False

    def bind_clock(self, clock) -> None:
        """Late-bind an injected clock (DESIGN.md §8). Services build their
        stores in their constructors, before ``Connect`` delivers the
        runtime's clock — without the rebind, ``simulate_io_ms`` would burn
        real wall time (and zero virtual time) under simulation."""
        if self._clock is None:
            self._clock = clock

    # -- write path -----------------------------------------------------
    def poison(self) -> None:
        """Simulate process death: all subsequent writes fail (a crashed
        incarnation must not keep mutating durable state, paper §5.1)."""
        self._poisoned = True

    def write(self, version: int, payload: bytes, metadata: bytes) -> None:
        """Durably write one version (synchronous; callers wrap in executor)."""
        if self._poisoned:
            raise RuntimeError("VersionStore poisoned (incarnation crashed)")
        if self._simulate_io_ms > 0:
            if self._clock is not None:
                self._clock.sleep(self._simulate_io_ms / 1e3)
            else:
                import time

                time.sleep(self._simulate_io_ms / 1e3)
        tmp = self.root / f".v{version}.tmp"
        final = self.root / f"v{version}.blob"
        with open(tmp, "wb") as f:
            f.write(len(metadata).to_bytes(8, "little"))
            f.write(metadata)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        if self._poisoned:
            # crashed incarnation must not PUBLISH: an in-flight write that
            # survived the entry check could otherwise clobber the restarted
            # incarnation's same-numbered version with rolled-back state.
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise RuntimeError("VersionStore poisoned (incarnation crashed)")
        os.replace(tmp, final)
        with self._lock:
            self._mem[version] = (payload, metadata)
            self._mem_order.append(version)
            while len(self._mem_order) > self._keep:
                self._mem.pop(self._mem_order.pop(0), None)

    def put_memory(self, version: int, payload: bytes, metadata: bytes) -> None:
        """Stage a version in the memory tier only (lost on crash)."""
        with self._lock:
            self._mem[version] = (payload, metadata)
            self._mem_order.append(version)
            while len(self._mem_order) > self._keep:
                self._mem.pop(self._mem_order.pop(0), None)

    # -- read path ------------------------------------------------------
    def read(self, version: int) -> Tuple[bytes, bytes]:
        with self._lock:
            if version in self._mem:
                return self._mem[version]
        final = self.root / f"v{version}.blob"
        with open(final, "rb") as f:
            mlen = int.from_bytes(f.read(8), "little")
            metadata = f.read(mlen)
            payload = f.read()
        return payload, metadata

    def list_versions(self) -> List[Tuple[int, bytes]]:
        out: List[Tuple[int, bytes]] = []
        # numeric order, not lexical (v10 after v9, not between v1 and v2)
        for p in sorted(self.root.glob("v*.blob"), key=lambda p: int(p.stem[1:])):
            version = int(p.stem[1:])
            try:
                with open(p, "rb") as f:
                    mlen = int.from_bytes(f.read(8), "little")
                    metadata = f.read(mlen)
            except FileNotFoundError:
                continue  # pruned concurrently (in-flight Refresh of a dying incarnation)
            out.append((version, metadata))
        return out

    def prune(self, version: int) -> None:
        for p in list(self.root.glob("v*.blob")):
            if int(p.stem[1:]) < version:
                try:
                    p.unlink()
                except OSError:
                    pass
        with self._lock:
            for v in [v for v in self._mem if v < version]:
                self._mem.pop(v, None)
            self._mem_order = [v for v in self._mem_order if v in self._mem]

    def drop_memory(self) -> None:
        """Simulate crash: lose the in-memory tier."""
        with self._lock:
            self._mem.clear()
            self._mem_order.clear()
