"""Injectable time + concurrency primitives (DESIGN.md §8).

Every blocking primitive the DSE stack uses — reading the clock, sleeping,
events, condition variables, locks held across waits, and background
threads — goes through a :class:`Clock` so the whole stack can run either
on the real OS scheduler (:class:`RealClock`, the default everywhere) or
under the deterministic simulation runtime (``repro.sim.SimScheduler``),
where time is virtual and a seeded scheduler picks every interleaving.

The contract a Clock implementation must satisfy:

* ``now()`` is monotone non-decreasing;
* ``sleep(d)`` returns no earlier than ``now()+d`` *in that clock's time*;
* ``event()`` / ``condition(lock)`` / ``lock()`` / ``rlock()`` return
  objects with the corresponding :mod:`threading` interfaces (``wait`` with
  optional timeout, ``set``/``clear``, ``notify``/``notify_all``, context
  management);
* ``spawn(fn)`` starts ``fn`` on an independent thread of control and
  returns a handle with ``join(timeout)`` and ``is_alive()``.

Code that never blocks while holding a lock may keep using plain
``threading.Lock`` (leaf locks); anything held across a wait, or waited on
directly, must come from the clock — a real lock held by a paused
simulation task would deadlock the cooperative scheduler.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class SpawnHandle:
    """Handle for a thread of control started via :meth:`Clock.spawn`."""

    def join(self, timeout: Optional[float] = None) -> None:
        raise NotImplementedError

    def is_alive(self) -> bool:
        raise NotImplementedError


class Clock:
    """Abstract time + blocking-primitive source (see module docstring)."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def event(self):
        raise NotImplementedError

    def condition(self, lock=None):
        raise NotImplementedError

    def lock(self):
        raise NotImplementedError

    def rlock(self):
        raise NotImplementedError

    def spawn(self, fn: Callable[[], None], *, name: Optional[str] = None) -> SpawnHandle:
        raise NotImplementedError


class _ThreadHandle(SpawnHandle):
    def __init__(self, thread: threading.Thread) -> None:
        self._thread = thread

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()


class RealClock(Clock):
    """The production clock: OS time and :mod:`threading` primitives."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def event(self) -> threading.Event:
        return threading.Event()

    def condition(self, lock=None) -> threading.Condition:
        return threading.Condition(lock)

    def lock(self) -> threading.Lock:
        return threading.Lock()

    def rlock(self) -> threading.RLock:
        return threading.RLock()

    def spawn(self, fn: Callable[[], None], *, name: Optional[str] = None) -> SpawnHandle:
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        return _ThreadHandle(t)


#: Shared default instance — module-level so identity checks and dataclass
#: defaults are cheap; RealClock is stateless.
REAL_CLOCK = RealClock()
