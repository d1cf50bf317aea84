"""Deterministic simulation runtime (DESIGN.md §8): virtual time + a
seeded single-runner cooperative scheduler.

FoundationDB-style: every thread of control in the system under test is a
*simulation task*; exactly one task executes at any moment, and a task
relinquishes control only at a blocking primitive (sleep, event/condition
wait, contended lock). The scheduler then picks the next runnable task with
a **seeded RNG** and, when nothing is runnable, jumps virtual time straight
to the earliest deadline — a 60-virtual-second partition test runs in
milliseconds of wall time.

Tasks are real OS threads for implementation convenience (the DSE stack is
written in blocking style), but the strict one-at-a-time hand-off makes
execution deterministic: same seed + same scenario => byte-identical event
trace (asserted in ``tests/test_sim.py``). Determinism covers scheduling,
virtual time, and every fault roll; it does NOT cover content that hashes
differently across *processes* (``PYTHONHASHSEED``) or JAX kernel numerics
— see DESIGN.md §8 for the contract.

The :class:`SimClock` it exposes implements :class:`repro.core.clock.Clock`,
so the entire stack (transport, runtime, coordinator, services) runs under
simulation unmodified — production code paths keep the real clock.
"""
from __future__ import annotations

import itertools
import random
import sys
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

from ..core.clock import Clock, SpawnHandle

_RUNNABLE = "runnable"
_RUNNING = "running"
_BLOCKED = "blocked"
_DONE = "done"


class TaskCancelled(BaseException):
    """Raised inside a task when the simulation tears down. BaseException so
    ordinary ``except Exception`` service code does not swallow it."""


class SimDeadlock(RuntimeError):
    """Every task is blocked and no deadline exists to advance time to."""


class SimTimeout(RuntimeError):
    """Virtual time (or the event budget) exceeded the scenario limit."""


class SimTaskError(RuntimeError):
    """A non-root task died with an unhandled exception."""


class _Task(SpawnHandle):
    def __init__(self, sched: "SimScheduler", tid: int, name: str, fn: Callable[[], Any]) -> None:
        self._sched = sched
        self.tid = tid
        self.name = name
        self.fn = fn
        self.sem = threading.Semaphore(0)
        self.thread: Optional[threading.Thread] = None
        self.state = _RUNNABLE
        self.wake_at: Optional[float] = None  # virtual deadline (sleep/timed wait)
        self.cancelled = False
        self.error: Optional[BaseException] = None
        self.result: Any = None
        self.done = SimEvent(sched)

    # -- SpawnHandle ----------------------------------------------------- #
    def join(self, timeout: Optional[float] = None) -> None:
        if self.state == _DONE:
            return
        self.done.wait(timeout)

    def is_alive(self) -> bool:
        return self.state != _DONE

    # -- thread body ------------------------------------------------------ #
    def _bootstrap(self) -> None:
        try:
            self.result = self.fn()
        except TaskCancelled:
            pass
        except BaseException as e:  # noqa: BLE001 — recorded, surfaced by run()
            self.error = e
        finally:
            self.state = _DONE
            self.done.set()
            self._sched._trace_event("done", self)
            self._sched._sched_sem.release()


class SimEvent:
    """Cooperative ``threading.Event`` equivalent bound to a scheduler."""

    def __init__(self, sched: "SimScheduler") -> None:
        self._sched = sched
        self._flag = False
        self._waiters: List[_Task] = []

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        self._flag = True
        if self._waiters:
            waiters, self._waiters = self._waiters, []
            for t in waiters:
                self._sched._wake(t)

    def clear(self) -> None:
        self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._flag:
            return True
        if timeout is not None and timeout <= 0:
            return self._flag
        sched = self._sched
        me = sched._require_task()
        self._waiters.append(me)
        sched._yield_current(None if timeout is None else sched.now + timeout)
        if me in self._waiters:  # woke by timeout, not set()
            self._waiters.remove(me)
        return self._flag


class SimLock:
    """Cooperative non-reentrant lock. A paused task may hold it; waiters
    yield to the scheduler instead of blocking their OS thread, which is
    what keeps the single-runner scheduler deadlock-free."""

    def __init__(self, sched: "SimScheduler") -> None:
        self._sched = sched
        self._owner: Optional[_Task] = None
        self._waiters: List[_Task] = []

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sched = self._sched
        me = sched._require_task()
        if self._owner is me:
            raise RuntimeError("SimLock is not reentrant (use clock.rlock())")
        if self._owner is None:
            self._owner = me
            return True
        if not blocking:
            return False
        deadline = None if timeout is None or timeout < 0 else sched.now + timeout
        while self._owner is not None:
            if deadline is not None and sched.now >= deadline:
                return False
            self._waiters.append(me)
            sched._yield_current(deadline)
            if me in self._waiters:
                self._waiters.remove(me)
        self._owner = me
        return True

    def release(self) -> None:
        self._owner = None
        for t in self._waiters:
            self._sched._wake(t)

    def locked(self) -> bool:
        return self._owner is not None

    def __enter__(self) -> "SimLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class SimRLock:
    """Cooperative reentrant lock with the Condition save/restore hooks."""

    def __init__(self, sched: "SimScheduler") -> None:
        self._sched = sched
        self._owner: Optional[_Task] = None
        self._count = 0
        self._waiters: List[_Task] = []

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sched = self._sched
        me = sched._require_task()
        if self._owner is me:
            self._count += 1
            return True
        if not blocking and self._owner is not None:
            return False
        deadline = None if timeout is None or timeout < 0 else sched.now + timeout
        while self._owner is not None:
            if not blocking:
                return False
            if deadline is not None and sched.now >= deadline:
                return False
            self._waiters.append(me)
            sched._yield_current(deadline)
            if me in self._waiters:
                self._waiters.remove(me)
        self._owner = me
        self._count = 1
        return True

    def release(self) -> None:
        if self._owner is not self._sched._current:
            raise RuntimeError("cannot release un-owned SimRLock")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            for t in self._waiters:
                self._sched._wake(t)

    # threading.Condition protocol for reentrant locks
    def _release_save(self):
        count, self._count = self._count, 0
        self._owner = None
        for t in self._waiters:
            self._sched._wake(t)
        return count

    def _acquire_restore(self, count) -> None:
        self.acquire()
        self._count = count

    def _is_owned(self) -> bool:
        return self._owner is self._sched._current

    def __enter__(self) -> "SimRLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class SimCondition:
    """Cooperative ``threading.Condition`` over a Sim(R)Lock."""

    def __init__(self, sched: "SimScheduler", lock=None) -> None:
        self._sched = sched
        self._lock = lock if lock is not None else SimRLock(sched)
        self._waiters: List[_Task] = []
        self.acquire = self._lock.acquire
        self.release = self._lock.release

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        sched = self._sched
        me = sched._require_task()
        if hasattr(self._lock, "_release_save"):
            saved = self._lock._release_save()
        else:
            self._lock.release()
            saved = None
        self._waiters.append(me)
        sched._yield_current(None if timeout is None else sched.now + timeout)
        timed_out = me in self._waiters
        if timed_out:
            self._waiters.remove(me)
        if saved is not None:
            self._lock._acquire_restore(saved)
        else:
            self._lock.acquire()
        return not timed_out

    def wait_for(self, predicate, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else self._sched.now + timeout
        result = predicate()
        while not result:
            remaining = None
            if deadline is not None:
                remaining = deadline - self._sched.now
                if remaining <= 0:
                    break
            self.wait(remaining)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        woken, self._waiters = self._waiters[:n], self._waiters[n:]
        for t in woken:
            self._sched._wake(t)

    def notify_all(self) -> None:
        self.notify(len(self._waiters))


class SimClock(Clock):
    """The :class:`~repro.core.clock.Clock` a scheduler injects everywhere."""

    def __init__(self, sched: "SimScheduler") -> None:
        self._sched = sched

    def now(self) -> float:
        return self._sched.now

    def sleep(self, seconds: float) -> None:
        sched = self._sched
        sched._require_task()
        sched._yield_current(sched.now + max(float(seconds), 0.0))

    def event(self) -> SimEvent:
        return SimEvent(self._sched)

    def condition(self, lock=None) -> SimCondition:
        return SimCondition(self._sched, lock)

    def lock(self) -> SimLock:
        return SimLock(self._sched)

    def rlock(self) -> SimRLock:
        return SimRLock(self._sched)

    def spawn(self, fn: Callable[[], None], *, name: Optional[str] = None) -> _Task:
        return self._sched.spawn(fn, name=name)


class SimScheduler:
    """Seeded single-runner scheduler over virtual time (module docstring)."""

    def __init__(self, seed: int = 0, *, max_events: int = 5_000_000) -> None:
        self.seed = seed
        self._rng = random.Random(seed)
        self.now = 0.0
        self.clock = SimClock(self)
        self._tasks: List[_Task] = []
        self._tid = itertools.count(1)
        self._sched_sem = threading.Semaphore(0)
        self._current: Optional[_Task] = None
        self._trace: List[str] = []
        self.events = 0
        self._max_events = max_events
        self.task_failures: List[BaseException] = []

    # -- task registration ------------------------------------------------ #
    def spawn(self, fn: Callable[[], Any], *, name: Optional[str] = None) -> _Task:
        tid = next(self._tid)
        task = _Task(self, tid, name or f"task-{tid}", fn)
        self._tasks.append(task)
        self._trace_event("spawn", task)
        return task

    # -- primitives called from task threads ------------------------------ #
    def _require_task(self) -> _Task:
        t = self._current
        if t is None or t.thread is not threading.current_thread():
            raise RuntimeError(
                "simulation primitive used outside a simulation task — "
                "spawn the caller via clock.spawn()/SimScheduler.run()"
            )
        return t

    def _yield_current(self, wake_at: Optional[float]) -> None:
        """Block the calling task until the scheduler resumes it (at
        ``wake_at`` virtual time, or earlier via :meth:`_wake`)."""
        task = self._require_task()
        task.state = _BLOCKED
        task.wake_at = wake_at
        self._sched_sem.release()
        task.sem.acquire()
        if task.cancelled:
            raise TaskCancelled()

    def _wake(self, task: _Task) -> None:
        if task.state == _BLOCKED:
            task.state = _RUNNABLE
            task.wake_at = None

    # -- scheduling loop --------------------------------------------------- #
    def _trace_event(self, kind: str, task: _Task) -> None:
        self._trace.append(f"{self.events} t={self.now:.6f} {kind} {task.name}")

    def _run_task(self, task: _Task) -> None:
        self.events += 1
        self._trace_event("run", task)
        task.state = _RUNNING
        task.wake_at = None
        self._current = task
        if task.thread is None:
            task.thread = threading.Thread(
                target=task._bootstrap, name=f"sim:{task.name}", daemon=True
            )
            task.thread.start()
        else:
            task.sem.release()
        self._sched_sem.acquire()  # until the task yields or finishes
        self._current = None
        if task.error is not None and task.error not in self.task_failures:
            self.task_failures.append(task.error)

    def _step(self, max_virtual_time: float, advance_time: bool = True) -> bool:
        """One scheduling decision. Returns False when nothing can run."""
        runnable = [t for t in self._tasks if t.state == _RUNNABLE]
        if not runnable:
            if not advance_time:
                return False
            sleepers = [t for t in self._tasks if t.state == _BLOCKED and t.wake_at is not None]
            if not sleepers:
                return False
            target = min(t.wake_at for t in sleepers)
            if target > max_virtual_time:
                raise SimTimeout(
                    f"virtual time would pass {max_virtual_time}s "
                    f"(next deadline {target:.3f}s); blocked: "
                    + ", ".join(t.name for t in self._tasks if t.state == _BLOCKED)
                )
            self.now = max(self.now, target)
            for t in sleepers:
                if t.wake_at <= self.now:
                    t.state = _RUNNABLE
                    t.wake_at = None
            return True
        if self.events >= self._max_events:
            raise SimTimeout(
                f"event budget {self._max_events} exhausted at t={self.now:.6f} "
                f"(livelock? tasks spinning without advancing virtual time)\n"
                + self._task_stacks()
            )
        runnable.sort(key=lambda t: t.tid)
        pick = runnable[self._rng.randrange(len(runnable))]
        self._run_task(pick)
        return True

    def run(
        self,
        main_fn: Callable[[], Any],
        *,
        name: str = "main",
        max_virtual_time: float = 600.0,
        raise_task_failures: bool = True,
    ) -> Any:
        """Run ``main_fn`` as the root task until it completes; then drain
        already-runnable housekeeping tasks (no further time advance) and
        cancel the rest. Returns the root task's return value."""
        root = self.spawn(main_fn, name=name)
        try:
            while root.state != _DONE:
                if not self._step(max_virtual_time):
                    blocked = [t.name for t in self._tasks if t.state == _BLOCKED]
                    raise SimDeadlock(
                        f"all tasks blocked with no pending deadline; blocked: {blocked}"
                    )
            drain_budget = 10_000
            while drain_budget and self._step(max_virtual_time, advance_time=False):
                drain_budget -= 1
        finally:
            self._cancel_all()
        if root.error is not None:
            raise root.error
        failures = [e for e in self.task_failures if e is not root.error]
        if failures and raise_task_failures:
            raise SimTaskError(
                f"{len(failures)} background task(s) died: {failures[:3]!r}"
            ) from failures[0]
        return root.result

    def _cancel_all(self) -> None:
        for _ in range(100_000):
            alive = [t for t in self._tasks if t.state != _DONE and t.thread is not None]
            if not alive:
                break
            task = alive[0]
            task.cancelled = True
            task.state = _RUNNING
            self._current = task
            task.sem.release()
            self._sched_sem.acquire()
            self._current = None
        for t in self._tasks:
            if t.thread is None:  # spawned but never scheduled
                t.state = _DONE

    def _task_stacks(self, limit: int = 6) -> str:
        """Python stacks of every live task (diagnostics for timeouts)."""
        frames = sys._current_frames()
        out: List[str] = []
        for t in self._tasks:
            if t.state == _DONE or t.thread is None or t.thread.ident not in frames:
                continue
            stack = traceback.extract_stack(frames[t.thread.ident])
            app = [f for f in stack if "sim/scheduler.py" not in f.filename][-limit:]
            out.append(
                f"  task {t.name} [{t.state}]: "
                + " <- ".join(f"{f.name}@{f.filename.rsplit('/', 1)[-1]}:{f.lineno}" for f in reversed(app))
            )
        return "\n".join(out)

    # -- introspection ------------------------------------------------------ #
    def trace_text(self) -> str:
        return "\n".join(self._trace)

    def stats(self) -> Dict[str, float]:
        return {
            "events": self.events,
            "virtual_time": self.now,
            "tasks": len(self._tasks),
        }
