"""Epoch protection for actions (paper §5.1, Synchronization).

libDSE executes every *action* under a shared lock and every
Persist/Restore under an exclusive lock, so actions never interleave with
persistence or recovery. The paper uses biased reader-writer locking
(BRAVO-style) for multicore scalability; under CPython the bias table's
benefit is bounded by the GIL, so we implement a writer-preferring
reader-writer lock with a striped reader-count fast path that preserves the
algorithmic shape (readers touch only their stripe in the common case and
fall back to the slow path when a writer has raised the bias-revoked flag).
"""
from __future__ import annotations

import threading
from typing import List

from .clock import Clock, REAL_CLOCK


_NUM_STRIPES = 16


class EpochRWLock:
    """Writer-preferring reader-writer lock with striped reader fast path.

    Blocking waits go through the injected ``clock`` (DESIGN.md §8) so the
    lock works under both the OS scheduler and deterministic simulation;
    the stripe locks are leaf locks (never held across a wait) and stay
    plain ``threading.Lock``.
    """

    def __init__(self, clock: Clock = REAL_CLOCK) -> None:
        self._mutex = clock.lock()
        self._readers_cv = clock.condition(self._mutex)
        self._writer_cv = clock.condition(self._mutex)
        self._stripe_locks: List[threading.Lock] = [threading.Lock() for _ in range(_NUM_STRIPES)]
        self._stripe_counts: List[int] = [0] * _NUM_STRIPES
        self._writer_active = False
        self._writers_waiting = 0
        # When True, readers must take the slow path (bias revoked).
        self._bias_revoked = False

    # -- reader (action) side -------------------------------------------------
    def _stripe(self) -> int:
        return threading.get_ident() % _NUM_STRIPES

    def acquire_shared(self) -> None:
        s = self._stripe()
        if not self._bias_revoked:
            # Fast path: bump our stripe, then re-check the flag. If a writer
            # arrived concurrently we undo and fall through to the slow path.
            with self._stripe_locks[s]:
                self._stripe_counts[s] += 1
            if not self._bias_revoked:
                return
            with self._stripe_locks[s]:
                self._stripe_counts[s] -= 1
            with self._mutex:
                self._writer_cv.notify_all()
        with self._mutex:
            while self._writer_active or self._writers_waiting > 0:
                self._readers_cv.wait()
            with self._stripe_locks[s]:
                self._stripe_counts[s] += 1

    def release_shared(self) -> None:
        s = self._stripe()
        with self._stripe_locks[s]:
            self._stripe_counts[s] -= 1
            stripe_drained = self._stripe_counts[s] == 0
        # Wake the writer only when this stripe drained to zero: the LAST
        # release on any stripe always hits zero, so the writer (which
        # re-counts all stripes on each wakeup) cannot miss the global-zero
        # transition — and intermediate releases stay off the mutex. The
        # flag read is racy by design: under a total instruction order (the
        # GIL), a release that misses a concurrent writer's flag-set
        # happened-before the writer's reader count, which then sees the
        # decrement.
        if stripe_drained and self._bias_revoked:
            with self._mutex:
                self._writer_cv.notify_all()

    # -- writer (persist/restore) side ----------------------------------------
    def _readers_total(self) -> int:
        total = 0
        for i in range(_NUM_STRIPES):
            with self._stripe_locks[i]:
                total += self._stripe_counts[i]
        return total

    def acquire_exclusive(self) -> None:
        with self._mutex:
            self._writers_waiting += 1
            self._bias_revoked = True
            # One combined predicate, no poll timeout: release_shared
            # notifies whenever a stripe drains to zero (covering the last
            # reader's exit) and release_exclusive notifies the next writer.
            # writer_active must be re-checked on every wakeup — two writers
            # can both be parked waiting for readers, and only one may win.
            while self._writer_active or self._readers_total() > 0:
                self._writer_cv.wait()
            self._writer_active = True
            self._writers_waiting -= 1

    def release_exclusive(self) -> None:
        with self._mutex:
            self._writer_active = False
            if self._writers_waiting == 0:
                self._bias_revoked = False
                self._readers_cv.notify_all()
            else:
                self._writer_cv.notify_all()

    # -- context helpers -------------------------------------------------------
    class _Shared:
        def __init__(self, lock: "EpochRWLock") -> None:
            self._lock = lock

        def __enter__(self) -> None:
            self._lock.acquire_shared()

        def __exit__(self, *exc) -> None:
            self._lock.release_shared()

    class _Exclusive:
        def __init__(self, lock: "EpochRWLock") -> None:
            self._lock = lock

        def __enter__(self) -> None:
            self._lock.acquire_exclusive()

        def __exit__(self, *exc) -> None:
            self._lock.release_exclusive()

    def shared(self) -> "EpochRWLock._Shared":
        return EpochRWLock._Shared(self)

    def exclusive(self) -> "EpochRWLock._Exclusive":
        return EpochRWLock._Exclusive(self)
