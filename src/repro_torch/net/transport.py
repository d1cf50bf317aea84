"""Simulated transport fabric for cluster-scale DSE (DESIGN.md §7).

The paper's libDSE deployment runs StateObjects on real nodes over gRPC; the
seed repo wires everything with direct in-process calls. This module closes
the gap with an in-process *fabric*: endpoints exchange wire-encoded
envelopes (binary DSE protocol codec, ``net/wire.py``)
carrying DSE :class:`~repro.core.ids.Header` payloads, and every link can be
configured with latency, jitter, probabilistic loss, reordering, and
partitions. Delivery is *batched* per endpoint (Netherite-style: one worker
wakeup drains every due message), which is what makes the transport path
cheap at scale — see ``benchmarks/bench_net.py``.

Delivery semantics: at-least-once on the wire (senders retry on a per-attempt
timeout) + receiver-side dedup by message id => exactly-once *processing*.
A handler raising :class:`~repro.core.sthread.DelayMessage` (message from a
future failure epoch, paper Def 4.3) is answered with a ``delay`` status that
is deliberately NOT cached, so the sender's retry re-invokes the handler
after it has caught up — the transport equivalent of the retry loop in
``LocalCluster.call``.
"""
from __future__ import annotations

import copy
import heapq
import itertools
import random
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..core.clock import Clock, REAL_CLOCK
from ..core.sthread import DelayMessage
from . import wire

#: handler(method, *args, **kwargs) -> result
Handler = Callable[..., Any]


@dataclass
class LinkSpec:
    """Fault/latency model of one directed link (or the fabric default)."""

    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    loss_prob: float = 0.0
    reorder_prob: float = 0.0
    reorder_ms: float = 1.0  # extra delay applied to reordered messages
    dup_prob: float = 0.0  # wire-level duplication (dedup makes processing 1x)
    dup_ms: float = 1.0  # extra delay applied to the duplicate copy


@dataclass
class Envelope:
    msg_id: str
    src: str
    dst: str
    method: str
    payload: bytes  # wire-encoded (args, kwargs) — measurable wire bytes
    attempt: int = 1
    deliver_at: float = 0.0
    needs_reply: bool = True  # False for cast(): no reply traffic, no dedup


class TransportError(Exception):
    pass


class Transport:
    """Abstract RPC fabric between named endpoints."""

    def register(self, endpoint_id: str, handler: Handler) -> None:
        raise NotImplementedError

    def call(self, src: str, dst: str, method: str, *args, timeout: Optional[float] = None, **kwargs):
        """Blocking RPC with the fabric's delivery semantics."""
        raise NotImplementedError

    def cast(self, src: str, dst: str, method: str, *args, **kwargs) -> None:
        """Fire-and-forget send (no reply, no retry)."""
        raise NotImplementedError

    def stats(self) -> Dict[str, float]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class DirectTransport(Transport):
    """Baseline: direct in-process dispatch (what the seed repo does), with
    the same retry-on-delay semantics so callers are transport-agnostic."""

    def __init__(
        self,
        *,
        call_timeout: float = 0.4,
        delay_backoff: float = 0.002,
        clock: Clock = REAL_CLOCK,
    ) -> None:
        self._eps: Dict[str, Handler] = {}
        self._call_timeout = call_timeout
        self._delay_backoff = delay_backoff
        self._clock = clock
        self._calls = 0

    def register(self, endpoint_id: str, handler: Handler) -> None:
        self._eps[endpoint_id] = handler

    def call(self, src: str, dst: str, method: str, *args, timeout: Optional[float] = None, **kwargs):
        handler = self._eps[dst]
        self._calls += 1
        deadline = self._clock.now() + (timeout if timeout is not None else self._call_timeout)
        while True:
            try:
                return handler(method, *args, **kwargs)
            except DelayMessage:
                if self._clock.now() >= deadline:
                    raise TimeoutError(f"{src}->{dst} {method}: delayed past retry budget")
                self._clock.sleep(self._delay_backoff)

    def cast(self, src: str, dst: str, method: str, *args, **kwargs) -> None:
        self._calls += 1
        try:
            self._eps[dst](method, *args, **kwargs)
        except Exception:
            pass  # fire-and-forget parity with SimTransport.cast

    def stats(self) -> Dict[str, float]:
        return {"calls": self._calls}


class _Waiter:
    """Reply slot for one in-flight RPC. Retries mean several replies for the
    same msg_id can race ``resolve``; the lock makes take-then-clear atomic so
    the caller can never observe a set event with an empty result."""

    __slots__ = ("_mu", "event", "_result")

    def __init__(self, clock: Clock) -> None:
        self._mu = threading.Lock()
        self.event = clock.event()
        self._result: Optional[Tuple[str, bytes]] = None

    def resolve(self, status: str, blob: bytes) -> None:
        with self._mu:
            self._result = (status, blob)
            self.event.set()

    def take(self) -> Optional[Tuple[str, bytes]]:
        with self._mu:
            result, self._result = self._result, None
            self.event.clear()
            return result


class _TimedQueue:
    """Min-heap of (deliver_at, item) drained by a dedicated thread: one
    wakeup pops every due item (up to ``max_batch``) and hands the batch to
    ``drain``. Shared by endpoint inboxes and the reply scheduler."""

    def __init__(
        self,
        name: str,
        drain: Callable[[List[Any]], None],
        max_batch: Optional[Callable[[], int]] = None,
        clock: Clock = REAL_CLOCK,
    ) -> None:
        self._clock = clock
        self._cv = clock.condition()
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = itertools.count()
        self._stop = False
        self._drain = drain
        self._max_batch = max_batch
        self._worker = clock.spawn(self._run, name=name)

    def push(self, deliver_at: float, item: Any) -> None:
        with self._cv:
            heapq.heappush(self._heap, (deliver_at, next(self._seq), item))
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()

    def _run(self) -> None:
        while True:
            batch: List[Any] = []
            with self._cv:
                while not self._stop:
                    now = self._clock.now()
                    if self._heap and self._heap[0][0] <= now:
                        break
                    wait = (self._heap[0][0] - now) if self._heap else None
                    self._cv.wait(timeout=wait)
                if self._stop:
                    return
                now = self._clock.now()
                limit = self._max_batch() if self._max_batch else None
                while (
                    self._heap
                    and self._heap[0][0] <= now
                    and (limit is None or len(batch) < limit)
                ):
                    batch.append(heapq.heappop(self._heap)[2])
            self._drain(batch)


class _Endpoint:
    """One registered endpoint: a priority inbox drained in batches by a
    dedicated worker thread (per-endpoint FIFO up to injected reorder)."""

    def __init__(self, endpoint_id: str, handler: Handler, transport: "SimTransport") -> None:
        self.id = endpoint_id
        self.handler = handler
        self._t = transport
        # msg_id -> cached reply (exactly-once processing under retries)
        self._seen: "OrderedDict[str, Tuple[str, bytes]]" = OrderedDict()
        self._q = _TimedQueue(
            f"sim-ep-{endpoint_id}",
            self._drain_batch,
            max_batch=lambda: transport.batch_size,
            clock=transport.clock,
        )

    def push(self, env: Envelope) -> None:
        self._q.push(env.deliver_at, env)

    def stop(self) -> None:
        self._q.stop()

    def _drain_batch(self, batch: List[Envelope]) -> None:
        self._t._note_batch(len(batch))
        for env in batch:
            self._process(env)

    def _process(self, env: Envelope) -> None:
        if not env.needs_reply:
            # fire-and-forget: no reply traffic, no dedup (nothing retries),
            # and handler errors vanish with the message — a dying worker
            # thread is the one failure mode this must never have. Exception,
            # not BaseException: the simulation's TaskCancelled must fly.
            try:
                args, kwargs = wire.loads(env.payload)
                self.handler(env.method, *args, **kwargs)
            except Exception:  # noqa: BLE001
                pass
            return
        cached = self._seen.get(env.msg_id)
        if cached is not None:
            # duplicate of an already-processed request (its reply was lost):
            # resend the cached reply without re-invoking the handler.
            self._t._send_reply(env, *cached)
            return
        try:
            args, kwargs = wire.loads(env.payload)
            result = self.handler(env.method, *args, **kwargs)
            outcome = ("ok", wire.dumps(result))
        except DelayMessage:
            # deliberately uncached: the sender retries the SAME msg_id once
            # the receiver has caught up with the failure epoch.
            self._t._send_reply(env, "delay", b"")
            return
        except Exception as e:  # noqa: BLE001 — carried to the caller; the
            # simulation's TaskCancelled (a BaseException) must NOT be caught,
            # cached, and replied — it tears down this worker, nothing else
            try:
                blob = wire.dumps(e)
            except Exception:
                # unpicklable exception (locks, handles, device buffers):
                # degrade to a picklable stand-in rather than killing the
                # endpoint worker thread.
                blob = wire.dumps(RuntimeError(f"{type(e).__name__}: {e!r}"))
            outcome = ("err", blob)
        self._seen[env.msg_id] = outcome
        while len(self._seen) > self._t.dedup_cache_size:
            self._seen.popitem(last=False)
        self._t._send_reply(env, *outcome)


class SimTransport(Transport):
    """In-process fabric with per-link faults and batched delivery."""

    def __init__(
        self,
        *,
        seed: int = 0,
        default_link: Optional[LinkSpec] = None,
        batch_size: int = 64,
        call_timeout: float = 10.0,
        retry_timeout: float = 0.05,
        delay_backoff: float = 0.002,
        dedup_cache_size: int = 8192,
        clock: Clock = REAL_CLOCK,
    ) -> None:
        self.clock = clock
        self._rng = random.Random(seed)
        self._rng_mu = threading.Lock()
        self._eps: Dict[str, _Endpoint] = {}
        self._links: Dict[Tuple[str, str], LinkSpec] = {}
        self._method_links: Dict[str, LinkSpec] = {}
        self._default = default_link or LinkSpec()
        self._partition_groups: List[Set[str]] = []
        self._waiters: Dict[str, _Waiter] = {}
        self._waiters_mu = threading.Lock()
        self._msg_seq = itertools.count()
        self.batch_size = batch_size
        self.call_timeout = call_timeout
        self.retry_timeout = retry_timeout
        self.delay_backoff = delay_backoff
        self.dedup_cache_size = dedup_cache_size
        self._closed = False

        self._stats_mu = threading.Lock()
        self._stats = {
            "sent": 0,
            "delivered_batches": 0,
            "delivered_msgs": 0,
            "dropped_loss": 0,
            "dropped_partition": 0,
            "duplicated": 0,
            "retries": 0,
            "bytes": 0,
        }

        # reply scheduler: replies traverse the same faulty links
        self._replies = _TimedQueue("sim-replies", self._drain_replies, clock=clock)

    # -- topology -------------------------------------------------------- #
    def register(self, endpoint_id: str, handler: Handler) -> None:
        old = self._eps.get(endpoint_id)
        if old is not None:
            old.handler = handler  # re-register (restarted incarnation)
            return
        self._eps[endpoint_id] = _Endpoint(endpoint_id, handler, self)

    def set_link(self, src: str, dst: str, **spec) -> None:
        """Configure the directed link src->dst; ``"*"`` wildcards match any
        endpoint. Lookup precedence: method class (see
        :meth:`set_method_link`), (src,dst), (src,*), (*,dst), default."""
        self._links[(src, dst)] = LinkSpec(**spec)

    def set_method_link(self, method: str, **spec) -> None:
        """Fault a *message class*: every message carrying ``method``
        (e.g. all ``report`` or ``poll`` traffic), whatever its endpoints,
        takes this link spec. Fault plans use this to target protocol roles
        rather than topology."""
        self._method_links[method] = LinkSpec(**spec)

    def clear_method_link(self, method: str) -> None:
        self._method_links.pop(method, None)

    def _link(self, src: str, dst: str, method: Optional[str] = None) -> LinkSpec:
        if method is not None and method in self._method_links:
            return self._method_links[method]
        for key in ((src, dst), (src, "*"), ("*", dst)):
            if key in self._links:
                return self._links[key]
        return self._default

    def partition(self, *groups: Set[str]) -> None:
        """Split the fabric: endpoints communicate only within their group.
        Endpoints not listed in any group form one implicit remainder group.
        Messages crossing the cut are dropped (senders keep retrying, so a
        later :meth:`heal` lets the traffic through)."""
        self._partition_groups = [set(g) for g in groups]

    def heal(self) -> None:
        self._partition_groups = []

    def _cut(self, src: str, dst: str) -> bool:
        groups = self._partition_groups
        if not groups:
            return False

        def group_of(x: str) -> int:
            for i, g in enumerate(groups):
                if x in g:
                    return i
            return -1  # implicit remainder group

        return group_of(src) != group_of(dst)

    # -- send path ------------------------------------------------------- #
    def _roll(self, link: LinkSpec) -> Optional[Tuple[float, Optional[float]]]:
        """Returns (delay, duplicate_delay) in seconds — duplicate_delay is
        None unless the wire duplicated the message — or None if lost."""
        with self._rng_mu:
            if link.loss_prob and self._rng.random() < link.loss_prob:
                return None
            d = link.latency_ms
            if link.jitter_ms:
                d += self._rng.random() * link.jitter_ms
            if link.reorder_prob and self._rng.random() < link.reorder_prob:
                d += link.reorder_ms
            dup = None
            if link.dup_prob and self._rng.random() < link.dup_prob:
                dup = (d + link.dup_ms) / 1e3
        return d / 1e3, dup

    def _send(self, env: Envelope) -> None:
        with self._stats_mu:
            self._stats["sent"] += 1
            self._stats["bytes"] += len(env.payload)
        if self._cut(env.src, env.dst):
            with self._stats_mu:
                self._stats["dropped_partition"] += 1
            return
        rolled = self._roll(self._link(env.src, env.dst, env.method))
        if rolled is None:
            with self._stats_mu:
                self._stats["dropped_loss"] += 1
            return
        delay, dup = rolled
        ep = self._eps.get(env.dst)
        if ep is None:
            raise TransportError(f"unknown endpoint {env.dst!r}")
        env.deliver_at = self.clock.now() + delay
        ep.push(env)
        if dup is not None:
            # wire-level duplicate: same msg_id, so receiver-side dedup keeps
            # processing exactly-once (casts, which skip dedup, may observe it)
            with self._stats_mu:
                self._stats["duplicated"] += 1
            twin = copy.copy(env)
            twin.deliver_at = self.clock.now() + dup
            ep.push(twin)

    def _send_reply(self, request: Envelope, status: str, blob: bytes) -> None:
        """Schedule a reply over the dst->src link (same fault model)."""
        with self._stats_mu:
            self._stats["bytes"] += len(blob)
        if self._cut(request.dst, request.src):
            with self._stats_mu:
                self._stats["dropped_partition"] += 1
            return
        rolled = self._roll(self._link(request.dst, request.src, request.method))
        if rolled is None:
            with self._stats_mu:
                self._stats["dropped_loss"] += 1
            return
        delay, dup = rolled
        self._replies.push(self.clock.now() + delay, (request.msg_id, status, blob))
        if dup is not None:
            # duplicate reply: the waiter takes the first, drops the twin
            self._replies.push(self.clock.now() + dup, (request.msg_id, status, blob))

    def _drain_replies(self, batch: List[Tuple[str, str, bytes]]) -> None:
        for msg_id, status, blob in batch:
            with self._waiters_mu:
                waiter = self._waiters.get(msg_id)
            if waiter is not None:
                waiter.resolve(status, blob)

    def _note_batch(self, n: int) -> None:
        if n == 0:
            return
        with self._stats_mu:
            self._stats["delivered_batches"] += 1
            self._stats["delivered_msgs"] += n

    # -- RPC ------------------------------------------------------------- #
    def call(self, src: str, dst: str, method: str, *args, timeout: Optional[float] = None, **kwargs):
        payload = wire.dumps((args, kwargs))
        msg_id = f"{src}:{next(self._msg_seq)}"
        waiter = _Waiter(self.clock)
        with self._waiters_mu:
            self._waiters[msg_id] = waiter
        deadline = self.clock.now() + (timeout if timeout is not None else self.call_timeout)
        attempt = 0
        try:
            while True:
                attempt += 1
                if attempt > 1:
                    with self._stats_mu:
                        self._stats["retries"] += 1
                self._send(Envelope(msg_id, src, dst, method, payload, attempt=attempt))
                budget = min(self.retry_timeout * min(attempt, 8), deadline - self.clock.now())
                if budget > 0 and waiter.event.wait(budget):
                    result = waiter.take()
                    if result is not None:
                        status, blob = result
                        if status == "ok":
                            return wire.loads(blob)
                        if status == "err":
                            raise wire.loads(blob)
                        # status == "delay": back off, retry the SAME msg_id
                        self.clock.sleep(self.delay_backoff)
                if self.clock.now() >= deadline:
                    raise TimeoutError(
                        f"{src}->{dst} {method}: no reply after {attempt} attempts"
                    )
        finally:
            with self._waiters_mu:
                self._waiters.pop(msg_id, None)

    def cast(self, src: str, dst: str, method: str, *args, **kwargs) -> None:
        payload = wire.dumps((args, kwargs))
        self._send(
            Envelope(
                f"{src}:{next(self._msg_seq)}", src, dst, method, payload, needs_reply=False
            )
        )

    # -- introspection / lifecycle --------------------------------------- #
    def stats(self) -> Dict[str, float]:
        with self._stats_mu:
            out = dict(self._stats)
        out["mean_batch"] = (
            out["delivered_msgs"] / out["delivered_batches"]
            if out["delivered_batches"]
            else 0.0
        )
        return out

    def close(self) -> None:
        self._closed = True
        self._replies.stop()
        for ep in self._eps.values():
            ep.stop()
