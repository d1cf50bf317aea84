"""Where a traced run's time goes, read from the port's own spans on the
device trace's clock.

    python3 -m cardbench.phases --workload zamba2-1.2b-x8.train-kill --seed 7 --seconds 51

from the root of a checkout runs one ``--trace 1`` run of the cell through
the harness, as ``run.py`` does, with two additions: the port's recorder
(``repro_torch.obs``) is on from before set-up, and the trace keeps, beside
the device events, the CUDA runtime and driver calls that launched them
(``RuntimeTrace``). Each kernel, copy or set is joined to its launch by
CUPTI's correlation id, and the launch to the innermost program span open on
the driving thread at that moment (``attribute``). The harness's result line is printed unchanged;
the last line is one JSON object: the readings of ``READINGS`` and the
attribution and idle gaps they come from. The spans' coverage of the step
(the three phases' device time against everything ``train_step`` launched)
is also printed on standard error.

The harness is not edited: the run swaps the trace module's ``DeviceTrace``
for ``RuntimeTrace`` and keeps the arguments of its ``reduce`` while it
lasts. Program spans are on ``time.perf_counter_ns``, the trace on kineto's
conversion of CUPTI's clock to the host's wall clock, which can stand some
microseconds off ``time.time_ns`` and drift from it: marker calls at the
trace's start and stop measure the offset at both ends (``clock_offset``),
so that a launch made just before a span closes falls inside it.
"""
from __future__ import annotations

import bisect
import contextlib
import heapq
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

T_PROCESS = time.perf_counter()

import torch  # noqa: E402

from . import trace  # noqa: E402

#: the thread that drives the loop (the harness's, the process's main thread)
DRIVER = "MainThread"
#: the runtime call that marks the trace's clock against the host's (no
#: other code of a run makes it), and how many marks a trace takes at its
#: start and at its stop
MARK = "cudaStreamQuery"
MARKS = 16


def _marks() -> List[Tuple[int, int]]:
    """``perf_counter_ns`` just before and just after each of ``MARKS``
    ``MARK`` calls."""
    stream = torch.cuda.current_stream()
    out = []
    for _ in range(MARKS):
        a = time.perf_counter_ns()
        stream.query()
        out.append((a, time.perf_counter_ns()))
    return out


def clock_offset(marks, marked) -> Tuple[int, int, int]:
    """-> (perf ns of the first mark, the trace's clock less
    ``perf_counter_ns``, half the width of the range it is known to). Each
    ``MARK`` call (``marked``: start, end on the trace's clock) lies inside
    the host's bracket around it (``marks``), which bounds the offset from
    both sides."""
    lo = max(c1 - b for (a, b), (c0, c1) in zip(marks, marked))
    hi = min(c0 - a for (a, b), (c0, c1) in zip(marks, marked))
    return marks[0][0], (lo + hi) // 2, (hi - lo) // 2


class RuntimeTrace(trace.DeviceTrace):
    """``DeviceTrace`` that also keeps each device event's correlation id
    and the launch (runtime or driver call) it belongs to, and the trace's
    clock against ``perf_counter_ns`` (``clock``: ``clock_offset`` at the
    trace's start and at its stop; None without a trace or its marks)."""

    def start(self) -> None:
        from repro_torch import obs

        super().start()
        self.counters0 = obs.counters()
        self.marks = _marks() if self.prof is not None else []

    def stop(self) -> List[Tuple[str, int, int]]:
        """-> what ``DeviceTrace.stop`` returns; keeps ``kernels`` (start,
        end, correlation id) beside it, and ``launches`` (correlation id ->
        the host's wall ns at the runtime or driver call)."""
        from repro_torch import obs

        self.kernels: List[Tuple[int, int, int]] = []
        self.launches: Dict[int, int] = {}
        self.clock: Optional[tuple] = None
        self.counters1 = obs.counters()
        if self.prof is None:
            return []
        torch.cuda.synchronize()
        self.marks += _marks()
        self.prof.stop()
        out, marked = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                if e.duration_ns() > 0:
                    a = e.start_ns()
                    out.append((e.name(), a, a + e.duration_ns()))
                    self.kernels.append((a, a + e.duration_ns(), e.correlation_id()))
            elif e.correlation_id():
                self.launches[e.correlation_id()] = e.start_ns()
                if e.name() == MARK:
                    marked.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        if len(marked) == len(self.marks):
            marked.sort()
            self.clock = (clock_offset(self.marks[:MARKS], marked[:MARKS]),
                          clock_offset(self.marks[MARKS:], marked[MARKS:]))
        self.prof = None
        return out


def to_trace(spans, clock) -> list:
    """Spans moved from ``perf_counter_ns`` to the trace's clock: by one
    offset (an int), or along the line through ``RuntimeTrace.clock``'s two
    points, which follows the clocks' drift over a window."""
    if isinstance(clock, int):
        def move(t: int) -> int:
            return t + clock
    else:
        (ta, oa, _), (tb, ob, _) = clock

        def move(t: int) -> int:
            return t + oa + (ob - oa) * (t - ta) // max(tb - ta, 1)
    return [s._replace(t0=move(s.t0), t1=move(s.t1)) for s in spans]


def _segments(spans) -> Tuple[List[int], list]:
    """The nested spans of one thread cut into disjoint pieces, each
    labelled by the innermost span open over it -> (starts, pieces)."""
    edges = []
    for s in spans:
        edges.append((s.t0, 1, s.t0 - s.t1, s))   # outer before inner at one instant
        edges.append((s.t1, 0, 0, s))             # ends before starts at one instant
    edges.sort(key=lambda e: e[:3])
    stack, pieces, last = [], [], None
    for t, is_start, _, s in edges:
        if stack and t > last:
            pieces.append((last, t, stack[-1]))
        if is_start:
            stack.append(s)
        else:
            stack.remove(s)
        last = t
    return [p[0] for p in pieces], pieces


def _innermost(t: int, starts: List[int], pieces: list):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < pieces[i][1]:
        return pieces[i][2]
    return None


def attribute(kernels, launches, spans, t0: int,
              t1: int) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Device seconds and launches of what the window's launches started,
    by program span. ``kernels``: (start, end, correlation id) device
    intervals; ``launches``: correlation id -> wall ns; ``spans``: the
    driving thread's spans on the wall clock. A launch is placed by its time
    alone: kineto gives every runtime call one thread id, not the caller's,
    and in a window no other thread launches (the trainer persists at a
    cadence of an hour, on the driving thread's connect).
    -> ``{"self": {name: {"device_s", "launches"}}, "within": {...}}``:
    by the innermost span open at the launch, and by every span around it
    (a launch counts once under each name around it). A launch outside
    every span counts under ``"-"``."""
    by_sid = {s.sid: s for s in spans}
    starts, pieces = _segments(spans)
    names_around: Dict[int, Tuple[str, ...]] = {}

    def around(s) -> Tuple[str, ...]:
        if s.sid not in names_around:
            names, p = [], s
            while p is not None:
                names.append(p.name)
                p = by_sid.get(p.parent)
            names_around[s.sid] = tuple(dict.fromkeys(names))
        return names_around[s.sid]

    own: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
    within: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
    for a, b, corr in kernels:
        launch = launches.get(corr)
        if launch is None or not t0 <= launch < t1:
            continue
        s = _innermost(launch, starts, pieces)
        for acc, names in ((own, (s.name,) if s else ("-",)), (within, around(s) if s else ("-",))):
            for n in names:
                acc[n][0] += b - a
                acc[n][1] += 1
    return {k: {n: {"device_s": ns / 1e9, "launches": c} for n, (ns, c) in acc.items()}
            for k, acc in (("self", own), ("within", within))}


def idle_gaps(events, t0: int, t1: int, harness_spans, spans, n: int = 10) -> list:
    """The ``n`` longest stretches of the window with nothing on the device,
    each named ``"<harness span>/<innermost driving-thread span>"`` at its
    middle (the harness's name alone where no program span is open)."""
    busy = trace._merge([(max(a, t0), min(b, t1)) for _, a, b in events if b > t0 and a < t1])
    gaps, last = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > last:
            gaps.append((a - last, last))
        last = max(last, b)
    starts, pieces = _segments(spans)
    out = []
    for dur, start in heapq.nlargest(n, gaps):
        mid = start + dur // 2
        s = _innermost(mid, starts, pieces)
        name = trace._span_at(mid, harness_spans)
        out.append([f"{name}/{s.name}" if s else name, dur / 1e9])
    return out


# -- readings ----------------------------------------------------------------
class Phases:
    """What the readings read: the driving thread's program spans and
    every thread's, on the wall clock; the window; the counters at its
    bounds; the attribution."""

    def __init__(self, spans, driver_spans, t0: int, t1: int, counters0: dict,
                 counters1: dict, attribution: dict) -> None:
        self.spans, self.driver_spans = spans, driver_spans
        self.t0, self.t1 = t0, t1
        self.counters0, self.counters1 = counters0, counters1
        self.attribution = attribution

    def window(self, name: str) -> list:
        """The driving thread's ``name`` spans that start in the window."""
        return [s for s in self.driver_spans if s.name == name and self.t0 <= s.t0 < self.t1]

    @property
    def steps(self) -> int:
        return len(self.window("train_step"))

    def within(self, name: str, key: str) -> float:
        return self.attribution["within"].get(name, {}).get(key, 0)

    def counted(self, name: str) -> int:
        return self.counters1.get(name, 0) - self.counters0.get(name, 0)

    def self_ns(self) -> Dict[str, List[int]]:
        """name -> [self ns, count] of the driving thread's spans that start
        in the window: each span's time less its children's."""
        spans = [s for s in self.driver_spans if self.t0 <= s.t0 < self.t1]
        children: Dict[int, int] = defaultdict(int)
        for s in self.driver_spans:
            if s.parent is not None:
                children[s.parent] += s.t1 - s.t0
        out: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
        for s in spans:
            out[s.name][0] += s.t1 - s.t0 - children[s.sid]
            out[s.name][1] += 1
        return out


def _ms(spans) -> float:
    return sum(s.t1 - s.t0 for s in spans) / 1e6


def step_dispatch_ms(p: Phases):
    return _ms(p.window("train_step")) / p.steps if p.steps else None


def step_sync_wait_ms(p: Phases):
    ns, n = p.self_ns().get("trainer.step", (0, 0))
    return ns / 1e6 / n if n else None


def step_launches(p: Phases):
    return p.within("train_step", "launches") / p.steps if p.steps else None


def _device_ms(name: str) -> Callable[[Phases], Optional[float]]:
    def read(p: Phases):
        return 1e3 * p.within(name, "device_s") / p.steps if p.steps else None
    return read


def dse_action_ms(p: Phases):
    if not p.steps:
        return None
    return (_ms(p.window("dse.start_action")) + _ms(p.window("dse.end_action"))) / p.steps


def dse_refresh_busy_pct(p: Phases):
    if "dse.refresh_rounds" not in p.counters1:
        return None
    return 100.0 * p.counted("dse.refresh_ns") / (p.t1 - p.t0)


def persist_v0_compress_s(p: Phases):
    v0 = [s for s in p.spans if s.name == "persist.compress" and s.req == "version=0"]
    return (v0[0].t1 - v0[0].t0) / 1e9 if v0 else None


def restore_inflate_s(p: Phases):
    spans = p.window("restore.inflate")
    return _ms(spans) / 1e3 if spans else None


#: name -> (unit, reader): the per-layer metrics these spans and counters feed
READINGS = {
    "step_dispatch_ms": ("ms", step_dispatch_ms),
    "step_sync_wait_ms": ("ms", step_sync_wait_ms),
    "step_launches": ("count", step_launches),
    "fwd_device_ms": ("ms", _device_ms("step.forward")),
    "bwd_device_ms": ("ms", _device_ms("step.backward")),
    "adamw_device_ms": ("ms", _device_ms("step.optimizer")),
    "dse_action_ms": ("ms", dse_action_ms),
    "dse_refresh_busy_pct": ("%", dse_refresh_busy_pct),
    "persist_v0_compress_s": ("s", persist_v0_compress_s),
    "restore_inflate_s": ("s", restore_inflate_s),
}


def read_all(p: Phases) -> Dict[str, dict]:
    out = {}
    for name, (unit, read) in READINGS.items():
        value = read(p)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def coverage(p: Phases) -> Tuple[float, float]:
    """(forward + backward + optimizer device ms, train_step's device ms), per step."""
    if not p.steps:
        return 0.0, 0.0
    phases = sum(p.within(n, "device_s") for n in ("step.forward", "step.backward",
                                                    "step.optimizer"))
    return 1e3 * phases / p.steps, 1e3 * p.within("train_step", "device_s") / p.steps


# -- one run -------------------------------------------------------------------
@contextlib.contextmanager
def capture(kept: dict):
    """Swap the trace module's ``DeviceTrace`` for ``RuntimeTrace`` and keep
    the trace object and ``reduce``'s arguments in ``kept`` while open."""
    saved = trace.DeviceTrace, trace.reduce

    def runtime_trace(enabled: bool) -> RuntimeTrace:
        kept["trace"] = RuntimeTrace(enabled)
        return kept["trace"]

    def reduce(events, t0, t1, spans):
        kept.update(events=events, t0=t0, t1=t1, harness_spans=spans,
                    offset=time.time_ns() - time.perf_counter_ns())
        return saved[1](events, t0, t1, spans)

    trace.DeviceTrace, trace.reduce = runtime_trace, reduce
    try:
        yield kept
    finally:
        trace.DeviceTrace, trace.reduce = saved


def phases_of(kept: dict, rec: dict) -> Tuple[Phases, list]:
    """The readings' input from a captured run and the drained recorder.
    Program spans go to the trace's clock by its marks, else by the host's
    own offset (wall less perf_counter), as the harness's spans."""
    driver = [tid for tid, name in rec["threads"].items() if name == DRIVER]
    tid = driver[0] if driver else None
    tr = kept["trace"]
    spans = to_trace(rec["spans"], tr.clock or kept["offset"])
    mine = [s for s in spans if s.tid == tid]
    att = attribute(tr.kernels, tr.launches, mine, kept["t0"], kept["t1"])
    gaps = idle_gaps(kept["events"], kept["t0"], kept["t1"], kept["harness_spans"], mine)
    return Phases(spans, mine, kept["t0"], kept["t1"], tr.counters0, tr.counters1, att), gaps


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from . import harness, run  # run: the benchmark's environment and paths

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from repro_torch import obs

    cell = harness.load_cell(args.workload)
    obs.enable()
    with capture({}) as kept:
        out = harness.run_cell(cell, args.seed, args.seconds, True, device="cuda",
                               t_process=T_PROCESS)
    rec = obs.drain()
    obs.disable()
    t_reduce = time.perf_counter()
    p, gaps = phases_of(kept, rec)
    readings = read_all(p)
    reduce_s = time.perf_counter() - t_reduce
    phase_ms, step_ms = coverage(p)
    print(f"[phases] {cell.name} seed {args.seed}: {len(rec['spans'])} program spans, "
          f"{len(kept['trace'].launches)} launches kept, attribution {reduce_s:.3f} s; "
          f"per step: forward + backward + optimizer {phase_ms:.3f} ms of the device, "
          f"train_step {step_ms:.3f} ms ({100 * phase_ms / step_ms if step_ms else 0:.2f}%); "
          f"the trace's clock by its marks {kept['trace'].clock}, by the wall offset "
          f"{kept['offset']}",
          file=sys.stderr, flush=True)
    print(json.dumps(run.finite(out)), flush=True)
    print(json.dumps(run.finite({
        "metrics": readings, "steps": p.steps, "coverage_ms": [phase_ms, step_ms],
        "self_ms_a_step": {n: ns / 1e6 / max(p.steps, 1) for n, (ns, _) in p.self_ns().items()},
        "clock": kept["trace"].clock, "wall_offset_ns": kept["offset"],
        "window_counters": {k: p.counted(k) for k in p.counters1},
        "attribution": p.attribution, "idle_gaps": gaps, "counters": rec["counters"],
        "threads": {str(k): v for k, v in rec["threads"].items()}})), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
