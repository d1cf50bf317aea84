"""The device trace of a ``--trace 1`` run, and its reduction.

``torch.profiler`` traces the card's activity (kernels, copies, sets) from
the end of set-up to the end of the window; CUPTI's start is paid in
set-up. The reduction reads the raw events, with no per-operator
aggregation, so that a window of some million kernels reduces in seconds:

- ``busy_s``: the union of the device intervals inside the window;
- ``device_ops``: the ten kernel names with the most device time;
- ``idle_gaps``: the ten longest stretches inside the window with nothing
  on the device, each named by the harness span that was open on the host
  at its middle (``step``, ``restore``, ``check``; ``driver`` otherwise).

The profiler's timestamps are on the host's wall clock (``time.time_ns``);
the harness's spans are converted to it with one offset.
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

NAME_CHARS = 160


class DeviceTrace:
    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled and torch.cuda.is_available()
        self.prof = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> List[Tuple[str, int, int]]:
        """-> the device intervals (name, start_ns, end_ns)."""
        if self.prof is None:
            return []
        torch.cuda.synchronize()
        self.prof.stop()
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
                out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        self.prof = None
        return out


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _span_at(t: int, spans: List[Tuple[str, int, int]]) -> str:
    best: Optional[Tuple[int, str]] = None
    for name, a, b in spans:
        if a <= t < b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "driver"


def reduce(events: List[Tuple[str, int, int]], t0: int, t1: int,
           spans: List[Tuple[str, int, int]]) -> Dict:
    """Device events and host spans (wall-clock ns) over the window [t0, t1)."""
    inside = [(max(a, t0), min(b, t1)) for _, a, b in events if b > t0 and a < t1]
    busy = _merge(inside)
    busy_ns = sum(b - a for a, b in busy)
    by_name: Dict[str, int] = defaultdict(int)
    for name, a, b in events:
        if b > t0 and a < t1:
            by_name[name[:NAME_CHARS]] += min(b, t1) - max(a, t0)
    ops = heapq.nlargest(10, by_name.items(), key=lambda kv: kv[1])
    gaps, last = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > last:
            gaps.append((a - last, last))
        last = max(last, b)
    longest = heapq.nlargest(10, gaps)
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "n_events": len(inside),
        "device_ops": [[n, ns / 1e9] for n, ns in ops],
        "idle_gaps": [[_span_at(start + dur // 2, spans), dur / 1e9] for dur, start in longest],
    }
