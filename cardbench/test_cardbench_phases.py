"""The attribution of device work to the port's spans (``phases.py``):
launches joined by correlation id, idle gaps named from the driving
thread's spans, the readings on synthetic spans, a smoke-size run of the
harness with the recorder on (CPU), and the clock on the card."""
import time

import pytest

torch = pytest.importorskip("torch")

from cardbench import phases, testing  # noqa: E402
from repro_torch import obs  # noqa: E402

MAIN, REFRESHER = 11, 12


@pytest.fixture(autouse=True)
def recorder():
    obs.disable()
    obs.drain()
    yield
    obs.disable()
    obs.drain()


def span(name, t0, t1, sid, parent=None, tid=MAIN, req=None):
    return obs.Span(name, t0, t1, sid, parent, tid, req)


#: one step on the driving thread, and a refresher span over its backward
SPANS = [
    span("trainer.step", 90, 230, 1, req="step=0"),
    span("train_step", 100, 200, 2, 1, req="step=0"),
    span("step.forward", 110, 150, 3, 2, req="step=0"),
    span("step.backward", 150, 190, 4, 2, req="step=0"),
    span("refresh", 140, 180, 5, tid=REFRESHER),
]


def test_launches_are_joined_by_correlation_id_to_the_span_that_launched_them():
    kernels = [
        (300, 310, 1),    # launched in the forward, run after the step's spans closed
        (320, 330, 2),    # launched in the backward
        (400, 420, 3),    # launched in train_step between its phases
        (500, 501, 4),    # launched outside every span
        (700, 710, 6),    # no launch kept
        (800, 810, 7),    # launched before the window
    ]
    launches = {1: 115, 2: 160, 3: 195, 4: 250, 7: 5}
    main = [s for s in SPANS if s.tid == MAIN]
    att = phases.attribute(kernels, launches, main, 10, 1000)
    own = {n: (round(v["device_s"] * 1e9), v["launches"]) for n, v in att["self"].items()}
    assert own == {"step.forward": (10, 1), "step.backward": (10, 1), "train_step": (20, 1),
                   "-": (1, 1)}
    within = {n: (round(v["device_s"] * 1e9), v["launches"]) for n, v in att["within"].items()}
    assert within == {"step.forward": (10, 1), "step.backward": (10, 1), "train_step": (40, 3),
                      "trainer.step": (40, 3), "-": (1, 1)}


def test_idle_gaps_are_named_from_the_driving_threads_spans():
    events = [("k", 100, 130), ("k", 200, 205), ("k", 240, 300)]
    harness = [("step", 90, 235), ("restore", 236, 400)]
    kept = {"offset": 0, "t0": 100, "t1": 400, "events": events, "harness_spans": harness,
            "trace": _Trace([], {})}
    rec = {"spans": SPANS, "threads": {MAIN: "MainThread", REFRESHER: "dse-refresher"}}
    p, gaps = phases.phases_of(kept, rec)
    # 130-200: its middle in the backward and in the refresher's span, which
    # never names a gap; 205-240: in trainer.step alone; 300-400: in the
    # restore, outside every program span
    assert gaps == [["restore", 100e-9], ["step/step.backward", 70e-9],
                    ["step/trainer.step", 35e-9]]
    assert [s.tid for s in p.driver_spans] == [MAIN] * 4


class _Trace:
    def __init__(self, kernels, launches, c0=None, c1=None):
        self.kernels, self.launches = kernels, launches
        self.counters0, self.counters1 = c0 or {}, c1 or {}
        self.clock = None


def test_readings_on_synthetic_spans():
    ms = 1_000_000
    spans = [
        span("persist.compress", -9 * ms, -5 * ms, 20, req="version=0"),
        span("persist.compress", 1 * ms, 2 * ms, 21, req="version=3"),
    ]
    sid = 100
    for k, t in enumerate((10 * ms, 40 * ms)):
        req = f"step={k}"
        spans += [
            span("dse.start_action", t, t + ms // 10, sid, req=req),
            span("trainer.step", t + ms, t + 21 * ms, sid + 1, req=req),
            span("train_step", t + ms, t + 16 * ms, sid + 2, sid + 1, req=req),
            span("step.forward", t + 2 * ms, t + 6 * ms, sid + 3, sid + 2, req=req),
            span("dse.end_action", t + 21 * ms, t + 21 * ms + ms // 5, sid + 4, req=req),
        ]
        sid += 10
    spans += [span("restore.inflate", 70 * ms, 72 * ms, 500),
              span("restore.inflate", 73 * ms, 76 * ms, 501)]
    kernels = [(0, 3 * ms, 1), (0, ms, 2)]
    launches = {1: 13 * ms, 2: 44 * ms}
    tr = _Trace(kernels, launches, {"dse.refresh_ns": 5 * ms, "dse.refresh_rounds": 9},
                {"dse.refresh_ns": 9 * ms, "dse.refresh_rounds": 20})
    kept = {"offset": 0, "t0": 0, "t1": 100 * ms, "events": [], "harness_spans": [],
            "trace": tr}
    p, _ = phases.phases_of(kept, {"spans": spans, "threads": {MAIN: "MainThread"}})
    got = {k: v["value"] for k, v in phases.read_all(p).items()}
    assert got == pytest.approx({
        "step_dispatch_ms": 15.0, "step_sync_wait_ms": 5.0, "step_launches": 1.0,
        "fwd_device_ms": 2.0, "bwd_device_ms": 0.0, "adamw_device_ms": 0.0,
        "dse_action_ms": 0.3, "dse_refresh_busy_pct": 4.0, "persist_v0_compress_s": 4e-3,
        "restore_inflate_s": 5e-3})
    assert phases.coverage(p) == pytest.approx((2.0, 2.0))
    # nothing to read: no step, no restore, no counters, no version-0 persist
    empty = phases.Phases([], [], 0, 1, {}, {}, {"self": {}, "within": {}})
    assert phases.read_all(empty) == {}


def test_a_smoke_run_through_the_harness_with_the_recorder_on():
    """The harness's own run, its trace swapped and its reduce kept, with
    the recorder on from before set-up: the result line is the harness's,
    the spans of set-up, the window and the kill are there, and the
    readings that need no card read a number."""
    from cardbench import harness, trace

    real = trace.DeviceTrace, trace.reduce
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as testing.run_smoke_process: threads only contend here
    obs.enable()
    try:
        with phases.capture({}) as kept:
            out = testing.run_smoke("zamba2-1.2b-x8.train-kill", traced=True)
    finally:
        torch.set_num_threads(threads)
    rec = obs.drain()
    obs.disable()
    assert (trace.DeviceTrace, trace.reduce) == real
    assert out["correct"] is True, out["checks"]
    cell = harness.load_cell("zamba2-1.2b-x8.train-kill")
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer} - {"train_mfu",
                                                                          "device_idle_pct"}
    p, gaps = phases.phases_of(kept, rec)
    got = phases.read_all(p)
    assert {"step_dispatch_ms", "step_sync_wait_ms", "dse_action_ms", "dse_refresh_busy_pct",
            "persist_v0_compress_s", "restore_inflate_s"} <= set(got)
    assert got["step_launches"]["value"] == 0  # the CPU launches nothing
    assert got["step_dispatch_ms"]["value"] > 0 and got["restore_inflate_s"]["value"] > 0
    assert [round(g[1], 6) for g in gaps] == [round(out["device"]["window_s"], 6)]  # no device


@pytest.mark.cuda
def test_the_clock_on_the_card():
    """Inside span A, 100 small kernels; 5 ms of sleep; inside span B, 100
    more: the attribution gives exactly 100 to each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the runtime's launch events come from CUPTI")
    x = torch.zeros(1024, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    tr = phases.RuntimeTrace(True)
    obs.enable()
    tr.start()
    t0 = time.perf_counter_ns()
    with obs.span("A"):
        for _ in range(100):
            x.add_(1)
    time.sleep(0.005)
    with obs.span("B"):
        for _ in range(100):
            x.add_(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter_ns()
    tr.stop()
    rec = obs.drain()
    obs.disable()
    main = phases.to_trace(rec["spans"], tr.clock)
    [window] = phases.to_trace([obs.Span("window", t0, t1, 0, None, 0, None)], tr.clock)
    att = phases.attribute(tr.kernels, tr.launches, main, window.t0, window.t1)
    assert {n: v["launches"] for n, v in att["self"].items()} == {"A": 100, "B": 100}, \
        (att["self"], tr.clock)
    assert float(x[0]) == 201.0


def test_clock_offset_from_the_marker_calls():
    """Each marker call lies inside the host's bracket around it: the
    offset is the middle of what the brackets allow, and spans move along
    the line through the start's and the stop's offsets."""
    # host brackets (perf ns) and the calls on the trace's clock, 1000 ns on
    marks = [(100, 160), (200, 230)]
    marked = [(1110, 1130), (1205, 1225)]
    assert phases.clock_offset(marks, marked) == (100, 1000, 5)
    clock = ((0, 1000, 5), (1000, 3000, 5))  # the trace's clock runs 3x as fast
    [s] = phases.to_trace([obs.Span("a", 500, 600, 1, None, 0, None)], clock)
    assert (s.t0, s.t1) == (2500, 2800)
    [s] = phases.to_trace([obs.Span("a", 500, 600, 1, None, 0, None)], 7)
    assert (s.t0, s.t1) == (507, 607)
