"""The port's recorder (``repro_torch.obs``) and the spans and counters at
its call sites: nesting, parents across threads, counters, the disabled
recorder, every span of a run with a trainer kill, and a loop that ends the
same with the recorder on as off."""
from __future__ import annotations

import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

CFG = get_config("gemma_2b", smoke=True)


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts and ends with the recorder off and empty."""
    obs.disable()
    obs.drain()
    yield
    obs.disable()
    obs.drain()


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nesting_parents_and_request_identifier():
    obs.enable()
    with obs.span("a", step=3) as a:
        with obs.span("b"):
            with obs.span("c", version=1):
                pass
        with obs.span("d") as d:
            d.tag(world=2)
    with obs.span("e"):
        pass
    rec = obs.drain()
    s = {x.name: x for x in rec["spans"]}
    assert [x.name for x in rec["spans"]] == ["c", "b", "d", "a", "e"]  # in order of their end
    assert s["a"].sid == a.sid and s["a"].parent is None and s["a"].req == "step=3"
    assert s["b"].parent == a.sid and s["b"].req == "step=3"
    assert s["c"].parent == s["b"].sid and s["c"].req == "version=1"
    assert s["d"].parent == a.sid and s["d"].req == "world=2"
    assert s["e"].parent is None and s["e"].req is None
    assert s["a"].t0 <= s["b"].t0 <= s["c"].t0 <= s["c"].t1 <= s["b"].t1 <= s["a"].t1
    assert len({x.sid for x in rec["spans"]}) == 5
    me = threading.get_native_id()
    assert {x.tid for x in rec["spans"]} == {me}
    assert rec["threads"][me] == threading.current_thread().name


def test_a_span_on_another_thread_takes_its_parent_explicitly():
    obs.enable()
    with obs.span("persist.snapshot", version=7) as snap:
        pass
    tids = []

    def io():
        tids.append(threading.get_native_id())
        with obs.span("persist.write", parent=snap):
            with obs.span("inner"):
                pass

    t = threading.Thread(target=io, name="so:persist-io")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    s = {x.name: x for x in obs.drain()["spans"]}
    assert s["persist.write"].parent == snap.sid and s["persist.write"].req == "version=7"
    assert s["inner"].parent == s["persist.write"].sid and s["inner"].req == "version=7"
    assert s["persist.write"].tid == tids[0] != s["persist.snapshot"].tid
    assert obs.drain()["threads"][tids[0]] == "so:persist-io"


def test_counters_total_and_drain():
    obs.enable()
    obs.count("persist.stored_bytes", 10)
    obs.count("persist.stored_bytes", 5)
    obs.count("dse.refresh_rounds")
    obs.add_ns("dse.refresh_ns", 1234)
    assert obs.counters() == {"persist.stored_bytes": 15, "dse.refresh_rounds": 1,
                              "dse.refresh_ns": 1234}
    assert obs.counters()["persist.stored_bytes"] == 15  # a look leaves them in place
    assert obs.drain()["counters"] == {"persist.stored_bytes": 15, "dse.refresh_rounds": 1,
                                       "dse.refresh_ns": 1234}
    assert obs.drain()["counters"] == {}


def test_counters_from_many_threads_lose_nothing():
    obs.enable()

    def work():
        for _ in range(2000):
            obs.count("n")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert obs.drain()["counters"] == {"n": 16000}


def test_off_records_nothing_and_hands_out_one_object():
    assert not obs.enabled()
    a = obs.span("a", step=1)
    assert a is obs.span("b") is obs.span("c", parent=a)
    with a as inner:
        inner.tag(world=1)
        obs.count("x", 3)
        obs.add_ns("y", 5)
    assert obs.counters() == {}
    rec = obs.drain()
    assert rec["spans"] == [] and rec["counters"] == {}
    # a span opened off and passed on as a parent once the recorder is on
    obs.enable()
    with obs.span("write", parent=a):
        pass
    [w] = obs.drain()["spans"]
    assert w.parent is None and w.req is None


# -- the call sites ------------------------------------------------------------
STEP_SPANS = ["trainer.train_on", "dse.start_action", "trainer.step", "train_step", "step.h2d",
              "step.forward", "step.backward", "step.optimizer", "dse.end_action"]
TABLE = STEP_SPANS + ["metrics.record", "dse.connect", "persist.snapshot", "persist.d2h",
                      "persist.compress", "persist.write", "trainer.on_crash", "restore",
                      "restore.read", "restore.inflate", "restore.h2d"]


def _drive(cluster, until: int) -> None:
    """Train through the data -> trainer -> metrics loop until the trainer's
    step reaches ``until`` (the loop body of ``run_resilient_training``)."""
    from repro_torch.core import DelayMessage, RolledBackError

    for _ in range(10_000):
        trainer, data, metrics = (cluster.get(k) for k in ("trainer", "data", "metrics"))
        if trainer.current_step() >= until:
            return
        try:
            if data.peek_cursor() != trainer.current_step():
                data.seek(trainer.current_step())
            out = data.next_batch()
            if out is None:
                continue
            step, tokens, hdr = out
            res = trainer.train_on(step, tokens, hdr)
            if res is None:
                cluster.refresh_all()
                continue
            if res[0] == "resync":
                continue
            metrics.record(step, res[0], res[1])
        except (DelayMessage, RolledBackError):
            cluster.refresh_all()
    raise RuntimeError(f"step {until} not reached")


def _state_bytes(so) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_flatten((so.params, so.opt_state))[0])


def test_every_span_of_a_run_with_a_trainer_kill(tmp_path: Path):
    """A tiny model on a LocalCluster: three steps, a trainer kill (rollback
    to version 0, restore, replay). Every span of the call sites appears
    with its parent; the byte counters match the blob; one step's spans
    share its identifier; the refresher is timed on its own thread."""
    from repro_torch.checkpoint import MetricsStateObject, TrainerStateObject
    from repro_torch.core import LocalCluster
    from repro_torch.data import DataPipelineStateObject, SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_descs
    from repro_torch.optim import AdamWConfig, adamw_init

    data = SyntheticLMData(CFG.vocab_size, 2, 16, seed=0)
    step_fn = make_train_step(CFG, AdamWConfig(lr=1e-3), remat="none")

    def init_state():
        params = init_params(param_descs(CFG), torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
        return params, adamw_init(params)

    obs.enable()
    cluster = LocalCluster(tmp_path)
    try:
        cluster.add("data", lambda: DataPipelineStateObject(tmp_path / "data", data))
        trainer = cluster.add("trainer", lambda: TrainerStateObject(
            tmp_path / "trainer", init_state, step_fn, device="cpu"),
            group_commit_interval=3600.0)
        cluster.add("metrics", lambda: MetricsStateObject(tmp_path / "metrics"))
        v0 = obs.drain()
        blob, _ = trainer.store.read(0)
        assert v0["counters"]["persist.stored_bytes"] == len(blob)
        assert v0["counters"]["persist.raw_bytes"] == _state_bytes(trainer)
        # version 0: every moment leaf (and the step, and the weights that
        # start at 0) deflated, each shape once; every other weight stored
        params = tree_flatten(trainer.params)[0]
        zero = [p for p in params if not p.any()]
        moments = tree_flatten(trainer.opt_state)[0]
        assert not any(m.any() for m in moments)
        c = v0["counters"]
        assert c["persist.leaves_deflated"] == len(moments) + len(zero)
        assert c["persist.leaves_stored"] == len(params) - len(zero) > 0
        shapes = {(tuple(t.shape), t.dtype) for t in moments + zero}
        assert c["persist.members_reused"] == len(moments) + len(zero) - len(shapes)
        _drive(cluster, 3)
        cluster.kill("trainer")
        _drive(cluster, 3)
        rec = obs.drain()
        trainer = cluster.get("trainer")
        trainer.runtime.mark_dead()  # no shutdown persist
    finally:
        obs.disable()
        cluster.shutdown()
    spans = by_name(v0["spans"] + rec["spans"])
    assert set(TABLE) <= set(spans), sorted(set(TABLE) - set(spans))
    sid = {s.sid: s for s in v0["spans"] + rec["spans"]}

    def parent(s):
        return sid[s.parent].name if s.parent is not None else None

    # version 0: inside the trainer's connect; the write on the IO thread
    [snap] = spans["persist.snapshot"]
    assert parent(snap) == "dse.connect" and snap.req == "version=0"
    assert {parent(s) for s in spans["persist.d2h"] + spans["persist.compress"]} == \
        {"persist.snapshot"}
    [write] = spans["persist.write"]
    assert write.parent == snap.sid and write.req == "version=0" and write.tid != snap.tid
    # the recovery: the crash's re-init, then the new incarnation's connect
    # restores version 0 leaf by leaf
    [crash] = spans["trainer.on_crash"]
    [restore] = spans["restore"]
    assert parent(restore) == "dse.connect" and crash.t1 <= restore.t0
    world = cluster.get("trainer").runtime.world
    assert restore.req == f"world={world},version=0"
    n_leaves = len(tree_flatten((trainer.params, trainer.opt_state))[0])
    assert len(spans["restore.inflate"]) == len(spans["restore.h2d"]) == n_leaves
    assert {parent(s) for s in spans["restore.read"] + spans["restore.inflate"]
            + spans["restore.h2d"]} == {"restore"}
    assert rec["counters"]["restore.read_bytes"] == len(blob)
    assert rec["counters"]["restore.raw_bytes"] == v0["counters"]["persist.raw_bytes"]
    # the restore inflates each distinct deflated member once
    assert rec["counters"]["restore.members_reused"] == c["persist.members_reused"] > 0
    connects = {s.req for s in spans["dse.connect"]}
    assert f"world={world}" in connects
    # a step: six steps trained (three, then three replayed), each one's
    # spans under one identifier, the phases inside train_step
    assert len(spans["train_step"]) == 6
    for step in range(3):
        req = f"step={step}"
        names = {s.name for s in rec["spans"] if s.req == req}
        assert set(STEP_SPANS) | {"metrics.record"} <= names, (step, names)
    for name in ("step.h2d", "step.forward", "step.backward", "step.optimizer"):
        assert {parent(s) for s in spans[name]} == {"train_step"}
    assert {parent(s) for s in spans["train_step"]} == {"trainer.step"}
    assert {parent(s) for s in spans["dse.start_action"]} == {"trainer.train_on",
                                                              "metrics.record"}
    # the refresher: counters only (it opens no span)
    assert rec["counters"]["dse.refresh_rounds"] > 0 and rec["counters"]["dse.refresh_ns"] > 0
    assert "dse-refresher" not in rec["threads"].values()


def test_microbatched_step_records_its_phases_per_microbatch():
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_descs
    from repro_torch.models.tuning import tuning
    from repro_torch.optim import AdamWConfig, adamw_init

    params = init_params(param_descs(CFG), torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    tokens = torch.randint(0, CFG.vocab_size, (4, 17), generator=torch.Generator().manual_seed(1))
    step = make_train_step(CFG, AdamWConfig(lr=1e-3), remat="none")
    obs.enable()
    with tuning(microbatch=2):
        step(params, adamw_init(params), {"tokens": tokens})
    spans = by_name(obs.drain()["spans"])
    assert len(spans["train_step"]) == 1 and len(spans["step.optimizer"]) == 1
    assert len(spans["step.forward"]) == 2


def test_the_recorder_changes_nothing_it_observes(tmp_path: Path):
    """The loop through a trainer kill ends with the same parameters,
    metrics and external metrics with the recorder on as off."""
    from repro_torch.train import run_resilient_training

    def run(root):
        return run_resilient_training(root, CFG, steps=6, kill_trainer_at=3, device="cpu")

    off = run(tmp_path / "off")
    obs.enable()
    on = run(tmp_path / "on")
    obs.disable()
    rec = obs.drain()
    assert on.rollbacks >= 1 and off.rollbacks >= 1
    assert on.params_digest == off.params_digest
    assert dict(on.metrics) == dict(off.metrics)
    assert sorted(on.external_metrics) == sorted(off.external_metrics)
    assert len(by_name(rec["spans"])["restore"]) >= 1


def test_refresh_is_timed_on_the_background_refresher_alone(tmp_path: Path):
    """The driving thread's own Refresh rounds (``refresh_all`` after a
    delayed message) are not counted; the refresher's are."""
    from repro_torch.checkpoint import MetricsStateObject
    from repro_torch.checkpoint.trainer_so import REFRESHER
    from repro_torch.core import LocalCluster

    obs.enable()
    cluster = LocalCluster(tmp_path, refresh_interval=None)
    try:
        cluster.add("metrics", lambda: MetricsStateObject(tmp_path / "metrics"))
        for _ in range(5):
            cluster.refresh_all()
        assert "dse.refresh_rounds" not in obs.counters()
        t = threading.Thread(target=cluster.refresh_all, name=REFRESHER)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        got = obs.counters()
        assert got["dse.refresh_rounds"] == 1 and got["dse.refresh_ns"] > 0
    finally:
        obs.disable()
        cluster.shutdown()
