"""Seed-sweep driver + fault-plan shrinker (DESIGN.md §8).

``python -m repro.sim.explore --scenario kv --scenario workflow --seeds 100``
runs N seeds of each named scenario under deterministic simulation; each
seed derives the client op scripts AND the fault schedule, so a failure is
reproducible from ``(scenario, seed)``. On the first failure the driver
ddmin-shrinks the fault plan to a minimal still-failing repro and writes a
JSON artifact (scenario, seed, shrunk plan, error) — CI uploads it, and the
pinned-seed regression suite (``tests/test_sim_scenarios.py``) replays it
forever after.

Scenarios (registry ``SCENARIOS``):

* ``kv``        — concurrent clients against SpeculativeKVStore under benign
                  faults (loss/dup/delay/partition/shard restarts); must be
                  linearizable, watermarks monotone, shard logs consistent.
* ``counter``   — producer→consumer chain under crash-restarts; consistent
                  prefix + durable-floor survival + exactly-once acks.
* ``workflow``  — WorkflowEngine driving KV steps over the faulty fabric;
                  workflows complete with exactly-once step effects.
* ``crash_commit`` / ``partition_merge`` / ``dup_fragments`` — the pinned
  regression scenarios (explicit fault plans at nasty protocol moments).
* ``broker``    — produce→consume→ack pipeline over the speculative event
                  broker under benign faults; exactly-once in-order delivery.
* ``two_phase_commit`` — transactional client over TwoPC under crashes +
                  partitions; acked commits are durable + atomic everywhere.
* ``differential_kv`` / ``differential_workflow`` — the differential oracle
  (``sim/differential.py``): one seeded history + fault plan replayed on
  both the DSE and the synchronous durable runtime; committed results must
  match op-for-op (durable = oracle).
* ``snapshot_recovery_kv`` / ``snapshot_recovery_workflow`` — the
  snapshot-vs-replay oracle (DESIGN.md §11): one seeded history + long-
  horizon crash/restart plan with interleaved checkpoints, replayed on a
  compaction-armed cluster and a full-replay cluster; recovery from
  snapshot+suffix must be observationally identical to full replay.
"""
from __future__ import annotations

import argparse
import json
import random
import shutil
import sys
import tempfile
import time
from functools import partial
from pathlib import Path
from typing import Callable, Dict, List, Optional

from ..net import LinkSpec
from .cluster import RecordingClient, SimCluster, SimResult
from .differential import (
    default_differential_plan,
    default_snapshot_plan,
    differential_kv_scenario,
    differential_workflow_scenario,
    snapshot_recovery_kv_scenario,
    snapshot_recovery_workflow_scenario,
)
from .faults import FaultPlan
from .invariants import (
    CounterModel,
    InvariantViolation,
    KVModel,
    check_exactly_once_counter,
    check_linearizable,
    check_shard_logs,
)

Scenario = Callable[[int, Path, Optional[FaultPlan]], SimResult]


def default_plan(scenario: str, seed: int) -> FaultPlan:
    """The fault schedule a scenario runs when no explicit plan is passed —
    the single source of truth, so ``sweep()`` shrinks exactly the plan the
    failing run executed (a regenerated plan with different RNG draws would
    never reproduce the failure)."""
    if scenario == "kv":
        return FaultPlan.random(
            seed, so_ids=["kv"], horizon=1.0, n_shards=2, allow_crash=False
        )
    if scenario == "counter":
        return FaultPlan.random(
            seed, so_ids=["prod", "cons"], horizon=0.8, n_shards=2, allow_crash=True
        )
    if scenario == "workflow":
        return FaultPlan.random(
            seed, so_ids=["kv", "wf"], horizon=0.8, n_shards=2, allow_crash=False
        )
    if scenario == "broker":
        return FaultPlan.random(
            seed, so_ids=["broker"], horizon=0.8, n_shards=2, allow_crash=False
        )
    if scenario == "two_phase_commit":
        return FaultPlan.random(
            seed,
            so_ids=["coord2pc", "p0", "p1"],
            horizon=0.8,
            n_shards=2,
            allow_crash=True,
        )
    if scenario in ("differential_kv", "differential_workflow"):
        return default_differential_plan(seed)
    if scenario in ("snapshot_recovery_kv", "snapshot_recovery_workflow"):
        return default_snapshot_plan(seed)
    if scenario == "crash_commit":
        return FaultPlan().crash(0.055, "prod")  # mid group-commit interval
    if scenario == "partition_merge":
        return FaultPlan().partition(0.03, ["coord/0", "coord/1"]).heal(0.25)
    if scenario == "dup_fragments":
        return (
            FaultPlan()
            .method_link(0.02, "report", loss_prob=0.2, dup_prob=0.6, latency_ms=1.0)
            .method_link(
                0.02, "receive_fragments", loss_prob=0.2, dup_prob=0.6, latency_ms=2.0
            )
            .restart_coordinator(0.12)
            .clear_method_link(0.6, "report")
            .clear_method_link(0.6, "receive_fragments")
        )
    raise KeyError(f"unknown scenario {scenario!r}")


def _raise_if(errors: List[str], seed: int, name: str) -> None:
    errors = [e for e in errors if e]
    if errors:
        raise InvariantViolation(
            f"[{name} seed={seed}] " + " | ".join(str(e) for e in errors)
        )


# --------------------------------------------------------------------------- #
# kv: linearizability under benign faults                                      #
# --------------------------------------------------------------------------- #
def kv_scenario(seed: int, root: Path, plan: Optional[FaultPlan] = None) -> SimResult:
    from ..services.kv_store import SpeculativeKVStore

    horizon = 1.0  # matches default_plan("kv", ...)
    if plan is None:
        plan = default_plan("kv", seed)
    rng = random.Random(seed ^ 0x5EEDFACE)
    keys = ["a", "b", "c"]
    scripts = [
        [
            (
                rng.choice(["put", "get", "get", "delete"]),
                rng.choice(keys),
                f"v{rng.randrange(50)}",
                rng.uniform(0.0, 0.04),
            )
            for _ in range(12)
        ]
        for _ in range(3)
    ]
    sim = SimCluster(
        root,
        seed=seed,
        n_shards=2,
        refresh_interval=0.005,
        group_commit_interval=0.01,
        call_timeout=20.0,
    )

    def scenario(sim: SimCluster):
        sim.add("kv", lambda: SpeculativeKVStore(sim.root / "so_kv"))

        def client(i: int) -> None:
            cli = RecordingClient(sim, "kv", f"cli{i}")
            for method, key, value, pause in scripts[i]:
                if method == "put":
                    cli.put(key, value)
                elif method == "delete":
                    cli.delete(key)
                else:
                    cli.get(key)
                sim.sleep(pause)

        tasks = [sim.spawn(partial(client, i), name=f"cli{i}") for i in range(3)]
        for t in tasks:
            t.join()
        sim.sleep(max(0.0, horizon - sim.clock.now()) + 0.05)  # outlive the plan
        sim.settle(lambda: sim.boundary() is not None, timeout=20.0)

    result = sim.run(scenario, plan=plan)
    errors: List[str] = []
    lin = check_linearizable(result.history, KVModel)
    if lin:
        errors.append(lin)
    errors += result.watermarks.check()
    errors += check_shard_logs(root / "cluster" / "coord")
    _raise_if(errors, seed, "kv")
    return result


# --------------------------------------------------------------------------- #
# counter: crash-restarts => consistent prefix                                 #
# --------------------------------------------------------------------------- #
def counter_scenario(seed: int, root: Path, plan: Optional[FaultPlan] = None) -> SimResult:
    from ..services.counter import CounterStateObject

    horizon = 0.8  # matches default_plan("counter", ...)
    if plan is None:
        plan = default_plan("counter", seed)
    sim = SimCluster(
        root,
        seed=seed,
        n_shards=2,
        refresh_interval=0.005,
        group_commit_interval=0.02,
        call_timeout=10.0,
    )
    rng = random.Random(seed ^ 0xC0FFEE)
    pauses = [rng.uniform(0.0, 0.05) for _ in range(16)]

    def scenario(sim: SimCluster):
        sim.add("prod", lambda: CounterStateObject(sim.root / "so_prod"))
        sim.add("cons", lambda: CounterStateObject(sim.root / "so_cons"))
        for pause in pauses:
            try:
                res = sim.send(None, "prod", "increment", None)
                if res is not None:
                    _, h = res
                    sim.send(None, "cons", "increment", h)
            except TimeoutError:
                pass  # crash/partition window: the chain just thins out
            sim.sleep(pause)
        sim.sleep(max(0.0, horizon - sim.clock.now()) + 0.05)
        # settle: one world, boundary served for both members
        ok = sim.settle(
            lambda: (
                sim.get("prod").runtime.world == sim.get("cons").runtime.world
                and sim.boundary() is not None
            ),
            timeout=30.0,
        )
        return {
            "converged": ok,
            "prod": sim.get("prod").value,
            "cons": sim.get("cons").value,
            "worlds": (sim.get("prod").runtime.world, sim.get("cons").runtime.world),
        }

    result = sim.run(scenario, plan=plan)
    v = result.value
    errors: List[str] = []
    if not v["converged"]:
        errors.append(f"cluster failed to converge: {v}")
    if v["cons"] > v["prod"]:
        errors.append(
            f"consistent-prefix violation: consumer {v['cons']} > producer {v['prod']}"
        )
    errors += result.watermarks.check()
    errors += check_shard_logs(root / "cluster" / "coord")
    _raise_if(errors, seed, "counter")
    return result


# --------------------------------------------------------------------------- #
# workflow: engine-driven steps over the faulty fabric                         #
# --------------------------------------------------------------------------- #
def workflow_scenario(seed: int, root: Path, plan: Optional[FaultPlan] = None) -> SimResult:
    from ..services.kv_store import SpeculativeKVStore
    from ..services.workflow import WorkflowEngine

    horizon = 0.8  # matches default_plan("workflow", ...)
    if plan is None:
        plan = default_plan("workflow", seed)
    sim = SimCluster(
        root,
        seed=seed,
        n_shards=2,
        refresh_interval=0.005,
        group_commit_interval=0.01,
        call_timeout=20.0,
    )
    n_workflows, n_steps = 3, 3

    def scenario(sim: SimCluster):
        sim.add("kv", lambda: SpeculativeKVStore(sim.root / "so_kv"))
        sim.add("wf", lambda: WorkflowEngine(sim.root / "so_wf"))
        sim.send(None, "kv", "stock", "seat", n_workflows * n_steps, None)
        wf = sim.get("wf")
        outcomes = {}

        def steps(wf_id: str):
            return [
                (lambda h, i=i: sim.send("wf", "kv", "try_reserve", "seat", f"{wf_id}:{i}", h))
                for i in range(n_steps)
            ]

        def drive(wf_id: str) -> None:
            for _ in range(50):  # driver retries on rollback/discard
                try:
                    out = wf.run_workflow(wf_id, steps(wf_id))
                except TimeoutError:
                    out = None
                if out is not None:
                    outcomes[wf_id] = out[0]
                    return
                sim.sleep(0.02)
            outcomes[wf_id] = None

        tasks = [
            sim.spawn(partial(drive, f"wf{i}"), name=f"wf-driver{i}")
            for i in range(n_workflows)
        ]
        for t in tasks:
            t.join()
        sim.sleep(max(0.0, horizon - sim.clock.now()) + 0.05)
        sim.settle(lambda: sim.boundary() is not None, timeout=20.0)
        left = sim.send(None, "kv", "get", "inv:seat", None)
        return {"outcomes": outcomes, "left": left[0] if left else None}

    result = sim.run(scenario, plan=plan)
    v = result.value
    errors: List[str] = []
    for wf_id, out in v["outcomes"].items():
        if out is None:
            errors.append(f"{wf_id} never completed")
        elif out != [True] * n_steps:
            errors.append(f"{wf_id} step results {out} != all-success")
    # exactly-once step effects: every reservation decremented inventory once
    if v["left"] != "0":
        errors.append(
            f"inventory {v['left']!r} != '0' after {n_workflows * n_steps} reserves "
            "(a retried/duplicated step double-applied, or one was lost)"
        )
    errors += result.watermarks.check()
    errors += check_shard_logs(root / "cluster" / "coord")
    _raise_if(errors, seed, "workflow")
    return result


# --------------------------------------------------------------------------- #
# pinned regression scenarios (explicit plans at nasty protocol moments)       #
# --------------------------------------------------------------------------- #
def crash_commit_scenario(seed: int, root: Path, plan: Optional[FaultPlan] = None) -> SimResult:
    """Producer crashes in the middle of a group-commit window: the consumer
    must roll back to the producer's surviving prefix, never past it, and
    the barriered durable floor must survive."""
    from ..services.counter import CounterStateObject

    if plan is None:
        plan = default_plan("crash_commit", seed)
    sim = SimCluster(
        root,
        seed=seed,
        n_shards=2,
        refresh_interval=0.002,
        group_commit_interval=0.02,
        call_timeout=10.0,
    )

    def scenario(sim: SimCluster):
        sim.add("prod", lambda: CounterStateObject(sim.root / "so_prod"))
        sim.add("cons", lambda: CounterStateObject(sim.root / "so_cons"))
        h = None
        acks = []
        for _ in range(3):  # durable prefix, barriered
            v, h = sim.send(None, "prod", "increment", None)
            acks.append(v)
            sim.send(None, "cons", "increment", h)
        sim.get("prod").runtime.maybe_persist(force=True)
        t = sim.get("cons").Detach()
        t.Barrier(timeout=20.0)
        assert sim.get("cons").Merge(t)
        sim.get("cons").EndAction()
        durable = sim.get("cons").value
        # speculative tail racing the crash at t=0.055
        deadline = sim.clock.now() + 0.2
        while sim.clock.now() < deadline:
            try:
                res = sim.send(None, "prod", "increment", None)
                if res is not None:
                    sim.send(None, "cons", "increment", res[1])
            except Exception:  # noqa: BLE001 — crash window: timeout,
                break  # CrashedError, or transport error all end the tail
            sim.sleep(0.01)
        sim.settle(
            lambda: sim.get("prod").runtime.world >= 1
            and sim.get("cons").runtime.world == sim.get("prod").runtime.world,
            timeout=30.0,
        )
        return {
            "durable": durable,
            "prod": sim.get("prod").value,
            "cons": sim.get("cons").value,
            "worlds": (sim.get("prod").runtime.world, sim.get("cons").runtime.world),
        }

    result = sim.run(scenario, plan=plan)
    v = result.value
    errors: List[str] = []
    if v["worlds"][0] < 1 or v["worlds"][0] != v["worlds"][1]:
        errors.append(f"worlds did not converge past the failure: {v['worlds']}")
    if v["cons"] > v["prod"]:
        errors.append(f"consumer {v['cons']} ahead of producer {v['prod']}")
    if v["prod"] < v["durable"] or v["cons"] < v["durable"]:
        errors.append(f"barriered durable floor {v['durable']} lost: {v}")
    errors += check_shard_logs(root / "cluster" / "coord")
    _raise_if(errors, seed, "crash_commit")
    return result


def partition_merge_scenario(seed: int, root: Path, plan: Optional[FaultPlan] = None) -> SimResult:
    """Coordinator shards partitioned away exactly while cross-shard traffic
    is creating inter-shard dependencies; after healing, the cross-shard
    boundary fixpoint must converge and stay monotone."""
    from ..services.counter import CounterStateObject

    if plan is None:
        plan = default_plan("partition_merge", seed)
    sim = SimCluster(
        root,
        seed=seed,
        n_shards=2,
        refresh_interval=0.005,
        group_commit_interval=0.01,
        call_timeout=10.0,
    )

    def scenario(sim: SimCluster):
        def pick_ids():
            # two so_ids that consistent-hash to DIFFERENT shards, so the
            # dependency chain crosses the boundary-fixpoint exchange
            ring = sim.cluster.coordinator
            first = "p0"
            home = ring.shard_index(first)
            for i in range(1, 500):
                if ring.shard_index(f"p{i}") != home:
                    return first, f"p{i}"
            raise AssertionError("ring maps everything to one shard")

        p_id, q_id = pick_ids()
        sim.add(p_id, lambda: CounterStateObject(sim.root / "so_p"))
        sim.add(q_id, lambda: CounterStateObject(sim.root / "so_q"))
        acks = []
        timeouts = 0
        for _ in range(8):  # cross-shard dependency chain spanning the cut
            try:
                v, h = sim.send(None, p_id, "increment", None)
                acks.append(v)
                sim.send(None, q_id, "increment", h)
            except TimeoutError:
                timeouts += 1  # the increment may still have applied (pending)
            sim.sleep(0.05)
        sim.settle(
            lambda: all(
                (sim.boundary() or {}).get(so, -1) >= 1 for so in (p_id, q_id)
            ),
            timeout=30.0,
        )
        return {
            "acks": acks,
            "timeouts": timeouts,
            "final": sim.get(p_id).value,
            "boundary": sim.boundary(),
            "ids": (p_id, q_id),
        }

    result = sim.run(scenario, plan=plan)
    v = result.value
    errors: List[str] = []
    b = v["boundary"] or {}
    for so in v["ids"]:
        if b.get(so, -1) < 1:
            errors.append(f"boundary never converged for {so}: {b}")
    if v["timeouts"] == 0:
        # no pending ops: the producer's real final value must equal the
        # ack count — a retried/duplicated increment that double-applied
        # without a duplicate ack shows up here, not in the ack list
        eo = check_exactly_once_counter(v["acks"], v["final"])
        if eo:
            errors.append(eo)
    errors += result.watermarks.check()
    errors += check_shard_logs(root / "cluster" / "coord")
    _raise_if(errors, seed, "partition_merge")
    return result


def dup_fragments_scenario(seed: int, root: Path, plan: Optional[FaultPlan] = None) -> SimResult:
    """Coordinator restarts while the fabric duplicates + drops fragment
    resends and reports: recovery must converge to a view at least as fresh
    as pre-failure, with no duplicated decisions in any shard log."""
    from ..services.counter import CounterStateObject

    if plan is None:
        plan = default_plan("dup_fragments", seed)
    sim = SimCluster(
        root,
        seed=seed,
        n_shards=2,
        refresh_interval=0.005,
        group_commit_interval=0.01,
        call_timeout=10.0,
    )

    def scenario(sim: SimCluster):
        sim.add("a", lambda: CounterStateObject(sim.root / "so_a"))
        sim.add("b", lambda: CounterStateObject(sim.root / "so_b"))
        acks = []
        h = None
        for _ in range(6):
            v, h = sim.send(None, "a", "increment", h)
            acks.append(v)
            sim.send(None, "b", "increment", h)
            sim.sleep(0.02)
        sim.settle(lambda: (sim.boundary() or {}).get("a", -1) >= 1, timeout=20.0)
        before = dict(sim.boundary() or {})
        sim.sleep(0.2)  # ride through the restart at t=0.12
        sim.settle(lambda: sim.boundary() is not None, timeout=30.0)
        after = dict(sim.boundary() or {})
        # keep serving in the recovered view
        v, h = sim.send(None, "a", "increment", h)
        acks.append(v)
        return {
            "before": before,
            "after": after,
            "acks": acks,
            "final": sim.get("a").value,
        }

    result = sim.run(scenario, plan=plan)
    v = result.value
    errors: List[str] = []
    for so, wm in v["before"].items():
        if v["after"].get(so, -1) < wm:
            errors.append(
                f"recovered boundary[{so}]={v['after'].get(so, -1)} < pre-failure {wm}"
            )
    # real final value, not len(acks): catches a duplicated fragment/report
    # double-applying an increment whose ack list still looks clean
    eo = check_exactly_once_counter(v["acks"], v["final"])
    if eo:
        errors.append(eo)
    errors += check_shard_logs(root / "cluster" / "coord")
    _raise_if(errors, seed, "dup_fragments")
    return result


# --------------------------------------------------------------------------- #
# broker: produce -> consume -> ack, exactly-once in order                      #
# --------------------------------------------------------------------------- #
def broker_scenario(seed: int, root: Path, plan: Optional[FaultPlan] = None) -> SimResult:
    """DARQ-style pipeline over the speculative event broker under benign
    fabric faults (loss / dup / delay / partitions / shard restarts): every
    produced event is consumed exactly once, in order, and the ack offset
    only advances past consumed prefixes."""
    from ..services.broker import EventBroker

    horizon = 0.8  # matches default_plan("broker", ...)
    if plan is None:
        plan = default_plan("broker", seed)
    sim = SimCluster(
        root,
        seed=seed,
        n_shards=2,
        refresh_interval=0.005,
        group_commit_interval=0.01,
        call_timeout=20.0,
    )
    rng = random.Random(seed ^ 0xB40CE4)
    n_events = 12
    pauses = [rng.uniform(0.0, 0.05) for _ in range(n_events)]

    def scenario(sim: SimCluster):
        sim.add("broker", lambda: EventBroker(sim.root / "so_broker", topics=["t"]))
        # offset -> data: the broker redelivers unacked events by contract
        # (at-least-once consume + ack-advances-offset), so the consumer is
        # idempotent by offset — conflicting data for one offset is the bug.
        consumed: Dict[int, bytes] = {}
        conflicts: List[str] = []

        def producer() -> None:
            for i, pause in enumerate(pauses):
                try:
                    sim.send(None, "broker", "produce", "t", [f"e{i}".encode()], None)
                except TimeoutError:
                    pass  # unreachable in practice: call_timeout outlives
                    # every partition window and the fabric retries
                sim.sleep(pause)

        def consumer() -> None:
            deadline = sim.clock.now() + 30.0
            while len(consumed) < n_events and sim.clock.now() < deadline:
                try:
                    out = sim.send(None, "broker", "consume", "g", "t", 4, None)
                    if out is not None:
                        events, h = out
                        for off, data in events:
                            if consumed.setdefault(off, data) != data:
                                conflicts.append(f"offset {off} redelivered different data")
                        if events:
                            sim.send(None, "broker", "ack", "g", "t", events[-1][0], h)
                except TimeoutError:
                    pass
                sim.sleep(0.02)

        tasks = [
            sim.spawn(producer, name="producer"),
            sim.spawn(consumer, name="consumer"),
        ]
        for t in tasks:
            t.join()
        sim.sleep(max(0.0, horizon - sim.clock.now()) + 0.05)
        sim.settle(lambda: sim.boundary() is not None, timeout=20.0)
        broker = sim.get("broker")
        return {
            "consumed": [consumed[k] for k in sorted(consumed)],
            "conflicts": conflicts,
            "tail": broker.topic_tail("t"),
            "skipped": broker.entries_skipped(),
        }

    result = sim.run(scenario, plan=plan)
    v = result.value
    errors: List[str] = list(v["conflicts"])
    expected = [f"e{i}".encode() for i in range(n_events)]
    if v["consumed"] != expected:
        errors.append(
            f"exactly-once in-order consumption violated: got {v['consumed']!r}"
        )
    if v["tail"] != n_events:
        errors.append(f"topic tail {v['tail']} != {n_events} produced (dup/lost produce)")
    errors += result.watermarks.check()
    errors += check_shard_logs(root / "cluster" / "coord")
    _raise_if(errors, seed, "broker")
    return result


# --------------------------------------------------------------------------- #
# two_phase_commit: atomic commit under crashes + partitions                    #
# --------------------------------------------------------------------------- #
def two_phase_commit_scenario(
    seed: int, root: Path, plan: Optional[FaultPlan] = None
) -> SimResult:
    """Transactional client over speculative 2PC while participants crash
    and the fabric partitions: every client-acked commit must be durable in
    every participant's log after recovery, and no transaction may commit
    in one participant and abort in another."""
    from ..services.two_phase_commit import TwoPCClient, TwoPCCoordinator, TwoPCParticipant

    horizon = 0.8  # matches default_plan("two_phase_commit", ...)
    if plan is None:
        plan = default_plan("two_phase_commit", seed)
    sim = SimCluster(
        root,
        seed=seed,
        n_shards=2,
        refresh_interval=0.005,
        group_commit_interval=0.01,
        call_timeout=20.0,
    )
    rng = random.Random(seed ^ 0x2FC0)
    n_txns = 5
    pauses = [rng.uniform(0.0, 0.06) for _ in range(n_txns)]

    def scenario(sim: SimCluster):
        from ..core.runtime import CrashedError

        sim.add("coord2pc", lambda: TwoPCCoordinator(sim.root / "so_c2pc"))
        for i in range(2):
            sim.add(f"p{i}", (lambda i=i: TwoPCParticipant(sim.root / f"so_p{i}")))
        from ..core.sthread import RolledBackError

        acked: List[str] = []
        for i, pause in enumerate(pauses):
            # fresh txn id per ATTEMPT: a retry after a rollback mid-protocol
            # must not reuse an id that may already carry a (lost-then-
            # durable) decide record — real clients retry with new ids too.
            for attempt in range(60):
                txn = f"t{i}a{attempt}"
                try:
                    # re-fetch every attempt — crash faults replace incarnations
                    client = TwoPCClient(
                        sim.get("coord2pc"), [sim.get("p0"), sim.get("p1")]
                    )
                    out = client.run(txn)
                except (TimeoutError, CrashedError, RolledBackError):
                    out = None
                if out:  # acked commit; False (abort) retries with a new id
                    acked.append(txn)
                    break
                sim.sleep(0.02)
            sim.sleep(pause)
        sim.sleep(max(0.0, horizon - sim.clock.now()) + 0.05)
        sim.settle(
            lambda: sim.boundary() is not None
            and len(
                {sim.get(s).runtime.world for s in ("coord2pc", "p0", "p1")}
            )
            == 1,
            timeout=30.0,
        )
        logs = {}
        for s in ("p0", "p1"):
            entries = [e.decode() for _, e in sim.get(s).core.scan(0)]
            logs[s] = entries
        return {"acked": acked, "logs": logs}

    result = sim.run(scenario, plan=plan)
    v = result.value
    errors: List[str] = []
    for s, entries in v["logs"].items():
        decided = {}
        for e in entries:
            parts = e.split(":")
            if parts[0] == "decide":
                txn, verdict = parts[1], parts[2]
                if decided.get(txn, verdict) != verdict:
                    errors.append(f"{s}: {txn} both committed and aborted: {entries}")
                decided[txn] = verdict
        for txn in v["acked"]:
            if decided.get(txn) != "c":
                errors.append(
                    f"client-acked commit {txn} not durable in {s} (decided={decided})"
                )
    # atomicity across participants: no txn decided differently in p0 vs p1
    def _decisions_of(entries):
        return {
            e.split(":")[1]: e.split(":")[2] for e in entries if e.startswith("decide:")
        }

    d0, d1 = _decisions_of(v["logs"]["p0"]), _decisions_of(v["logs"]["p1"])
    for txn in set(d0) & set(d1):
        if d0[txn] != d1[txn]:
            errors.append(f"atomicity violated for {txn}: p0={d0[txn]} p1={d1[txn]}")
    errors += result.watermarks.check()
    errors += check_shard_logs(root / "cluster" / "coord")
    _raise_if(errors, seed, "two_phase_commit")
    return result


SCENARIOS: Dict[str, Scenario] = {
    "kv": kv_scenario,
    "counter": counter_scenario,
    "workflow": workflow_scenario,
    "crash_commit": crash_commit_scenario,
    "partition_merge": partition_merge_scenario,
    "dup_fragments": dup_fragments_scenario,
    "broker": broker_scenario,
    "two_phase_commit": two_phase_commit_scenario,
    "differential_kv": differential_kv_scenario,
    "differential_workflow": differential_workflow_scenario,
    "snapshot_recovery_kv": snapshot_recovery_kv_scenario,
    "snapshot_recovery_workflow": snapshot_recovery_workflow_scenario,
}


# --------------------------------------------------------------------------- #
# sweep + shrink                                                               #
# --------------------------------------------------------------------------- #
def run_one(scenario: str, seed: int, workdir: Path, plan: Optional[FaultPlan] = None) -> SimResult:
    fn = SCENARIOS[scenario]
    Path(workdir).mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix=f"{scenario}-{seed}-", dir=workdir))
    try:
        return fn(seed, root, plan)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def shrink(
    scenario: str,
    seed: int,
    plan: FaultPlan,
    workdir: Path,
    max_runs: int = 60,
    match_error: Optional[str] = None,
    deadline: Optional[float] = None,
) -> FaultPlan:
    """ddmin over fault events: repeatedly delete chunks while the scenario
    still fails. Client op scripts stay pinned to the seed, so only the
    fault schedule shrinks. ``match_error`` (an exception class name) keeps
    the shrink honest: a candidate only counts as failing if it fails the
    same WAY — otherwise deleting a load-bearing fault can swap one failure
    for a different one and the "minimal" plan reproduces the wrong bug.
    ``deadline`` (``time.time()`` epoch) stops shrinking when the caller's
    wall budget runs out — the current best (possibly unshrunk) plan is
    still a valid repro, and writing SOME artifact beats being killed by
    the CI job timeout mid-shrink with none."""
    runs = 0

    def fails(p: FaultPlan) -> bool:
        nonlocal runs
        if runs >= max_runs:
            return False
        if deadline is not None and time.time() >= deadline:
            return False
        runs += 1
        try:
            run_one(scenario, seed, workdir, plan=p)
            return False
        except Exception as e:  # noqa: BLE001 — compared, not swallowed
            return match_error is None or type(e).__name__ == match_error

    current = plan
    chunk = max(1, len(current.sorted_events()) // 2)
    while chunk >= 1:
        i = 0
        while i < len(current.sorted_events()):
            cand = current.without(range(i, i + chunk))
            if cand.events != current.events and fails(cand):
                current = cand
            else:
                i += chunk
        if chunk == 1:
            break
        chunk = max(1, chunk // 2)
    return current


def sweep(
    scenarios: List[str],
    n_seeds: int,
    *,
    start_seed: int = 0,
    budget_s: float = 600.0,
    out: Optional[Path] = None,
    workdir: Optional[Path] = None,
) -> int:
    """Run ``n_seeds`` of each scenario inside a wall-clock budget; on the
    first failure, shrink its plan and write the repro artifact. Returns the
    process exit code."""
    workdir = Path(workdir or tempfile.mkdtemp(prefix="sim-sweep-"))
    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    ran = 0
    for scenario in scenarios:
        for seed in range(start_seed, start_seed + n_seeds):
            if time.time() - t0 > budget_s:
                print(
                    f"budget {budget_s}s exhausted after {ran} runs "
                    f"({ran / max(time.time() - t0, 1e-9):.1f} seeds/s)",
                    flush=True,
                )
                return 0
            try:
                result = run_one(scenario, seed, workdir)
                ran += 1
                if seed % 10 == 0:
                    print(
                        f"[{scenario}] seed={seed} ok "
                        f"({result.events} events, {result.virtual_time:.2f} vs)",
                        flush=True,
                    )
            except Exception as e:  # noqa: BLE001 — every failure is a repro
                print(f"[{scenario}] seed={seed} FAILED: {e}", flush=True)
                shrunk = shrink(
                    scenario,
                    seed,
                    default_plan(scenario, seed),
                    workdir,
                    match_error=type(e).__name__,
                    deadline=t0 + budget_s,  # shrink inside the same budget
                )
                artifact = {
                    "scenario": scenario,
                    "seed": seed,
                    "error": repr(e),
                    "plan": shrunk.to_json(),
                    "hint": (
                        "repro: python -m repro_torch.sim.explore "
                        f"--scenario {scenario} --seeds 1 --start-seed {seed}; "
                        "pin it in tests/scenarios/regression_seeds.json"
                    ),
                }
                if out is not None:
                    out.parent.mkdir(parents=True, exist_ok=True)
                    out.write_text(json.dumps(artifact, indent=2))
                    print(f"shrunk fault plan written to {out}", flush=True)
                else:
                    print(json.dumps(artifact, indent=2), flush=True)
                return 1
    dt = max(time.time() - t0, 1e-9)
    print(f"{ran} runs green in {dt:.1f}s ({ran / dt:.1f} seeds/s)", flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--scenario",
        action="append",
        choices=sorted(SCENARIOS),
        help="scenario name (repeatable); default: kv",
    )
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--start-seed", type=int, default=0)
    ap.add_argument("--budget", type=float, default=600.0, help="wall-clock seconds")
    ap.add_argument("--out", type=Path, default=None, help="failure artifact path")
    ap.add_argument("--workdir", type=Path, default=None)
    args = ap.parse_args(argv)
    return sweep(
        args.scenario or ["kv"],
        args.seeds,
        start_seed=args.start_seed,
        budget_s=args.budget,
        out=args.out,
        workdir=args.workdir,
    )


if __name__ == "__main__":
    sys.exit(main())
