"""Differential oracle: one seeded op history + fault plan, replayed against
both runtimes — DurableRuntime (synchronous baseline) and DSERuntime
(speculative) — asserting op-for-op equivalence of committed results.

A runtime that persists synchronously before every externally-visible
effect is trivially correct (nothing speculative ever escapes), so the
durable run is the oracle: any divergence in *committed* observations is a
bug in speculation/rollback — the correctness argument Beldi (arXiv:
2010.06706) makes for its synchronous reference, applied to the whole DSE
stack under deterministic simulation.

What equivalence covers (and what it doesn't — DESIGN.md §10): committed
observations are compared — per-workflow recorded step results (exposed
only behind the final barrier) and the post-settle durable service state.
Transient speculative acks that the protocol later discards are *supposed*
to differ between runs and are not compared; timing, persists-per-op, and
wire traffic obviously differ (that gap is the paper's Figure 9, measured
by ``benchmarks/bench_eval.py``).

Workloads are workflow-shaped on purpose: a bare client's acked-but-
unbarriered suffix may legitimately vanish under DSE, so the driver records
its own progress in a StateObject that rolls back *with* its effects
(``WorkflowEngine``), exactly the durable-execution programming model both
runtimes claim to serve. Steps are idempotent (put/delete/get and
owner-keyed ``try_reserve``) — the standard activity contract that makes
retry-after-lost-reply single-effect in the durable baseline too.

Scenarios are registered first-class in ``repro.sim.explore``::

    python -m repro.sim.explore --scenario differential_kv --seeds 50
"""
from __future__ import annotations

import random
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core.runtime import CrashedError
from ..core.sthread import RolledBackError
from .cluster import SimCluster, SimResult
from .faults import FaultPlan
from .invariants import InvariantViolation, check_shard_logs

#: driver retry budget: a workflow is re-driven after every rollback /
#: crash / timeout until it completes (the fault plan's healing epilogue
#: guarantees eventual success on a correct stack).
MAX_DRIVES = 200


def default_differential_plan(seed: int, horizon: float = 0.8) -> FaultPlan:
    """Crash + partition schedule over both participants (the acceptance
    bar: zero divergences under crash+partition fault plans)."""
    return FaultPlan.random(
        seed,
        so_ids=["kv", "wf"],
        horizon=horizon,
        n_shards=2,
        allow_crash=True,
    )


# --------------------------------------------------------------------------- #
# workloads                                                                   #
# --------------------------------------------------------------------------- #
def _kv_scripts(
    seed: int, n_drivers: int = 2, n_workflows: int = 5, n_ops: int = 4
) -> List[List[dict]]:
    """Per-driver workflow scripts over DISJOINT key sets: each driver's get
    results are then a pure function of its own prior ops, so committed
    results must match across runtimes op-for-op regardless of cross-driver
    scheduling differences.

    Many SMALL workflows with pauses in between, not one big one: workflows
    then *complete* (expose results) continuously across the fault horizon,
    so crash faults land inside the window right after an exposure — the
    window where an exposure-before-durability bug (e.g. a broken barrier)
    is distinguishable from the durable oracle at all. One long workflow
    finishing before the first fault would leave speculation unobserved.
    """
    rng = random.Random(seed ^ 0xD1FFE12)
    scripts: List[List[dict]] = []
    for d in range(n_drivers):
        keys = [f"k{d}{j}" for j in range(3)]
        wfs = []
        for _ in range(n_workflows):
            ops = []
            for _ in range(n_ops):
                kind = rng.choice(["put", "put", "get", "delete"])
                ops.append((kind, rng.choice(keys), f"v{rng.randrange(30)}"))
            wfs.append({"ops": ops, "pause": rng.uniform(0.02, 0.1)})
        scripts.append(wfs)
    return scripts


def _run_side(
    workload: str,
    seed: int,
    root: Path,
    plan: FaultPlan,
    runtime: str,
    horizon: float = 0.8,
    sim_kw: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    from ..services.kv_store import SpeculativeKVStore
    from ..services.workflow import WorkflowEngine

    sim = SimCluster(
        root,
        seed=seed,
        n_shards=2,
        runtime=runtime,
        refresh_interval=0.005,
        group_commit_interval=0.01,
        call_timeout=20.0,
        **(sim_kw or {}),
    )
    scripts = _kv_scripts(seed) if workload == "kv" else None
    # workflow workload shape: several small staggered workflows (see
    # _kv_scripts docstring for why many-small beats one-big)
    n_workflows, n_steps = 6, 2

    def scenario(sim: SimCluster):
        sim.add("kv", lambda: SpeculativeKVStore(sim.root / "so_kv"))
        sim.add("wf", lambda: WorkflowEngine(sim.root / "so_wf"))
        obs: Dict[str, Any] = {"runtime": runtime, "outcomes": {}}

        if workload == "workflow":
            # seed inventory and make it durable before faults can bite:
            # the stock op itself is part of neither run's compared history
            for _ in range(MAX_DRIVES):
                try:
                    if sim.send(None, "kv", "stock", "seat", n_workflows * n_steps, None) is None:
                        continue
                    kv = sim.get("kv")
                    if kv.StartAction(None) and kv.wait_durable(timeout=10.0):
                        kv.EndAction()
                        break
                except (TimeoutError, CrashedError, RolledBackError):
                    pass
                sim.sleep(0.01)

        def kv_steps(d: int, w: int):
            steps = []
            for kind, key, value in scripts[d][w]["ops"]:
                if kind == "put":
                    args = ("put", key, value)
                elif kind == "delete":
                    args = ("delete", key)
                else:
                    args = ("get", key)

                def step(h, args=args):
                    out = sim.send("wf", "kv", *args, h)
                    if out is None:
                        return None
                    if args[0] == "get":
                        return out  # (value, header)
                    return ("ok", out)  # put/delete return just the header

                steps.append(step)
            return steps

        def reserve_steps(wf_id: str):
            return [
                (
                    lambda h, i=i: sim.send(
                        "wf", "kv", "try_reserve", "seat", f"{wf_id}:{i}", h
                    )
                )
                for i in range(n_steps)
            ]

        def drive(wf_id: str, steps_for) -> None:
            for _ in range(MAX_DRIVES):
                try:
                    # re-fetch each attempt: a crash fault replaces the engine
                    out = sim.get("wf").run_workflow(wf_id, steps_for())
                except (TimeoutError, CrashedError, RolledBackError):
                    out = None
                if out is not None:
                    obs["outcomes"][wf_id] = out[0]
                    return
                sim.sleep(0.02)
            obs["outcomes"][wf_id] = None  # liveness failure — flagged below

        if workload == "kv":

            def kv_driver(d: int) -> None:
                # sequential small workflows with pauses: exposures spread
                # across the whole fault horizon
                for w, wf in enumerate(scripts[d]):
                    drive(f"d{d}w{w}", lambda d=d, w=w: kv_steps(d, w))
                    sim.sleep(wf["pause"])

            tasks = [
                sim.spawn((lambda d=d: kv_driver(d)), name=f"diff-driver{d}")
                for d in range(len(scripts))
            ]
        else:

            def reserve_driver(i: int) -> None:
                sim.sleep(0.02 + i * 0.09)  # staggered completions
                drive(f"wf{i}", lambda i=i: reserve_steps(f"wf{i}"))

            tasks = [
                sim.spawn((lambda i=i: reserve_driver(i)), name=f"diff-driver{i}")
                for i in range(n_workflows)
            ]
        for t in tasks:
            t.join()

        # outlive the fault plan, then settle to a converged, served boundary
        sim.sleep(max(0.0, horizon - sim.clock.now()) + 0.05)
        sim.settle(
            lambda: sim.boundary() is not None
            and sim.get("kv").runtime.world == sim.get("wf").runtime.world,
            timeout=30.0,
        )

        # committed final state (post-settle, clean fabric: plain reads)
        final: Dict[str, Optional[str]] = {}
        if workload == "kv":
            keys = sorted(
                {op[1] for script in scripts for wf in script for op in wf["ops"]}
            )
        else:
            keys = ["inv:seat"] + [
                f"res:seat:wf{i}:{s}" for i in range(n_workflows) for s in range(n_steps)
            ]
        for k in keys:
            out = sim.send(None, "kv", "get", k, None)
            final[k] = out[0] if out is not None else "<discarded>"
        obs["final"] = final
        obs["wf_state"] = {
            wf_id: (sim.get("wf").workflow_state(wf_id) or {}).get("status")
            for wf_id in obs["outcomes"]
        }
        # durable-store generations (vacuity witness for the snapshot
        # differential: the compact side must actually have compacted)
        stats = sim.cluster.coordinator.stats()
        obs["store_generations"] = sum(
            dict(stats.get("log_generations", {})).values()
        ) or int(stats.get("log_generation", 0))
        return obs

    result = sim.run(scenario, plan=plan)
    errors = list(result.watermarks.check()) if result.watermarks else []
    errors += check_shard_logs(root / "cluster" / "coord")
    if errors:
        raise InvariantViolation(f"[differential/{runtime} seed={seed}] " + " | ".join(errors))
    obs = result.value
    obs["_result"] = result
    return obs


# --------------------------------------------------------------------------- #
# the oracle: replay on both runtimes, diff committed observations            #
# --------------------------------------------------------------------------- #
def _diff_observations(
    oracle: Dict[str, Any], subject: Dict[str, Any], a: str, b: str
) -> List[str]:
    """Divergences between two sides' committed observations (workflow
    outcomes, final durable state, workflow statuses); ``a``/``b`` label the
    oracle and subject sides in the messages."""
    divergences: List[str] = []
    for wf_id in sorted(set(oracle["outcomes"]) | set(subject["outcomes"])):
        o, s = oracle["outcomes"].get(wf_id), subject["outcomes"].get(wf_id)
        if o is None or s is None:
            divergences.append(
                f"{wf_id} never completed ({a}={o is not None}, {b}={s is not None})"
            )
        elif o != s:
            divergences.append(f"{wf_id} committed results diverge: {a}={o} {b}={s}")
    if oracle["final"] != subject["final"]:
        diff = {
            k: (oracle["final"].get(k), subject["final"].get(k))
            for k in sorted(set(oracle["final"]) | set(subject["final"]))
            if oracle["final"].get(k) != subject["final"].get(k)
        }
        divergences.append(f"final committed state diverges ({a}, {b}): {diff}")
    if oracle["wf_state"] != subject["wf_state"]:
        divergences.append(
            f"workflow statuses diverge: {a}={oracle['wf_state']} {b}={subject['wf_state']}"
        )
    return divergences


def run_differential(
    workload: str, seed: int, root: Path, plan: Optional[FaultPlan] = None
) -> SimResult:
    if plan is None:
        plan = default_differential_plan(seed)
    sides = {
        rt: _run_side(workload, seed, Path(root) / rt, plan, rt)
        for rt in ("durable", "dse")
    }
    oracle, subject = sides["durable"], sides["dse"]
    divergences = _diff_observations(oracle, subject, "durable", "dse")
    if divergences:
        raise InvariantViolation(
            f"[differential_{workload} seed={seed}] DSE diverges from the durable "
            "oracle: " + " | ".join(divergences)
        )

    result: SimResult = subject.pop("_result")
    oracle.pop("_result", None)
    result.value = {"durable": oracle, "dse": subject}
    return result


def differential_kv_scenario(
    seed: int, root: Path, plan: Optional[FaultPlan] = None
) -> SimResult:
    """Sequential put/get/delete scripts (disjoint keys per driver) through
    the workflow engine, on both runtimes, under crash+partition faults."""
    return run_differential("kv", seed, root, plan)


def differential_workflow_scenario(
    seed: int, root: Path, plan: Optional[FaultPlan] = None
) -> SimResult:
    """The TravelReservations-style try_reserve workload on both runtimes:
    outcomes, inventory, and reservation markers must match exactly."""
    return run_differential("workflow", seed, root, plan)


# --------------------------------------------------------------------------- #
# snapshot-vs-replay: compaction must be observationally invisible            #
# --------------------------------------------------------------------------- #
def default_snapshot_plan(seed: int, horizon: float = 0.9) -> FaultPlan:
    """Long-horizon crash/restart schedule with compaction points pinned
    between them: every seed exercises checkpoint → shard restart →
    recovery-from-snapshot+suffix at least twice, on top of the random
    crash/partition schedule."""
    plan = FaultPlan.random(
        seed,
        so_ids=["kv", "wf"],
        horizon=horizon,
        n_shards=2,
        allow_crash=True,
    )
    for at in (0.12, 0.3, 0.48, 0.66):
        plan.checkpoint(at)
    plan.restart_shard(0.2, seed % 2)
    plan.restart_shard(0.55, (seed + 1) % 2)
    # full coordinator-service restarts: the DecisionBus survives single
    # shard restarts and would mask a broken snapshot (state re-seeded from
    # the bus); only a full restart rebuilds everything from the durable
    # stores — the path the snapshot actually carries.
    plan.restart_coordinator(0.4)
    plan.restart_coordinator(0.72)
    return plan


def run_store_differential(
    workload: str, seed: int, root: Path, plan: Optional[FaultPlan] = None
) -> SimResult:
    """Replay one seeded history + fault plan on two identically-seeded DSE
    clusters: one with snapshot compaction armed (tight auto threshold +
    the plan's explicit checkpoint events, so shard restarts recover from
    snapshot + log suffix), one with compaction disabled (restarts replay
    the full log — the seed-era recovery path). Committed observations must
    match op-for-op: a compaction bug is precisely the kind of silent
    divergence this oracle exists to catch (DESIGN.md §11). Scheduling
    differs between the sides (checkpoints perturb the interleaving), which
    is exactly why the drivers' committed results are scheduling-invariant
    by construction — same argument as the runtime differential above."""
    if plan is None:
        plan = default_snapshot_plan(seed)
    sides = {
        mode: _run_side(workload, seed, Path(root) / mode, plan, "dse", sim_kw=kw)
        for mode, kw in (
            ("replay", {"checkpoint_records": None}),
            ("compact", {"checkpoint_records": 6}),
        )
    }
    oracle, subject = sides["replay"], sides["compact"]
    divergences = _diff_observations(oracle, subject, "replay", "compact")
    if divergences:
        raise InvariantViolation(
            f"[snapshot_recovery_{workload} seed={seed}] recovery from "
            "snapshot+suffix diverges from full replay: " + " | ".join(divergences)
        )
    if not subject.get("store_generations", 0):
        raise InvariantViolation(
            f"[snapshot_recovery_{workload} seed={seed}] the compact side "
            "never checkpointed — the differential ran vacuously"
        )

    result: SimResult = subject.pop("_result")
    oracle.pop("_result", None)
    result.value = {"replay": oracle, "compact": subject}
    return result


def snapshot_recovery_kv_scenario(
    seed: int, root: Path, plan: Optional[FaultPlan] = None
) -> SimResult:
    """Disjoint-key workflow scripts over kv under crashes + shard restarts:
    committed results with compaction must equal the full-replay run's."""
    return run_store_differential("kv", seed, root, plan)


def snapshot_recovery_workflow_scenario(
    seed: int, root: Path, plan: Optional[FaultPlan] = None
) -> SimResult:
    """try_reserve workload: compaction must not change outcomes, inventory,
    or reservation markers relative to full-replay recovery."""
    return run_store_differential("workflow", seed, root, plan)
