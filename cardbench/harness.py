"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to a configuration, a traffic mix or a metric is
data found by name: ``configs/<config>.json`` (the file ``BENCHMARK.json``
names), ``traffic/<traffic>.json``, ``metrics/<metric>.py``; the model
family picks ``reference/<family>.py`` and ``flops/<family>.py``. A
configuration's ``model`` object holds the system's ModelConfig fields, its
sub-configs (``moe``, ``mla``, ``ssm``) as objects, and the step options
(``Tuning``'s fields), under which the program runs its whole run.

Set-up builds a ``LocalCluster`` with the system's data, trainer and
metrics StateObjects (data -> trainer -> metrics). The trainer starts from
the benchmark's seeded weights, runs the system's train step
(``launch.steps.make_train_step``) and persists at the traffic's cadence;
adding it makes the system's synchronous version-0 persist. The first
``warmup_steps`` steps go through the driver (``driver.py``) as the window's
do; the program's readings of them (losses, the first gradient, the change
of the parameters) are taken as they pass. The window then runs the
driver for ``--seconds`` and ends when the first step after that returns;
the traffic's kills fall after its given step. After the window the
program's state is freed, the reference follows the same first steps, and
``check.py`` compares.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import typing
from pathlib import Path
from typing import Callable, List, Optional

import torch

from . import check, trace, weights
from .driver import Driver
from .reference import common
from .tokens import TokenStream

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the run must not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict                 # configs/<name>.json
    traffic: dict                # traffic/<name>.json
    chips: int
    end_to_end: List[dict]       # BENCHMARK.json's metric entries this cell reports
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    [c] = [c for c in bench["configs"] if c["name"] == w["config"]]
    return Cell(
        name=name,
        config=json.loads((root / c["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_reader(metric: str) -> Callable:
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Host spans (name, start, end) in perf_counter ns."""

    def __init__(self) -> None:
        self.items: List[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter_ns()))

    def within(self, name: str, t0: int, t1: int) -> List[float]:
        """Durations in seconds of the ``name`` spans that start in [t0, t1)."""
        return [(b - a) / 1e9 for n, a, b in self.items if n == name and t0 <= a < t1]


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py::read(run)``)."""
    spans: Spans
    setup_s: float
    window_t0: int               # perf_counter ns
    window_t1: int
    net_steps: int               # trainer step at the window's end less at its start
    tokens_per_step: int
    flops_per_step: int
    peaks: dict                  # peaks.json's entry for the card
    trace: Optional[dict]        # trace.reduce's result in a traced run

    @property
    def window_s(self) -> float:
        return (self.window_t1 - self.window_t0) / 1e9

    def window_spans(self, name: str) -> List[float]:
        return self.spans.within(name, self.window_t0, self.window_t1)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms and TF32 off for the run, restored after."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]


def program_model(config: dict):
    """The system's ModelConfig for a configuration file, and the step
    options the file sets. ``model`` holds ModelConfig's fields: a
    sub-object becomes the dataclass its field names (``moe``, ``mla``,
    ``ssm``), a list a tuple where the field is one. Its keys that are
    fields of ``repro_torch.models.tuning.Tuning`` are step options, which
    the ModelConfig, a verbatim copy of the JAX package's, cannot hold: the
    program runs under ``tuning(**options)``, the reference never. Any other
    key, at either depth, raises ``KeyError`` naming it."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.tuning import Tuning

    hints = typing.get_type_hints(ModelConfig)
    options = {f.name for f in dataclasses.fields(Tuning)}
    fields, opts = {}, {}
    for key, value in config["model"].items():
        if key in options:
            opts[key] = value
        elif key not in hints or key == "name":
            raise KeyError(f"{config['name']}: model key {key!r} is neither a field of the "
                           f"system's ModelConfig nor a step option")
        elif isinstance(value, dict):
            [sub] = [t for t in typing.get_args(hints[key]) if dataclasses.is_dataclass(t)]
            unknown = sorted(set(value) - {f.name for f in dataclasses.fields(sub)})
            if unknown:
                raise KeyError(f"{config['name']}: model key {key}.{unknown[0]!r} is not a "
                               f"field of the system's {sub.__name__}")
            fields[key] = sub(**value)
        elif isinstance(value, list) and typing.get_origin(hints[key]) is tuple:
            fields[key] = tuple(value)
        else:
            fields[key] = value
    return ModelConfig(name=config["name"], **fields), opts


def program_step(cfg, traffic: dict):
    """The system's train step (``launch.steps.make_train_step``) for a
    ModelConfig under a traffic mix. It reads the step options when it runs,
    so a caller runs it under ``tuning(**options)`` (``program_model``)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig

    return make_train_step(cfg, AdamWConfig(**traffic["optimizer"]), remat=traffic["remat"])


def family(config: dict):
    return importlib.import_module(f"{__package__}.reference.{config['model']['family']}")


def check_layout(cfg, descs: dict) -> None:
    """The program's parameter tree has the reference's paths and shapes."""
    from repro_torch.models import param_descs

    have = [(p, tuple(d.shape)) for p, d in common.flatten(param_descs(cfg))]
    want = [(p, d[0]) for p, d in common.flatten(descs)]
    if have != want:
        diff = sorted(set(have) ^ set(want))[:6]
        raise RuntimeError(f"the program's parameter layout is not the reference's: {diff}")


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def reference_readings(config: dict, seed: int, batches: List, device, steps: int,
                       opt: dict) -> dict:
    """The reference's readings of the first ``steps`` steps from the seed's
    weights over ``batches`` (token arrays)."""
    m = config["model"]
    fam = family(config)
    descs = fam.descs(m)
    paths, p0 = weights.flat(descs, seed, device)
    state = common.adamw_init(p0)
    leaves, losses, grad = p0, [], None
    for i in range(steps):
        tok = torch.as_tensor(batches[i], device=device)
        leaves, state, loss = common.train_step(fam.forward, m, paths, leaves, state, tok, opt)
        losses.append(float(loss))
        if i == 0:
            grad = check.grad_norms(descs, common.unflatten(paths, state["m"]), opt["b1"])
    update = check.change_norms(descs, common.unflatten(paths, leaves), zip(paths, p0))
    return {"loss": losses, "grad": grad, "update": update}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *, device="cuda",
             t_process: Optional[float] = None, wrap_step: Optional[Callable] = None,
             wrap_tokens: Optional[Callable] = None) -> dict:
    """One run; returns the result (the line the run prints, as a dict).
    ``wrap_step`` and ``wrap_tokens`` break the timed path underneath, for
    the tests that show the check failing; a run never passes them."""
    t_process = time.perf_counter() if t_process is None else t_process
    with deterministic():
        return _run(cell, seed, seconds, traced, torch.device(device), t_process,
                    wrap_step, wrap_tokens)


def _run(cell, seed, seconds, traced, dev, t_process, wrap_step, wrap_tokens):
    t_enter = time.perf_counter()
    from repro_torch.checkpoint import MetricsStateObject, TrainerStateObject
    from repro_torch.core import DelayMessage, LocalCluster, RolledBackError
    from repro_torch.data import DataPipelineStateObject
    from repro_torch.models.tuning import tuning
    from repro_torch.optim import adamw_init

    config, traffic = cell.config, cell.traffic
    m = config["model"]
    descs = family(config).descs(m)
    # the step options hold from here to the program's last reading; the
    # reference, after them, runs without
    cfg, options = program_model(config)
    with tuning(**options):
        check_layout(cfg, descs)
        batch, seq = int(config["train_global_batch"]), int(traffic["seq_len"])
        opt = dict(traffic["optimizer"])
        warmup = int(traffic["warmup_steps"])
        stream = TokenStream(m["vocab_size"], batch, seq, seed, **traffic["tokens"])
        fed = stream if wrap_tokens is None else wrap_tokens(stream)
        spans = Spans()

        step_fn = program_step(cfg, traffic)
        if wrap_step is not None:
            step_fn = wrap_step(step_fn)

        def timed_step(params, opt_state, b):
            with spans("step"):
                params, opt_state, loss = step_fn(params, opt_state, b)
                loss.item()  # the loss on the host, as train_on reads it
            return params, opt_state, loss

        def init_state():
            params = weights.tree(descs, seed, dev)
            return params, adamw_init(params)

        root = Path(tempfile.mkdtemp(prefix="cardbench-"))
        trace_dev = trace.DeviceTrace(traced)
        cluster = None
        try:
            cluster = LocalCluster(root)
            cluster.add("data", lambda: DataPipelineStateObject(root / "data", fed))
            with spans("persist_v0"):
                cluster.add("trainer", lambda: TrainerStateObject(root / "trainer", init_state,
                                                                  timed_step, device=dev),
                            group_commit_interval=float(traffic["trainer_group_commit_interval_s"]))
            cluster.add("metrics", lambda: MetricsStateObject(root / "metrics"))
            driver = Driver(cluster, (DelayMessage, RolledBackError))

            # -- set-up steps, the program's readings taken as they pass ------
            prog: dict = {"loss": []}

            def warm(step, loss):
                trainer = cluster.get("trainer")
                prog["loss"].append(loss)
                if trainer.current_step() == 1:
                    prog["grad"] = check.grad_norms(descs, trainer.opt_state["m"], opt["b1"])
                if trainer.current_step() == warmup:
                    prog["update"] = check.change_norms(descs, trainer.params,
                                                        weights.leaves(descs, seed, dev))
                    return True
                return False

            with spans("warmup"):
                driver.run(warm)
            trace_dev.start()
            if dev.type == "cuda":
                torch.cuda.synchronize()

            # -- the window ---------------------------------------------------
            kills = list(traffic.get("kills", []))
            replay: dict = {"first": None, "at": None, "kill_sum": None, "replay_sum": None}
            start_step = cluster.get("trainer").current_step()
            window_steps = 0
            t0 = time.perf_counter_ns()
            wall0 = time.time_ns() - t0
            deadline = t0 + int(seconds * 1e9)

            def window(step, loss):
                nonlocal window_steps
                window_steps += 1
                trainer = cluster.get("trainer")
                if replay["at"] is not None and replay["replay_sum"] is None \
                        and trainer.current_step() == replay["at"]:
                    with spans("check"):
                        replay["replay_sum"] = check.checksums([trainer.params, trainer.opt_state])
                if kills and window_steps == kills[0]["after_window_steps"]:
                    k = kills.pop(0)
                    if k["target"] == "trainer" and replay["at"] is None:
                        with spans("check"):
                            replay["first"] = dict(trainer.loss_history)
                            replay["at"] = trainer.current_step()
                            replay["kill_sum"] = check.checksums([trainer.params,
                                                                  trainer.opt_state])
                    with spans("restore"):
                        cluster.kill(k["target"])
                return time.perf_counter_ns() >= deadline

            driver.run(window)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter_ns()
            trainer = cluster.get("trainer")
            end_step = trainer.current_step()
            history = list(trainer.loss_history)
            records = list(cluster.get("metrics").records)
            peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
            t_stop = time.perf_counter()
            events = trace_dev.stop()
            trace_stop_s = time.perf_counter() - t_stop
            rollbacks = driver.rollbacks
        finally:
            if cluster is not None:
                # shutdown persists every member; the trainer's whole state
                # would take minutes of host zlib, and nothing reads it
                with contextlib.suppress(KeyError):
                    cluster.get("trainer").runtime.mark_dead()
                cluster.shutdown()
            shutil.rmtree(root, ignore_errors=True)
    setup_s = (t0 / 1e9) - t_process
    set_up = {n: (b - a) / 1e9 for n, a, b in spans.items if n in ("persist_v0", "warmup")}
    del cluster, trainer, driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    n_kills = len(traffic.get("kills", []))
    t_ref = time.perf_counter()
    ref = reference_readings(config, seed, [stream.batch_at(s) for s in range(warmup)], dev,
                             warmup, opt)
    reference_s = time.perf_counter() - t_ref
    numbers = check.compare(prog, ref)
    if replay["at"] is not None:
        replayed = dict(history)
        diffs = [abs(replayed.get(s, math.inf) - l) for s, l in replay["first"].items()]
        numbers["replay_loss_diff"] = (max(diffs), f"steps 0-{replay['at'] - 1}")
        got = replay["replay_sum"] or []
        n = len(replay["kill_sum"])
        numbers["replay_state_diff"] = (
            n if not got else sum(a != b for a, b in zip(got, replay["kill_sum"])),
            f"{n} tensors at step {replay['at']}" + ("" if got else ", not reached"))
    numbers["metrics_once_gap"] = (check.metrics_once_gap(history, records),
                                   f"{len(records)} records, steps 0-{end_step - 1}")
    numbers["rollback_gap"] = (abs(rollbacks - n_kills), f"{rollbacks} rollbacks, {n_kills} kills")
    correct, checks = check.verdict(numbers, config.get("limits", {}))

    # -- metrics ------------------------------------------------------------
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks = json.loads((HERE / "peaks.json").read_text()).get(card, {})
    trace_out = None
    t_reduce = time.perf_counter()
    if traced:
        spans_wall = [(n, a + wall0, b + wall0) for n, a, b in spans.items]
        trace_out = trace.reduce(events, t0 + wall0, t1 + wall0, spans_wall)
    reduce_s = time.perf_counter() - t_reduce
    flops = importlib.import_module(f"{__package__}.flops.{m['family']}")
    run = Run(spans=spans, setup_s=setup_s, window_t0=t0, window_t1=t1,
              net_steps=end_step - start_step, tokens_per_step=batch * seq,
              flops_per_step=flops.train_flops(m, batch, seq), peaks=peaks, trace=trace_out)
    metrics = {}
    for entry in (cell.per_layer if traced else cell.end_to_end):
        value = load_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    # the look comes after the reference, the FLOP module and every reader
    # have been imported, so that none of them can bring JAX in unseen
    refuse_forbidden()
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": card,
              "count": cell.chips, "memory_peak_bytes": int(peak),
              "power_limit": nvidia_smi() if dev.type == "cuda" else "none"}
    out = {"correct": bool(correct), "attempted": window_steps,
           "failed": sum(1 for s, l in history if not math.isfinite(l)),
           "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = trace_out["busy_s"]
        device["window_s"] = trace_out["window_s"]
        out["breakdown"] = {"device_ops": trace_out["device_ops"],
                            "idle_gaps": trace_out["idle_gaps"]}
    out["checks"] = checks
    print(f"[cardbench] {cell.name} seed {seed}: setup_s {setup_s:.3f}, window_s {run.window_s:.3f}, "
          f"net steps {run.net_steps} of {window_steps} run, trace stop {trace_stop_s:.3f} s and "
          f"reduce {reduce_s:.3f} s ({len(events)} device events), reference {reference_s:.3f} s, "
          f"peak {peak} bytes, {time.perf_counter() - t_process:.3f} s since process start; "
          f"window steps {sum(run.window_spans('step')):.3f} s over {len(run.window_spans('step'))}, "
          f"restores {run.window_spans('restore')} s; set-up: {t_enter - t_process:.3f} s to the "
          f"harness, persist_v0 (the weights with it) {set_up['persist_v0']:.3f} s, warm-up steps "
          f"{set_up['warmup']:.3f} s, {setup_s - sum(set_up.values()) - (t_enter - t_process):.3f} "
          f"s else",
          file=sys.stderr, flush=True)
    return out


def refuse_forbidden() -> None:
    """Raise ``ForbiddenImport`` if the process holds a module whose
    top-level name, compared whole, is one of ``FORBIDDEN``."""
    loaded = sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))
    if loaded:
        raise ForbiddenImport(loaded)


class ForbiddenImport(RuntimeError):
    def __init__(self, names: List[str]) -> None:
        super().__init__(f"modules loaded in the run's process: {', '.join(names)}")
        self.names = names
