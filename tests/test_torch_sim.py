"""The port's deterministic simulator against the reference's, trace for trace.

``repro_torch.sim`` is a copy of ``repro.sim`` (the drift guard in
``tests/test_torch_package.py`` holds the source), and it runs on the port's
copies of ``core/``, ``net/``, ``services/``, ``durable/`` and ``store/``.
A scenario is a pure function of ``(scenario, seed)``: here every scenario
of ``SCENARIOS`` runs through both packages in one process, and everything
it returns is equal, exactly.

The one stated difference is ``transport_stats["bytes"]``. ``net/wire.py``
pickles its reconstructors (and any exception class) by module path, so a
blob of the port names ``repro_torch.net.wire`` where the reference's names
``repro.net.wire``: six bytes more for each module path a pickle memoises.
The test reads every blob the fabric counts, on both sides, and holds them
opcode for opcode, with the module paths mapped and the frame length aside,
and the byte counts to exactly that difference.
"""
from __future__ import annotations

import json
import os
import pickletools
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.net import transport as ref_transport  # noqa: E402
from repro.sim import explore as ref_explore  # noqa: E402
from repro_torch.net import transport as port_transport  # noqa: E402
from repro_torch.sim import FaultPlan  # noqa: E402
from repro_torch.sim import explore as port_explore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCENARIO_FILE = ROOT / "tests" / "scenarios" / "regression_seeds.json"
SEEDS = (0, 1, 2)
#: what a module path of the port adds to the reference's
PATH_BYTES = len("repro_torch") - len("repro")


def _record_blobs(monkeypatch, transport) -> dict:
    """Every blob a ``transport.SimTransport`` adds to its ``bytes`` stat, by
    transport (a scenario may run more than one cluster), in the order it
    counts them: a request at each send, retries included, and a reply at
    each reply."""
    blobs = {}
    cls = transport.SimTransport
    send, send_reply = cls._send, cls._send_reply

    def _send(self, env):
        blobs.setdefault(self, []).append(env.payload)
        return send(self, env)

    def _send_reply(self, request, status, blob):
        blobs.setdefault(self, []).append(blob)
        return send_reply(self, request, status, blob)

    monkeypatch.setattr(cls, "_send", _send)
    monkeypatch.setattr(cls, "_send_reply", _send_reply)
    return blobs


def _ops(blob: bytes, package: str) -> tuple:
    """The pickle's opcodes and arguments, the module paths of ``package``
    written as the reference's and the frame length left out; and how many
    module paths of ``package`` it names. A delay reply is empty."""
    ops, paths = [], 0
    for op, arg, _ in pickletools.genops(blob) if blob else ():
        if op.name == "FRAME":
            arg = None
        elif isinstance(arg, str) and arg.startswith(package + "."):
            paths += 1
            arg = "repro." + arg[len(package) + 1:]
        ops.append((op.name, arg))
    return tuple(ops), paths


def _run_both(monkeypatch, tmp_path, scenario, seed, plan=None):
    ref_blobs = _record_blobs(monkeypatch, ref_transport)
    port_blobs = _record_blobs(monkeypatch, port_transport)
    ref_plan = None if plan is None else ref_explore.FaultPlan.from_json(plan)
    port_plan = None if plan is None else FaultPlan.from_json(plan)
    ref = ref_explore.run_one(scenario, seed, tmp_path / "ref", plan=ref_plan)
    port = port_explore.run_one(scenario, seed, tmp_path / "port", plan=port_plan)
    return ref, port, ref_blobs, port_blobs


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scenario", sorted(ref_explore.SCENARIOS))
def test_port_run_one_equals_the_references(monkeypatch, tmp_path, scenario, seed):
    """The trace, the event count, the virtual time, the value and every
    transport statistic but ``bytes`` are equal; ``bytes`` differs by six
    for each module path in a counted blob, and by nothing else."""
    ref, port, ref_blobs, port_blobs = _run_both(monkeypatch, tmp_path, scenario, seed)
    assert port.trace == ref.trace
    assert port.events == ref.events
    assert port.virtual_time == ref.virtual_time
    assert repr(port.value) == repr(ref.value)
    ref_stats, port_stats = dict(ref.transport_stats), dict(port.transport_stats)
    ref_bytes, port_bytes = ref_stats.pop("bytes"), port_stats.pop("bytes")
    assert port_stats == ref_stats

    assert len(port_blobs) == len(ref_blobs)
    paths = []
    for r_blobs, p_blobs in zip(ref_blobs.values(), port_blobs.values()):
        assert len(p_blobs) == len(r_blobs)
        paths.append(0)
        for r, p in zip(r_blobs, p_blobs):
            (r_ops, r_paths), (p_ops, p_paths) = _ops(r, "repro"), _ops(p, "repro_torch")
            assert p_ops == r_ops and p_paths == r_paths
            assert len(p) - len(r) == PATH_BYTES * p_paths
            paths[-1] += p_paths
    # the result reports the statistics of one of the scenario's transports
    # (the snapshot scenarios' two clusters count the same bytes)
    port_totals = [sum(map(len, b)) for b in port_blobs.values()]
    (i, *_) = [i for i, b in enumerate(ref_blobs.values()) if sum(map(len, b)) == ref_bytes
               and port_totals[i] == port_bytes]
    assert port_bytes - ref_bytes == PATH_BYTES * paths[i]
    print(f"\n{scenario} seed {seed}: {port.events} events, {port.virtual_time:.3f} virtual s, "
          f"{len(port_blobs)} transports, bytes {ref_bytes:.0f} -> {port_bytes:.0f} "
          f"({paths[i]} module paths)")


def _pinned():
    spec = json.loads(SCENARIO_FILE.read_text())
    return [pytest.param(e["scenario"], int(e["seed"]), e.get("plan"),
                         id=f"{e['scenario']}-seed{e['seed']}") for e in spec["pinned"]]


def test_every_pinned_seed_is_replayed():
    assert len(_pinned()) == 17


@pytest.mark.parametrize("scenario,seed,plan", _pinned())
def test_pinned_seed_replays_in_the_port(scenario, seed, plan, tmp_path):
    """Every pinned (scenario, seed) keeps every invariant green in the
    port (``run_one`` raises ``InvariantViolation`` otherwise)."""
    port_explore.run_one(scenario, seed, tmp_path,
                         plan=None if plan is None else FaultPlan.from_json(plan))


def test_sweep_cli_runs_the_port_once(tmp_path):
    """``python -m repro_torch.sim.explore`` exits 0 on a green sweep, and
    runs its module once: ``sim/__init__.py`` imports ``explore`` lazily, so
    runpy does not find it imported already."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-W", "error::RuntimeWarning", "-m",
                          "repro_torch.sim.explore", "--scenario", "kv", "--seeds", "2",
                          "--workdir", str(tmp_path)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr[-4000:]
    assert "2 runs green" in run.stdout
    assert "RuntimeWarning" not in run.stderr


def test_a_failing_sweep_names_the_ports_repro_command(tmp_path, monkeypatch, capsys):
    """A failing seed's artifact tells the user to rerun the port's module."""
    def boom(seed, root, plan):
        raise port_explore.InvariantViolation("injected")

    monkeypatch.setitem(port_explore.SCENARIOS, "kv", boom)
    assert port_explore.sweep(["kv"], 1, workdir=tmp_path) == 1
    out = capsys.readouterr().out
    assert "repro: python -m repro_torch.sim.explore --scenario kv --seeds 1 --start-seed 0" in out
