"""The port's fabric (``repro_torch.net``) under its training loop, on the CPU.

``run_resilient_training`` takes no cluster argument, in the reference or
the port. The loop runs over the fabric by composition: for the length of a
run, the loop module's ``LocalCluster`` is a factory that builds a fresh
``NetCluster`` over a fresh lossy ``SimTransport`` with two coordinator
shards. The loop's calls to the data, trainer and metrics objects stay
direct, so no tensor crosses the wire; reports, polls, fragments and
decisions do. Both runtimes, a trainer kill and a data kill: the digest is
the failure-free ``LocalCluster`` run's, the external metrics list every
step once, and the losses follow the reference's loop over the reference's
fabric from the same (JAX-initialised) weights. The port's loop retries an
action that a rollback failed under the durable runtime; the reference's
loop is given the same retry here (see the test).

Nothing here asserts a duration: the fabric's latency is real time.
"""
from __future__ import annotations

import pickletools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.net as ref_net  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import DelayMessage as RefDelayMessage  # noqa: E402
from repro.core import RolledBackError as RefRolledBackError  # noqa: E402
from repro.core.ids import Header as RefHeader  # noqa: E402
from repro.core.ids import Vertex as RefVertex  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import param_descs as jax_param_descs  # noqa: E402
from repro.net import wire as ref_wire  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402
from repro.train import run_resilient_training as jax_run  # noqa: E402
import repro_torch.net as port_net  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.ids import Header, Vertex  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.net import wire  # noqa: E402
from repro_torch.train import loop as port_loop  # noqa: E402
from repro_torch.train import run_resilient_training  # noqa: E402

CFG = get_config("gemma_2b", smoke=True)
STEPS = 8
#: every link: 1 ms +- 0.5 latency, 5% loss, 5% reordering, 5% duplication
LINK = dict(latency_ms=1.0, jitter_ms=0.5, loss_prob=0.05, reorder_prob=0.05, dup_prob=0.05)
FAULTS = {"kill_trainer_at=4": {"kill_trainer_at": 4}, "kill_data_at=3": {"kill_data_at": 3}}


def fabric(net, runtime: str, transports: list):
    """In ``LocalCluster``'s place: each call builds a ``NetCluster`` over a
    new ``SimTransport`` (recorded in ``transports``), two coordinator
    shards, every member on ``runtime``."""
    def cluster(root, **kw):
        transport = net.SimTransport(seed=0, default_link=net.LinkSpec(**LINK))
        transports.append(transport)
        return net.NetCluster(root, transport=transport, n_shards=2, runtime=runtime, **kw)
    return cluster


@pytest.fixture(scope="module")
def jax_weights():
    cfg = jax_get_config("gemma_2b", smoke=True)
    return jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax_param_descs(cfg), jax.random.key(0), jnp.float32))


def _from_jax(monkeypatch, weights) -> None:
    monkeypatch.setattr(
        port_loop, "init_params",
        lambda descs, gen, dtype, device: params_from_jax(weights, device=device, dtype=dtype))


@pytest.fixture(scope="module")
def base(tmp_path_factory, jax_weights):
    """The port's failure-free run on ``LocalCluster``, from the JAX weights."""
    with pytest.MonkeyPatch.context() as mp:
        _from_jax(mp, jax_weights)
        return run_resilient_training(tmp_path_factory.mktemp("base"), CFG, steps=STEPS,
                                      device="cpu")


def _steps_once(res) -> list:
    return sorted(s for s, _ in res.external_metrics)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("runtime", ["dse", "durable"])
def test_loop_over_a_lossy_sharded_fabric(tmp_path, monkeypatch, jax_weights, base, runtime,
                                          fault):
    _from_jax(monkeypatch, jax_weights)
    transports = []
    monkeypatch.setattr(port_loop, "LocalCluster", fabric(port_net, runtime, transports))
    got = run_resilient_training(tmp_path / "port", CFG, steps=STEPS, device="cpu",
                                 **FAULTS[fault])
    assert got.final_step == STEPS
    assert got.params_digest == base.params_digest
    assert _steps_once(got) == list(range(STEPS))
    if "kill_trainer_at" in FAULTS[fault]:
        assert got.rollbacks >= 1
    (transport,) = transports
    stats = transport.stats()
    assert stats["sent"] > 0 and stats["delivered_msgs"] > 0
    assert transport._closed  # stopped with the cluster, never reused

    ref_transports = []
    monkeypatch.setattr(ref_loop, "LocalCluster", fabric(ref_net, runtime, ref_transports))
    # Under the durable runtime a rollback that lands while an action's
    # commit waits fails that action with RolledBackError, for the caller to
    # retry (durable/runtime.py). The port's loop retries it as it retries a
    # DelayMessage; the reference's retries only the DelayMessage (about one
    # trainer-kill run in two over this fabric ends in RolledBackError), so
    # here its loop is given the same retry.
    monkeypatch.setattr(ref_loop, "DelayMessage", (RefDelayMessage, RefRolledBackError))
    want = jax_run(tmp_path / "ref", jax_get_config("gemma_2b", smoke=True), steps=STEPS,
                   **FAULTS[fault])
    assert _steps_once(want) == list(range(STEPS))
    got_l = [l for _, l in sorted(got.external_metrics)]
    want_l = [l for _, l in sorted(want.external_metrics)]
    # as in tests/test_torch_training.py: step 0 from the same weights and
    # batch, later steps within the 5e-3 this loop's rounding grows to
    np.testing.assert_allclose(got_l[0], want_l[0], rtol=1e-6)
    np.testing.assert_allclose(got_l, want_l, rtol=5e-3)
    print(f"\n{runtime} {fault}: rollbacks {got.rollbacks}; fabric sent {stats['sent']}, "
          f"retries {stats['retries']}, dropped {stats['dropped_loss']}, duplicated "
          f"{stats['duplicated']}, {stats['bytes']} B")


def _ops(blob: bytes, package: str) -> list:
    """The pickle's opcodes and arguments, ``package``'s module paths written
    as the reference's, the frame length left out."""
    return [(op.name, None if op.name == "FRAME" else
             "repro." + arg[len(package) + 1:] if isinstance(arg, str)
             and arg.startswith(package + ".") else arg)
            for op, arg, _ in pickletools.genops(blob)]


def test_wire_blobs_differ_from_the_references_only_by_module_path():
    """A protocol object on the wire costs its packed bytes and one
    reconstructor reference, named by module path: a port blob is the
    reference's with ``repro_torch.net.wire`` for ``repro.net.wire``, and
    each side loads its own blob back to an equal object."""
    ref_hdr = RefHeader(frozenset({RefVertex("data", 1, 3), RefVertex("trainer", 2, 7)}))
    hdr = Header(frozenset({Vertex("data", 1, 3), Vertex("trainer", 2, 7)}))
    ref_blob, blob = ref_wire.dumps(((ref_hdr, 5), {"k": "v"})), wire.dumps(((hdr, 5), {"k": "v"}))
    assert wire.loads(blob) == ((hdr, 5), {"k": "v"})
    assert ref_wire.loads(ref_blob) == ((ref_hdr, 5), {"k": "v"})
    assert _ops(blob, "repro_torch") == _ops(ref_blob, "repro")
    assert len(blob) - len(ref_blob) == len("repro_torch.net.wire") - len("repro.net.wire")
