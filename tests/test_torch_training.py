"""The port's resilient training loop on the CPU: twins of the loop tests of
``tests/test_training.py``, plus one test of the whole slice against the
JAX package's loop. ``device="cpu"`` runs the plain versions of the kernels.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import param_descs as jax_param_descs  # noqa: E402
from repro.train import run_resilient_training as jax_run  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.train import loop as port_loop  # noqa: E402
from repro_torch.train import run_resilient_training  # noqa: E402

CFG = get_config("gemma_2b", smoke=True)
STEPS = 8


def run(root, **kw):
    return run_resilient_training(root, CFG, device="cpu", **kw)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The failure-free run the failure runs are held against."""
    return run(tmp_path_factory.mktemp("base"), steps=STEPS)


def test_loop_runs_and_losses_finite(tmp_path):
    res = run(tmp_path / "a", steps=4)
    assert res.final_step == 4
    assert len(res.metrics) == 4
    assert all(np.isfinite(l) for _, l in res.metrics)


def test_failure_run_equals_failure_free_run(tmp_path, base):
    injected = run(tmp_path / "inj", steps=STEPS, kill_trainer_at=4)
    assert injected.rollbacks >= 1
    assert injected.params_digest == base.params_digest
    assert injected.final_step == base.final_step == STEPS


def test_external_metrics_see_each_step_exactly_once(tmp_path):
    res = run(tmp_path / "m", steps=STEPS, kill_trainer_at=5)
    assert sorted(s for s, _ in res.external_metrics) == list(range(STEPS))
    by_step = {}
    for s, l in res.metrics:
        by_step.setdefault(s, set()).add(round(l, 5))
    assert all(len(v) == 1 for v in by_step.values())


def test_data_pipeline_failure_recovers(tmp_path, base):
    injected = run(tmp_path / "d", steps=STEPS, kill_data_at=3)
    assert injected.params_digest == base.params_digest


def test_delta_codec_preserves_state(tmp_path):
    delta = run(tmp_path / "dc", steps=STEPS, kill_trainer_at=4, use_delta_codec=True)
    assert delta.final_step == STEPS
    assert len(delta.external_metrics) == STEPS
    assert delta.checkpoint_bytes > 0


def test_whole_slice_matches_jax_loop(tmp_path, monkeypatch):
    """Both loops start from the JAX-initialised weights; the port's
    per-step losses of a failure-free run follow the reference's."""
    jax_cfg = jax_get_config("gemma_2b", smoke=True)
    want = jax_run(tmp_path / "jax", jax_cfg, steps=STEPS)
    init = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax_param_descs(jax_cfg), jax.random.key(0), jnp.float32)
    )
    monkeypatch.setattr(
        port_loop, "init_params",
        lambda descs, gen, dtype, device: params_from_jax(init, device=device, dtype=dtype),
    )
    got = run(tmp_path / "port", steps=STEPS)
    assert [s for s, _ in got.external_metrics] == [s for s, _ in want.external_metrics]
    got_l = [l for _, l in got.external_metrics]
    want_l = [l for _, l in want.external_metrics]
    # step 0: the same weights and batch, f32 forward on both sides
    np.testing.assert_allclose(got_l[0], want_l[0], rtol=1e-6)
    # Later steps: from the same state one step agrees to ~1e-8 per weight
    # (test_torch_model.py), but autograd and jax.grad round differently and
    # this run amplifies rounding: the JAX loop against itself, with every
    # initial weight moved by one ulp, differs by 1.5e-3 relative at step 8
    np.testing.assert_allclose(got_l, want_l, rtol=5e-3)
