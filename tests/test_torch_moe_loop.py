"""The moe family (granite-moe-3b-a800m, deepseek-v2-lite-16b with MLA) on
the port's resilient loop and serving path, against the JAX package's.

Both sides start from the same weights: the JAX package initialises them and
``params_from_jax`` loads them into the port; f32 on the CPU, at the smoke
configs. The MoE layer itself is held against the reference in
tests/test_torch_moe.py.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import param_descs as jax_param_descs  # noqa: E402
from repro.train import run_resilient_training as jax_run_training  # noqa: E402
from repro.train.serve import run_speculative_serving as jax_run_serving  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.train import loop as port_loop  # noqa: E402
from repro_torch.train import run_resilient_training, run_speculative_serving  # noqa: E402

ARCHS = ["granite_moe_3b_a800m", "deepseek_v2_lite_16b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_with_a_kill_matches_reference(arch, tmp_path):
    """16 tokens served from the JAX-initialised weights, failure-free and
    killed after 8: the same durable tokens as each other and as the
    reference's serving loop."""
    cfg = get_config(arch, smoke=True)
    jp = jax_init_params(jax_param_descs(cfg), jax.random.key(0), jnp.float32)
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tcfg = port_get_config(arch, smoke=True)
    want = jax_run_serving(tmp_path / "jax", cfg, jp, n_tokens=16, kill_at=8)
    base = run_speculative_serving(tmp_path / "base", tcfg, tp, n_tokens=16, device="cpu")
    got = run_speculative_serving(tmp_path / "kill", tcfg, tp, n_tokens=16, kill_at=8,
                                  device="cpu")
    assert got.rollbacks == want.rollbacks == 1 and got.tokens_generated == 16
    assert len(base.durable_tokens) == 16 and got.durable_tokens == base.durable_tokens
    assert got.durable_tokens == want.durable_tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_resilient_training_with_a_kill(arch, tmp_path, monkeypatch):
    """The loop from the JAX-initialised weights with a trainer kill ends
    with the failure-free digest, each step's metric once, and losses
    within the loop's 5e-3 of the reference's (tests/test_torch_training.py)."""
    cfg = get_config(arch, smoke=True)
    tcfg = port_get_config(arch, smoke=True)
    steps = 4
    want = jax_run_training(tmp_path / "jax", cfg, steps=steps, kill_trainer_at=2)
    init = jax.tree_util.tree_map(np.asarray, jax_init_params(
        jax_param_descs(cfg), jax.random.key(0), jnp.float32))
    monkeypatch.setattr(
        port_loop, "init_params",
        lambda descs, gen, dtype, device: tm.params_from_jax(init, device=device, dtype=dtype))
    got = run_resilient_training(tmp_path / "port", tcfg, steps=steps, kill_trainer_at=2,
                                 device="cpu")
    base = run_resilient_training(tmp_path / "base", tcfg, steps=steps, device="cpu")
    assert got.rollbacks >= 1 and got.final_step == steps
    assert got.params_digest == base.params_digest
    assert sorted(s for s, _ in got.external_metrics) == list(range(steps))
    got_l, want_l = dict(got.external_metrics), dict(want.external_metrics)
    np.testing.assert_allclose([got_l[s] for s in range(steps)],
                               [want_l[s] for s in range(steps)], rtol=5e-3)
