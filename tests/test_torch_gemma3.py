"""gemma3's grouped local/global plan in the port, against the JAX package.

gemma3 smoke has 7 layers: 2 groups of (2 local + 1 global) and 1 local in
the tail; the locals attend within a window of 8 and decode into ring
caches of 8 slots, which wrap after 8 tokens. Weights come from the JAX
package (``params_from_jax``), tokens from numpy with a fixed seed; f32 on
the CPU. Logits are held to 2e-4 of max |logit|, as in
tests/test_torch_arch_smoke.py, where the reason is given.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import cache_descs as jax_cache_descs  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import param_descs as jax_param_descs  # noqa: E402
from repro.models.params import is_desc as jax_is_desc  # noqa: E402
from repro.train import run_resilient_training as jax_run_training  # noqa: E402
from repro.train.serve import run_speculative_serving as jax_run_serving  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.train import loop as port_loop  # noqa: E402
from repro_torch.train import run_resilient_training, run_speculative_serving  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

CFG = get_config("gemma3_4b", smoke=True)
PORT_CFG = port_get_config("gemma3_4b", smoke=True)
TOL = 2e-4
MAX_LEN = 32


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(jax_param_descs(CFG), jax.random.key(0), jnp.float32)
    return jp, tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _tokens(n, seed, batch=None):
    shape = (n,) if batch is None else (batch, n)
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape).astype(np.int32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def test_plan_and_cache_layout_match_reference():
    assert PORT_CFG.global_period == 3 and PORT_CFG.sliding_window == 8
    descs = tm.param_descs(PORT_CFG)
    assert sorted(descs) == ["embed", "group_global", "group_locals", "ln_f", "tail_locals"]
    assert descs["group_locals"]["attn"]["wq"].shape[:2] == (2, 2)   # groups x locals
    assert descs["group_global"]["attn"]["wq"].shape[0] == 2
    assert descs["tail_locals"]["attn"]["wq"].shape[0] == 1
    for max_len in (MAX_LEN, 5):
        j_leaves, _ = jax.tree_util.tree_flatten(jax_cache_descs(CFG, 2, max_len),
                                                 is_leaf=jax_is_desc)
        t_descs = tm.cache_descs(PORT_CFG, 2, max_len)
        t_leaves = tree_flatten(t_descs)[0]
        assert [(d.shape, d.axes, d.init) for d in t_leaves] == \
            [(d.shape, d.axes, d.init) for d in j_leaves]
    # ring caches of min(window, max_len) slots for the locals, full for globals
    descs = tm.cache_descs(PORT_CFG, 1, MAX_LEN)
    assert descs["group_locals"]["k"].shape == (2, 2, 1, 8, 2, 16)
    assert descs["group_global"]["k"].shape == (2, 1, MAX_LEN, 2, 16)
    assert descs["tail_locals"]["k"].shape == (1, 1, 8, 2, 16)


def test_forward_matches_reference_past_the_window(params):
    """24 positions: the locals' window of 8 bites."""
    jp, tp = params
    tok = _tokens(24, seed=3, batch=2)
    want, _, _ = jax_forward(CFG, jp, tok)
    with torch.no_grad():
        got = tm.forward(PORT_CFG, tp, torch.from_numpy(tok))[0]
    _close(got.numpy(), want)


def _port_decode(tp, feed, max_len=MAX_LEN, dtype=torch.float32):
    cache = tm.zeros_from_descs(tm.cache_descs(PORT_CFG, 1, max_len), dtype, device="cpu")
    out = []
    with torch.no_grad():
        for i, t in enumerate(feed):
            lg, new = tm.decode_step(PORT_CFG, tp, cache, torch.tensor([[int(t)]]), i)
            assert new is cache
            out.append(lg[0, 0].numpy())
    return np.stack(out), cache


def test_decode_matches_reference_as_the_rings_wrap(params):
    """24 decode steps: each ring of 8 slots wraps twice. Each f32 decode,
    the JAX package's and the port's, is held to the port's float64 decode
    of the same JAX-initialised weights: on these inputs the port's f32
    logits lie 9.3e-5 of max |logit| from float64 and the reference's
    1.15e-4, on opposite sides (2.1e-4 apart, at step 18, in the rings'
    second wrap), so two f32 decodes held to each other at TOL would test
    their roundings, not the port."""
    jp, tp = params
    feed = _tokens(24, seed=4)
    step = jax.jit(lambda p, c, t, i: jax_decode_step(CFG, p, c, t, i))
    jcache = jax.tree_util.tree_map(lambda d: jnp.zeros(d.shape, jnp.float32),
                                    jax_cache_descs(CFG, 1, MAX_LEN), is_leaf=jax_is_desc)
    ref = []
    for i, t in enumerate(feed):
        lg, jcache = step(jp, jcache, jnp.asarray([[t]], jnp.int32), jnp.asarray(i, jnp.int32))
        ref.append(np.asarray(lg)[0, 0])
    tp64 = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu",
                              dtype=torch.float64)
    want, cache64 = _port_decode(tp64, feed, dtype=torch.float64)
    got, tcache = _port_decode(tp, feed)
    top = np.abs(want).max()
    print(f"f32 decodes from the float64 one, of max |logit|: the port's "
          f"{np.abs(got - want).max() / top:.3e}, the reference's "
          f"{np.abs(np.stack(ref) - want).max() / top:.3e}; from each other "
          f"{np.abs(got - np.stack(ref)).max() / top:.3e}")
    _close(got, want)
    _close(np.stack(ref), want)
    # the cached k/v, to 5e-4 of each float64 leaf's max: in the deepest
    # (tail) layer each side's f32 k/v lie up to 1.2e-4 of the leaf's max
    # from the float64 decode
    for g, j, w in zip(tree_flatten(tcache)[0], jax.tree_util.tree_leaves(jcache),
                       tree_flatten(cache64)[0]):
        _close(g.numpy(), w.numpy(), tol=5e-4)
        _close(np.asarray(j), w.numpy(), tol=5e-4)


def test_teacher_forced_decode_equals_forward(params):
    _, tp = params
    feed = _tokens(24, seed=5)
    got, _ = _port_decode(tp, feed)
    with torch.no_grad():
        want = tm.forward(PORT_CFG, tp, torch.from_numpy(feed)[None])[0][0]
    _close(got, want.numpy())


@pytest.mark.parametrize("kill_at", [None, 8])
def test_serving_matches_reference(params, tmp_path, kill_at):
    """16 tokens served: the rings wrap; a kill after 8 tokens replays them."""
    jp, tp = params
    want = jax_run_serving(tmp_path / "jax", CFG, jp, n_tokens=16, kill_at=kill_at)
    got = run_speculative_serving(tmp_path / "port", PORT_CFG, tp, n_tokens=16,
                                  kill_at=kill_at, device="cpu")
    assert got.tokens_generated == 16 and len(got.durable_tokens) == 16
    assert got.rollbacks == want.rollbacks == (0 if kill_at is None else 1)
    assert got.durable_tokens == want.durable_tokens


def test_resilient_training_with_a_kill_matches_reference(params, tmp_path, monkeypatch):
    """Both loops from the JAX-initialised weights, each with a trainer kill:
    the same steps once each, and the losses within the 5e-3 that the loop's
    amplified rounding allows (tests/test_torch_training.py)."""
    jp, _ = params
    steps = 4
    want = jax_run_training(tmp_path / "jax", CFG, steps=steps, kill_trainer_at=2)
    init = jax.tree_util.tree_map(np.asarray, jp)
    monkeypatch.setattr(
        port_loop, "init_params",
        lambda descs, gen, dtype, device: tm.params_from_jax(init, device=device, dtype=dtype))
    got = run_resilient_training(tmp_path / "port", PORT_CFG, steps=steps, kill_trainer_at=2,
                                 device="cpu")
    base = run_resilient_training(tmp_path / "base", PORT_CFG, steps=steps, device="cpu")
    assert got.rollbacks >= 1 and got.final_step == steps
    assert got.params_digest == base.params_digest
    assert sorted(s for s, _ in got.external_metrics) == list(range(steps))
    got_l = dict(got.external_metrics)
    want_l = dict(want.external_metrics)
    np.testing.assert_allclose([got_l[s] for s in range(steps)],
                               [want_l[s] for s in range(steps)], rtol=5e-3)
