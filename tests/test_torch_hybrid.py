"""The hybrid family (zamba2: one shared attention block applied before each
group of Mamba-2 blocks) in the port, against the JAX package.

zamba2 smoke has 5 SSM layers: 2 groups of 2 and 1 in the tail, so the
shared attention block (one weight set) runs at 2 sites, each with its own
KV cache. Weights come from the JAX package (``params_from_jax``), tokens
from numpy with a fixed seed; f32 on the CPU. Logits are held to 1e-4 of
max |logit|, the bound of tests/test_torch_arch_smoke.py; sequence lengths
are multiples of the smoke config's SSD chunk of 8.
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
from repro.models import lm_loss as jax_lm_loss  # noqa: E402
from repro.models import param_descs as jax_param_descs  # noqa: E402
from repro.models.params import is_desc as jax_is_desc  # noqa: E402
from repro.train import run_resilient_training as jax_run_training  # noqa: E402
from repro.train.serve import run_speculative_serving as jax_run_serving  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.train import loop as port_loop  # noqa: E402
from repro_torch.train import run_resilient_training, run_speculative_serving  # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: E402

CFG = get_config("zamba2_1p2b", smoke=True)
PORT_CFG = port_get_config("zamba2_1p2b", smoke=True)
TOL = 1e-4
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
    assert PORT_CFG.hybrid_attn_period == 2 and PORT_CFG.num_layers == 5
    descs = tm.param_descs(PORT_CFG)
    assert sorted(descs) == ["embed", "group_ssm", "lm_head", "ln_f", "shared_attn",
                             "tail_ssm"]
    assert descs["shared_attn"]["attn"]["wq"].shape == (64, 4, 16)   # one weight set
    assert descs["group_ssm"]["mixer"]["w_x"].shape[:2] == (2, 2)    # groups x period
    assert descs["tail_ssm"]["mixer"]["w_x"].shape[0] == 1
    j_leaves, _ = jax.tree_util.tree_flatten(jax_cache_descs(CFG, 2, MAX_LEN),
                                             is_leaf=jax_is_desc)
    t_descs = tm.cache_descs(PORT_CFG, 2, MAX_LEN)
    assert [(d.shape, d.axes, d.init) for d in tree_flatten(t_descs)[0]] == \
        [(d.shape, d.axes, d.init) for d in j_leaves]
    # a KV cache per site of the shared block
    assert t_descs["shared_attn"]["k"].shape == (2, 2, MAX_LEN, 4, 16)


def test_forward_matches_reference(params):
    jp, tp = params
    tok = _tokens(24, seed=3, batch=2)
    want, _, aux = jax_forward(CFG, jp, tok)
    with torch.no_grad():
        got, cache, aux_t = tm.forward(PORT_CFG, tp, torch.from_numpy(tok))
    assert cache is None and float(aux_t) == float(aux) == 0.0
    _close(got.numpy(), want)


def test_shared_block_gradient_sums_over_its_sites(params):
    """The loss gradient of the one shared attention weight set, against the
    reference's: autograd sums the contributions of both sites. A copy of
    the model whose second site runs a detached copy of the weights gets
    only the first site's part, which differs."""
    jp, tp = params
    tok = _tokens(17, seed=6, batch=2)[:, :16], _tokens(17, seed=6, batch=2)[:, 1:]

    def jloss(p):
        logits, _, aux = jax_forward(CFG, p, tok[0])
        return jax_lm_loss(CFG, logits, tok[1], aux)

    want = jax.grad(jloss)(jp)["shared_attn"]
    leaves, td = tree_flatten(tp)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    tree = tree_unflatten(td, leaves)
    logits, _, aux = tm.forward(PORT_CFG, tree, torch.from_numpy(tok[0]))
    loss = tm.lm_loss(PORT_CFG, logits, torch.from_numpy(tok[1]), aux)
    shared = tree_flatten(tree["shared_attn"])[0]
    got = torch.autograd.grad(loss, shared)
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        _close(g.numpy(), w)
    # the first site alone: the same model with the second site's weights cut off
    calls = []
    block = tm.transformer._block_apply

    def one_site(cfg, lp, *a, **kw):
        if lp is tree["shared_attn"]:
            calls.append(1)
            if len(calls) > 1:
                lp = {k: ({kk: vv.detach() for kk, vv in v.items()} if isinstance(v, dict)
                          else v.detach()) for k, v in lp.items()}
        return block(cfg, lp, *a, **kw)

    tm.transformer._block_apply = one_site
    try:
        logits, _, aux = tm.forward(PORT_CFG, tree, torch.from_numpy(tok[0]))
    finally:
        tm.transformer._block_apply = block
    first = torch.autograd.grad(tm.lm_loss(PORT_CFG, logits, torch.from_numpy(tok[1]), aux),
                                shared)
    assert len(calls) == 2
    assert max(float((a - b).abs().max()) for a, b in zip(first, got)) > 1e-6


def _port_decode(tp, feed, max_len=MAX_LEN):
    cache = tm.zeros_from_descs(tm.cache_descs(PORT_CFG, 1, max_len), device="cpu")
    out = []
    with torch.no_grad():
        for i, t in enumerate(feed):
            lg, new = tm.decode_step(PORT_CFG, tp, cache, torch.tensor([[int(t)]]), i)
            assert new is cache
            out.append(lg[0, 0].numpy())
    return np.stack(out), cache


def test_decode_and_per_site_caches_match_reference(params):
    """16 decode steps on both sides: logits, and every cache leaf (each
    site's k/v, each SSM layer's conv and state); the two sites' caches
    hold different keys (one weight set, different inputs); and the decode
    equals the port's forward position by position."""
    jp, tp = params
    feed = _tokens(16, seed=4)
    step = jax.jit(lambda p, c, t, i: jax_decode_step(CFG, p, c, t, i))
    jcache = jax.tree_util.tree_map(lambda d: jnp.zeros(d.shape, jnp.float32),
                                    jax_cache_descs(CFG, 1, MAX_LEN), is_leaf=jax_is_desc)
    want = []
    for i, t in enumerate(feed):
        lg, jcache = step(jp, jcache, jnp.asarray([[t]], jnp.int32), jnp.asarray(i, jnp.int32))
        want.append(np.asarray(lg)[0, 0])
    got, tcache = _port_decode(tp, feed)
    _close(got, np.stack(want))
    for g, w in zip(tree_flatten(tcache)[0], jax.tree_util.tree_leaves(jcache)):
        _close(g.numpy(), w)
    k = tcache["shared_attn"]["k"]
    assert bool(k[:, :, :16].any(dim=-1).all()) and not torch.equal(k[0], k[1])
    assert not k[:, :, 16:].any()
    with torch.no_grad():
        full = tm.forward(PORT_CFG, tp, torch.from_numpy(feed)[None])[0][0]
    _close(got, full.numpy())


def test_remat_full_equals_none(params):
    """Remat "full" recomputes each group (the shared block and its SSM
    layers) in the backward pass: the same gradients as keeping them."""
    _, tp = params
    tok = torch.from_numpy(_tokens(17, seed=7, batch=2))
    grads = {}
    for remat in ("none", "full"):
        leaves, td = tree_flatten(tp)
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        logits, _, aux = tm.forward(PORT_CFG, tree_unflatten(td, leaves), tok[:, :-1],
                                    remat=remat)
        grads[remat] = torch.autograd.grad(tm.lm_loss(PORT_CFG, logits, tok[:, 1:], aux), leaves)
    for a, b in zip(grads["none"], grads["full"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kill_at", [None, 8])
def test_serving_matches_reference(params, tmp_path, kill_at):
    """16 tokens served; a kill after 8 replays them through both sites'
    caches and the SSM states."""
    jp, tp = params
    want = jax_run_serving(tmp_path / "jax", CFG, jp, n_tokens=16, kill_at=kill_at)
    got = run_speculative_serving(tmp_path / "port", PORT_CFG, tp, n_tokens=16,
                                  kill_at=kill_at, device="cpu")
    assert got.tokens_generated == 16 and len(got.durable_tokens) == 16
    assert got.rollbacks == want.rollbacks == (0 if kill_at is None else 1)
    assert got.durable_tokens == want.durable_tokens


def test_resilient_training_with_a_kill_matches_reference(params, tmp_path, monkeypatch):
    """Both loops from the JAX-initialised weights, each with a trainer kill:
    the failure-free digest, the same steps once each, and the losses within
    the 5e-3 that the loop's amplified rounding allows
    (tests/test_torch_training.py)."""
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
    got_l, want_l = dict(got.external_metrics), dict(want.external_metrics)
    np.testing.assert_allclose([got_l[s] for s in range(steps)],
                               [want_l[s] for s in range(steps)], rtol=5e-3)
