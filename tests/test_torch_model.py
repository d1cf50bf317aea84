"""The port's dense and ssm models, AdamW and train step against the JAX package.

Both sides start from the same weights: the JAX package initialises them
and ``params_from_jax`` loads the arrays into the port (torch cannot
reproduce ``jax.random``). Inputs come from numpy with a fixed seed, and
everything runs in f32 on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data import SyntheticLMData  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import lm_loss as jax_lm_loss  # noqa: E402
from repro.models import param_descs as jax_param_descs  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

CFG = get_config("gemma_2b", smoke=True)
LR = 1e-3


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax_param_descs(CFG), jax.random.key(0), dtype=jnp.float32)


def _port(tree_j):
    return tm.params_from_jax(jax.tree_util.tree_map(np.asarray, tree_j), device="cpu")


def _leaves_np(tree_t):
    return [t.detach().numpy() for t in tree_flatten(tree_t)[0]]


def _tokens(seed=0, batch=4, seq=17):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, (batch, seq)).astype(np.int32)


def test_param_descs_match_jax_tree():
    jd = jax_param_descs(CFG)
    td = tm.param_descs(CFG)
    j_leaves, j_def = jax.tree_util.tree_flatten(jd, is_leaf=lambda x: hasattr(x, "axes"))
    t_leaves = tree_flatten(td)[0]
    assert [(d.shape, d.axes, d.init) for d in j_leaves] == \
        [(d.shape, d.axes, d.init) for d in t_leaves]
    assert tm.param_count(td) == sum(int(np.prod(d.shape)) for d in j_leaves)


def test_logits_and_loss_match(jax_params):
    tok = _tokens()
    logits_j, _, aux = jax_forward(CFG, jax_params, tok[:, :-1])
    loss_j = jax_lm_loss(CFG, logits_j, tok[:, 1:], aux)
    params = _port(jax_params)
    logits_t, cache, aux_t = tm.forward_dense(CFG, params, torch.from_numpy(tok[:, :-1]))
    assert cache is None and aux_t.shape == () and float(aux_t) == 0.0 == float(aux)
    loss_t = tm.lm_loss(CFG, logits_t, torch.from_numpy(tok[:, 1:]), aux_t)
    assert logits_t.shape == (4, 16, CFG.vocab_padded)
    # f32 sums in another order (einsum vs XLA dots): logits of magnitude
    # ~1 agree to 1e-4, the loss to 1e-5 relative
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    # the nn.Module form computes the same function on the same leaves
    model = tm.DenseLM(CFG, params)
    assert len(list(model.parameters())) == len(tree_flatten(params)[0])
    assert "layers__attn__wq" in dict(model.named_parameters())
    torch.testing.assert_close(model(torch.from_numpy(tok[:, :-1])), logits_t, rtol=0, atol=0)


def test_adamw_update_matches(jax_params):
    rng = np.random.default_rng(1)
    grads_np = jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 0.05).astype(np.float32), jax_params
    )
    state_j = jax_adamw_init(jax_params)
    new_pj, new_sj = jax.jit(jax_adamw_update, static_argnums=3)(
        jax_params, grads_np, state_j, JaxAdamWConfig(lr=LR))
    params = _port(jax_params)
    new_pt, new_st = adamw_update(params, tm.params_from_jax(grads_np, device="cpu"),
                                  adamw_init(params), AdamWConfig(lr=LR))
    assert new_st["step"].dtype == torch.int32 and int(new_st["step"]) == 1
    # identical inputs, f32 elementwise math on both sides: within a few ulp
    for got, want in zip(_leaves_np(new_pt), jax.tree_util.tree_leaves(new_pj)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
    for key in ("m", "v"):
        for got, want in zip(_leaves_np(new_st[key]), jax.tree_util.tree_leaves(new_sj[key])):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match(jax_params, steps):
    data = SyntheticLMData(CFG.vocab_size, 4, 16, seed=0)
    step_j = jax.jit(jax_make_train_step(CFG, JaxAdamWConfig(lr=LR), remat="none"))
    step_t = make_train_step(CFG, AdamWConfig(lr=LR))
    pj, oj = jax_params, jax_adamw_init(jax_params)
    pt = _port(jax_params)
    ot = adamw_init(pt)
    for i in range(steps):
        batch = {"tokens": data.batch_at(i)}
        pj, oj, lj = step_j(pj, oj, batch)
        pt, ot, lt = step_t(pt, ot, batch)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    diffs = np.concatenate([
        np.abs(got - np.asarray(want)).ravel()
        for got, want in zip(_leaves_np(pt), jax.tree_util.tree_leaves(pj))
    ])
    # Autograd and jax.grad round differently. Where a gradient is near zero
    # its sign can differ, and Adam's normalised step g/(|g|+eps) turns that
    # into a full +-lr step: each step can move an element by at most 2*lr
    # apart. Such elements are rare, so the mean difference stays tiny.
    assert diffs.max() <= 2 * LR * steps
    assert diffs.mean() <= 1e-6


# --------------------------------------------------------------------------- #
# the ssm family (mamba2-370m)                                                 #
# --------------------------------------------------------------------------- #
SSM_CFG = get_config("mamba2_370m", smoke=True)
SSM_PORT_CFG = port_get_config("mamba2-370m", smoke=True)


def test_ssm_param_descs_match_jax_tree():
    for smoke in (True, False):
        cfg = get_config("mamba2_370m", smoke=smoke)
        jd = jax_param_descs(cfg)
        td = tm.param_descs(port_get_config("mamba2_370m", smoke=smoke))
        j_leaves, j_def = jax.tree_util.tree_flatten(jd, is_leaf=lambda x: hasattr(x, "axes"))
        t_leaves = tree_flatten(td)[0]
        assert [(d.shape, d.axes, d.init) for d in j_leaves] == \
            [(d.shape, d.axes, d.init) for d in t_leaves]
        assert tm.param_count(td) == sum(int(np.prod(d.shape)) for d in j_leaves)
    # the full configuration as published: 48 layers, d_model 1024, vocab
    # 50280 padded to 51200, untied head
    assert tm.param_count(td) == 421_709_312


def test_forward_ssm_logits_match_jax():
    jp = jax_init_params(jax_param_descs(SSM_CFG), jax.random.key(0), dtype=jnp.float32)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, SSM_CFG.vocab_size, (2, 16)).astype(np.int32)
    logits_j, _, _ = jax_forward(SSM_CFG, jp, tok)
    cfg = SSM_PORT_CFG
    params = _port(jp)
    logits_t = tm.forward_ssm(cfg, params, torch.from_numpy(tok))[0]
    assert logits_t.shape == (2, 16, cfg.vocab_padded)
    # 4 layers of f32 sums in another order: logits of magnitude ~4 agree to
    # ~2e-5, so 1e-4 as for the dense model
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-4, rtol=0)
    # the family dispatch reaches the same function
    torch.testing.assert_close(tm.forward(cfg, params, torch.from_numpy(tok))[0], logits_t,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="not dense"):
        tm.forward_dense(cfg, params, torch.from_numpy(tok))
