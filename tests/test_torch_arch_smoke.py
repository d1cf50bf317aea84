"""Twin of tests/test_arch_smoke.py over the port's architectures, each held
against the JAX package: parameter descriptors, the forward and one train
step, three decode steps and the prefill step.

Both sides start from the same weights: the JAX package initialises them and
``params_from_jax`` loads them into the port. Tokens come from numpy with a
fixed seed; everything runs in f32 on the CPU, at the smoke configs.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.launch.steps import make_prefill_step as jax_make_prefill_step  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import cache_descs as jax_cache_descs  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import lm_loss as jax_lm_loss  # noqa: E402
from repro.models import param_descs as jax_param_descs  # noqa: E402
from repro.models.params import is_desc as jax_is_desc  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.launch import make_prefill_step, make_serve_step, make_train_step  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

B, S = 2, 16
LR = 1e-3
#: logits against the reference's, relative to max |logit|: f32 sums in
#: another order. glm4 smoke sits at 6e-6 of its max |logit| 4.4 (the
#: 1.9e-4 an earlier check saw was absolute, 4.7e-5 of max |logit|).
#: gemma3 smoke gets 2e-4: its random attention is near a hard argmax (the
#: init takes wq's fan-in as its 4 heads), and the reference's own f32
#: forward is up to 1.6e-4 of max |logit| from a float64 forward of the
#: port on these inputs, so two f32 forwards can differ by that much
LOGIT_TOL = {"gemma3_4b": 2e-4}
DEFAULT_TOL = 1e-4


def test_port_lists_the_reference_architectures_in_its_order():
    from repro.configs import ARCHITECTURES as REF

    assert ARCHITECTURES == [a for a in REF if a in ARCHITECTURES]
    assert ARCHITECTURES == ["yi_6b", "gemma_2b", "glm4_9b", "gemma3_4b", "zamba2_1p2b",
                             "granite_moe_3b_a800m", "deepseek_v2_lite_16b", "mamba2_370m"]
    for alias in ("yi-6b", "glm4-9b", "gemma3-4b", "zamba2-1.2b", "granite-moe-3b-a800m",
                  "deepseek-v2-lite-16b"):
        assert port_get_config(alias).name == alias


@pytest.fixture(scope="module", params=ARCHITECTURES)
def arch(request):
    """The reference's config and params, the port's config and params."""
    name = request.param
    cfg = get_config(name, smoke=True)
    jp = jax_init_params(jax_param_descs(cfg), jax.random.key(0), dtype=jnp.float32)
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return name, cfg, jp, port_get_config(name, smoke=True), tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _desc_rows(leaves):
    return [(d.shape, d.axes, d.init, d.scale) for d in leaves]


@pytest.mark.parametrize("smoke", [True, False])
def test_param_descs_match_reference(arch, smoke):
    name = arch[0]
    cfg = get_config(name, smoke=smoke)
    j_leaves, _ = jax.tree_util.tree_flatten(jax_param_descs(cfg), is_leaf=jax_is_desc)
    t_leaves = tree_flatten(tm.param_descs(port_get_config(name, smoke=smoke)))[0]
    assert all(tm.is_desc(d) for d in t_leaves)
    assert _desc_rows(t_leaves) == _desc_rows(j_leaves)
    assert tm.param_count(tm.param_descs(port_get_config(name, smoke=smoke))) == \
        sum(int(np.prod(d.shape)) for d in j_leaves)


def test_full_config_parameter_counts():
    """The published widths: the counts chip_smoke.py runs at full width."""
    counts = {a: tm.param_count(tm.param_descs(port_get_config(a))) for a in ARCHITECTURES}
    assert counts["mamba2_370m"] == 421_709_312
    assert counts["gemma_2b"] == 2_506_172_416
    assert counts["gemma3_4b"] == 3_879_907_840
    assert 6.0e9 < counts["yi_6b"] < 6.2e9 and 9.3e9 < counts["glm4_9b"] < 9.5e9
    assert counts["granite_moe_3b_a800m"] == 3_380_577_792
    assert counts["deepseek_v2_lite_16b"] == 15_706_470_400
    assert counts["zamba2_1p2b"] == 1_173_619_584


def test_forward_and_train_step_match_reference(arch):
    name, cfg, jp, tcfg, tp = arch
    tok = _tokens(cfg, (B, S + 1), seed=1)
    logits_j, _, aux = jax_forward(cfg, jp, tok[:, :-1])
    loss_j = jax_lm_loss(cfg, logits_j, tok[:, 1:], aux)
    with torch.no_grad():
        logits_t, _, aux_t = tm.forward(tcfg, tp, torch.from_numpy(tok[:, :-1]))
    assert logits_t.shape == (B, S, tcfg.vocab_padded)
    want = np.asarray(logits_j)
    scale = np.abs(want).max()
    np.testing.assert_allclose(logits_t.numpy(), want, rtol=0,
                               atol=LOGIT_TOL.get(name, DEFAULT_TOL) * scale)
    # the MoE load-balance loss (a 0-d zero for the other families)
    assert aux_t.shape == () and aux_t.dtype == torch.float32
    np.testing.assert_allclose(float(aux_t), float(aux), rtol=1e-5, atol=0)
    assert (float(aux_t) > 0) == (tcfg.moe is not None)
    # one optimizer step on both sides, from the same state and batch
    step_j = jax.jit(jax_make_train_step(cfg, JaxAdamWConfig(lr=LR), remat="none"))
    pj, _, lj = step_j(jp, jax_adamw_init(jp), {"tokens": tok})
    pt, ot, lt = make_train_step(tcfg, AdamWConfig(lr=LR), remat="none")(
        tp, adamw_init(tp), {"tokens": tok})
    np.testing.assert_allclose(float(lt), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    # the loss is a real LM loss: near log(vocab) at init
    assert 0.5 * np.log(cfg.vocab_size) < float(lt) < 2.5 * np.log(cfg.vocab_size)
    assert int(ot["step"]) == 1
    diffs = np.concatenate([
        np.abs(got.numpy() - np.asarray(w)).ravel()
        for got, w in zip(tree_flatten(pt)[0], jax.tree_util.tree_leaves(pj))
    ])
    # as tests/test_torch_model.py holds gemma's step: a near-zero gradient
    # whose sign the two autodiffs round apart moves an element by up to
    # 2 lr under Adam's first step; such elements are rare
    assert diffs.max() <= 2 * LR
    assert diffs.mean() <= 1e-6


def test_decode_steps_match_reference(arch):
    """Three greedy decode steps from an empty cache on both sides."""
    name, cfg, jp, tcfg, tp = arch
    jcache = jax.tree_util.tree_map(lambda d: jnp.zeros(d.shape, jnp.float32),
                                    jax_cache_descs(cfg, batch=B, max_len=32),
                                    is_leaf=jax_is_desc)
    tcache = tm.zeros_from_descs(tm.cache_descs(tcfg, batch=B, max_len=32), device="cpu")
    step_j = jax.jit(lambda p, c, t, i: jax_decode_step(cfg, p, c, t, i))
    serve_step = make_serve_step(tcfg)
    tok = np.zeros((B, 1), np.int32)
    for i in range(3):
        lj, jcache = step_j(jp, jcache, jnp.asarray(tok), jnp.asarray(i, jnp.int32))
        lt, new = serve_step(tp, tcache, {"tokens": tok}, i)
        assert new is tcache and lt.shape == (B, 1, tcfg.vocab_padded)
        want = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy(), want, rtol=0,
                                   atol=LOGIT_TOL.get(name, DEFAULT_TOL) * np.abs(want).max())
        tok = np.argmax(want[:, :, : cfg.vocab_size], axis=-1).astype(np.int32)


def test_prefill_step_matches_reference(arch):
    """make_prefill_step: the last token's logits, against the reference's
    prefill step and the port's own full forward."""
    name, cfg, jp, tcfg, tp = arch
    tok = _tokens(cfg, (B, S), seed=2)
    want = np.asarray(jax.jit(jax_make_prefill_step(cfg))(jp, {"tokens": tok}))
    got = make_prefill_step(tcfg)(tp, {"tokens": tok})
    assert got.shape == (B, 1, tcfg.vocab_padded) == want.shape
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_TOL.get(name, DEFAULT_TOL) * np.abs(want).max())
    with torch.no_grad():
        full = tm.forward(tcfg, tp, torch.from_numpy(tok))[0]
    torch.testing.assert_close(got, full[:, -1:], rtol=0, atol=1e-6)
