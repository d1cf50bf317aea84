"""Twin of tests/test_arch_smoke.py over the port's architectures, each held
against the JAX package: parameter descriptors, the forward and one train
step, three decode steps and the prefill step.

Both sides start from the same weights: the JAX package initialises them and
``params_from_jax`` loads them into the port. Tokens come from numpy with a
fixed seed; everything runs in f32 on the CPU, at the smoke configs. The
encdec and vlm families get their extras as the reference's test feeds them
(``_extras``), but drawn from a seeded generator rather than a constant, and
the vlm's cross-block gates, 0 at init (which makes each cross block the
identity), are set to seeded non-zero values before both sides load them.
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

    assert ARCHITECTURES == REF
    assert ARCHITECTURES == ["seamless_m4t_large_v2", "yi_6b", "gemma_2b", "glm4_9b",
                             "gemma3_4b", "zamba2_1p2b", "granite_moe_3b_a800m",
                             "deepseek_v2_lite_16b", "mamba2_370m", "llama_3p2_vision_90b"]
    for alias in ("seamless-m4t-large-v2", "yi-6b", "glm4-9b", "gemma3-4b", "zamba2-1.2b",
                  "granite-moe-3b-a800m", "deepseek-v2-lite-16b", "llama-3.2-vision-90b"):
        assert port_get_config(alias).name == alias


def _open_gates(tree, seed=0):
    """numpy params; a vlm's cross-block gates set to seeded values of
    magnitude 0.5-1.5 and random sign."""
    out = jax.tree_util.tree_map(np.asarray, tree)
    if "group_cross" in out:
        rng = np.random.default_rng(seed)
        gc = out["group_cross"]
        for holder, key in ((gc["attn"], "gate"), (gc, "mlp_gate")):
            shape = holder[key].shape
            holder[key] = (rng.uniform(0.5, 1.5, shape) * rng.choice([-1.0, 1.0], shape)
                           ).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ARCHITECTURES)
def arch(request):
    """The reference's config and params, the port's config and params."""
    name = request.param
    cfg = get_config(name, smoke=True)
    init = _open_gates(jax_init_params(jax_param_descs(cfg), jax.random.key(0),
                                       dtype=jnp.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    tp = tm.params_from_jax(init, device="cpu")
    return name, cfg, jp, port_get_config(name, smoke=True), tp


def _extras(cfg, batch=B, seed=9):
    """The reference test's extras (tests/test_arch_smoke.py), drawn from a
    seeded generator, with the std of an embedded token (rows of std
    1/sqrt(vocab_padded), times sqrt(d_model) under gelu)."""
    std = np.sqrt((cfg.d_model if cfg.activation == "gelu" else 1) / cfg.vocab_padded)
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        shape, key = (batch, cfg.source_len, cfg.d_model), "frames"
    elif cfg.family == "vlm":
        shape, key = (batch, cfg.num_image_tokens, cfg.d_model), "image_embeds"
    else:
        return {}
    return {key: (rng.standard_normal(shape) * std).astype(np.float32)}


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
    assert counts["seamless_m4t_large_v2"] == 2_038_555_648
    assert counts["llama_3p2_vision_90b"] == 87_679_377_448
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
    extras = _extras(cfg)
    logits_j, _, aux = jax_forward(cfg, jp, tok[:, :-1], extras=extras)
    loss_j = jax_lm_loss(cfg, logits_j, tok[:, 1:], aux)
    with torch.no_grad():
        logits_t, _, aux_t = tm.forward(tcfg, tp, torch.from_numpy(tok[:, :-1]),
                                        extras={k: torch.from_numpy(v) for k, v in extras.items()})
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
    pj, _, lj = step_j(jp, jax_adamw_init(jp), {"tokens": tok, **extras})
    pt, ot, lt = make_train_step(tcfg, AdamWConfig(lr=LR), remat="none")(
        tp, adamw_init(tp), {"tokens": tok, **extras})
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
    """Three greedy decode steps from an empty cache on both sides; encdec's
    cache first primed with the encoder output, as the reference's test
    primes it."""
    name, cfg, jp, tcfg, tp = arch
    extras = _extras(cfg)
    jcache = jax.tree_util.tree_map(lambda d: jnp.zeros(d.shape, jnp.float32),
                                    jax_cache_descs(cfg, batch=B, max_len=32),
                                    is_leaf=jax_is_desc)
    tcache = tm.zeros_from_descs(tm.cache_descs(tcfg, batch=B, max_len=32), device="cpu")
    if cfg.family == "encdec":
        zero = np.zeros((B, 1), np.int32)
        _, jcache, _ = jax_forward(cfg, jp, zero, extras=extras, cache=jcache,
                                   cache_index=jnp.asarray(0, jnp.int32))
        with torch.no_grad():
            tm.forward(tcfg, tp, torch.from_numpy(zero),
                       extras={k: torch.from_numpy(v) for k, v in extras.items()},
                       cache=tcache, cache_index=0)
    step_j = jax.jit(lambda p, c, t, i: jax_decode_step(cfg, p, c, t, i, extras=extras))
    serve_step = make_serve_step(tcfg)
    tok = np.zeros((B, 1), np.int32)
    for i in range(3):
        lj, jcache = step_j(jp, jcache, jnp.asarray(tok), jnp.asarray(i, jnp.int32))
        lt, new = serve_step(tp, tcache, {"tokens": tok, **extras}, i)
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
    extras = _extras(cfg)
    want = np.asarray(jax.jit(jax_make_prefill_step(cfg))(jp, {"tokens": tok, **extras}))
    got = make_prefill_step(tcfg)(tp, {"tokens": tok, **extras})
    assert got.shape == (B, 1, tcfg.vocab_padded) == want.shape
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_TOL.get(name, DEFAULT_TOL) * np.abs(want).max())
    with torch.no_grad():
        full = tm.forward(tcfg, tp, torch.from_numpy(tok),
                          extras={k: torch.from_numpy(v) for k, v in extras.items()})[0]
    torch.testing.assert_close(got, full[:, -1:], rtol=0, atol=1e-6)
