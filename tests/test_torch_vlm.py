"""The vlm family (llama-3.2-vision: groups of self-attention blocks, each
group closed by a tanh-gated cross-attention block over the stub image
embeddings) in the port, against the JAX package.

llama-vision smoke has 4 layers: 2 groups of 1 self and 1 cross block, over
16 image tokens, GQA 4:2. Every gate is 0 at init (``tanh(0) = 0``), which
makes each cross block the identity, so the gates are first set to seeded
non-zero values in the numpy parameters, and those go to both packages
(``params_from_jax``). Tokens and image embeddings come from numpy with a
fixed seed, the embeddings scaled as an embedded token is
(``_image_embeds``). f32 on the CPU; logits are held to 1e-4 of max
|logit|, the bound of tests/test_torch_arch_smoke.py.
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
from repro.train.serve import run_speculative_serving as jax_run_serving  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.launch import make_prefill_step, make_serve_step, make_train_step  # noqa: E402
from repro_torch.models import tuning  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import run_speculative_serving  # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: E402

CFG = get_config("llama_3p2_vision_90b", smoke=True)
PORT_CFG = port_get_config("llama-3.2-vision-90b", smoke=True)
B, S = 2, 16
TOL = 1e-4
LR = 1e-3
MAX_LEN = 32


def _gated(tree, seed=0):
    """The numpy params with every cross block's two gates set to seeded
    values of magnitude 0.5-1.5 and random sign (0 at init)."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.asarray, tree)
    gc = out["group_cross"]
    for holder, key in ((gc["attn"], "gate"), (gc, "mlp_gate")):
        shape = holder[key].shape
        holder[key] = (rng.uniform(0.5, 1.5, shape) * rng.choice([-1.0, 1.0], shape)
                       ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def params():
    """The reference's and the port's params, gates non-zero; and the
    reference's params as initialised (gates 0)."""
    j0 = jax_init_params(jax_param_descs(CFG), jax.random.key(0), jnp.float32)
    gated = _gated(j0)
    return (jax.tree_util.tree_map(jnp.asarray, gated), tm.params_from_jax(gated, device="cpu"),
            j0)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape).astype(np.int32)


def _image_embeds(seed, batch=B):
    """Seeded stub image embeddings, scaled as an embedded token: rows of std
    1/sqrt(vocab_padded) (the init's fan-in; no gelu scaling here)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, CFG.num_image_tokens, CFG.d_model))
            / np.sqrt(CFG.vocab_padded)).astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def _port_forward(tp, tok, img, **kw):
    with torch.no_grad():
        return tm.forward(PORT_CFG, tp, torch.from_numpy(tok),
                          extras={"image_embeds": torch.from_numpy(img)}, **kw)


def test_plan_and_cache_layout_match_reference():
    descs = tm.param_descs(PORT_CFG)
    assert sorted(descs) == ["embed", "group_cross", "group_selfs", "lm_head", "ln_f"]
    assert descs["group_selfs"]["attn"]["wq"].shape[:2] == (2, 1)   # groups x (period - 1)
    assert descs["group_cross"]["attn"]["gate"].shape == (2, 1)
    assert descs["group_cross"]["mlp_gate"].init == "zeros"
    j_leaves = jax.tree_util.tree_leaves(jax_param_descs(CFG), is_leaf=jax_is_desc)
    assert [(d.shape, d.axes, d.init) for d in tree_flatten(descs)[0]] == \
        [(d.shape, d.axes, d.init) for d in j_leaves]
    j_cache = jax.tree_util.tree_leaves(jax_cache_descs(CFG, B, MAX_LEN), is_leaf=jax_is_desc)
    t_cache = tm.cache_descs(PORT_CFG, B, MAX_LEN)
    assert [(d.shape, d.axes, d.init) for d in tree_flatten(t_cache)[0]] == \
        [(d.shape, d.axes, d.init) for d in j_cache]
    assert sorted(t_cache) == ["group_selfs"]  # the cross blocks keep no cache


def test_forward_matches_reference(params):
    jp, tp, _ = params
    tok, img = _tokens((B, S), seed=1), _image_embeds(seed=2)
    want, cache_j, aux_j = jax_forward(CFG, jp, tok, extras={"image_embeds": img})
    got, cache, aux = _port_forward(tp, tok, img)
    assert cache is None and cache_j is None and float(aux) == float(aux_j) == 0.0
    assert got.shape == (B, S, CFG.vocab_padded)
    _close(got.numpy(), want)


def test_image_embeds_count_only_through_open_gates(params):
    """With non-zero gates a change of image_embeds changes the logits (at
    position 0 too: no mask over the image tokens); with the gates at their
    init of 0 it changes nothing, in both packages."""
    jp, tp, j0 = params
    tok, img, other = _tokens((B, S), seed=1), _image_embeds(seed=2), _image_embeds(seed=3)
    a, b = _port_forward(tp, tok, img)[0], _port_forward(tp, tok, other)[0]
    assert float((a - b)[:, 0].abs().max()) > 1e-3 * float(a.abs().max())
    _close(b.numpy(), jax_forward(CFG, jp, tok, extras={"image_embeds": other})[0])
    t0 = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, j0), device="cpu")
    assert torch.equal(_port_forward(t0, tok, img)[0], _port_forward(t0, tok, other)[0])
    np.testing.assert_array_equal(
        np.asarray(jax_forward(CFG, j0, tok, extras={"image_embeds": img})[0]),
        np.asarray(jax_forward(CFG, j0, tok, extras={"image_embeds": other})[0]))


def _port_grads(tp, batch, dtype):
    """The port's loss gradient, leaf by leaf, computed in ``dtype``."""
    leaves, td = tree_flatten(tp)
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in leaves]
    tok = torch.from_numpy(batch["tokens"])
    img = torch.from_numpy(batch["image_embeds"]).to(dtype)
    logits, _, aux = tm.forward(PORT_CFG, tree_unflatten(td, leaves), tok[:, :-1],
                                extras={"image_embeds": img})
    return [g.double().numpy() for g in
            torch.autograd.grad(tm.lm_loss(PORT_CFG, logits, tok[:, 1:], aux), leaves)]


def test_train_step_matches_reference(params):
    """One optimizer step from the same state and batch: the loss within 1e-5
    relative; the gradients of the two packages within 1e-4 of each leaf's
    max |grad|, the gates' non-zero; the new params as
    tests/test_torch_arch_smoke.py holds them (Adam's first step can move a
    near-zero gradient's element by up to 2 lr), the gates moved."""
    jp, tp, _ = params
    batch = {"tokens": _tokens((B, S + 1), seed=4), "image_embeds": _image_embeds(seed=5)}
    pj, _, lj = jax.jit(jax_make_train_step(CFG, JaxAdamWConfig(lr=LR), remat="none"))(
        jp, jax_adamw_init(jp), batch)
    pt, ot, lt = make_train_step(PORT_CFG, AdamWConfig(lr=LR), remat="none")(
        tp, adamw_init(tp), batch)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert 0.5 * np.log(CFG.vocab_size) < float(lt) < 2.5 * np.log(CFG.vocab_size)
    assert int(ot["step"]) == 1

    def jax_loss(p):
        logits, _, aux = jax_forward(CFG, p, batch["tokens"][:, :-1],
                                     extras={"image_embeds": batch["image_embeds"]})
        return jax_lm_loss(CFG, logits, batch["tokens"][:, 1:], aux)

    g_jax = jax.grad(jax_loss)(jp)
    for gt, gj in zip(_port_grads(tp, batch, torch.float32), jax.tree_util.tree_leaves(g_jax)):
        _close(gt, gj)
    for key in ("gate", "mlp_gate"):
        g = (g_jax["group_cross"]["attn"] if key == "gate" else g_jax["group_cross"])[key]
        assert (np.abs(np.asarray(g)) > 1e-6).all()
    diffs = np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel() for a, b in
                            zip(tree_flatten(pt)[0], jax.tree_util.tree_leaves(pj))])
    assert diffs.max() <= 2 * LR and diffs.mean() <= 1e-6
    assert not torch.equal(pt["group_cross"]["attn"]["gate"], tp["group_cross"]["attn"]["gate"])
    assert not torch.equal(pt["group_cross"]["mlp_gate"], tp["group_cross"]["mlp_gate"])


def _train(tp, batch, remat="none", **tune):
    with tuning(**tune):
        p2, _, loss = make_train_step(PORT_CFG, AdamWConfig(lr=LR), remat=remat)(
            tp, adamw_init(tp), batch)
    return loss, tree_flatten(p2)[0]


@pytest.mark.parametrize("knob,param_tol", [
    ({"remat": "none"}, 1e-6),
    ({"remat": "dots"}, 1e-6),
    ({"remat": "full"}, 1e-6),
    # the bounds of tests/test_torch_tuning.py: Adam's first step turns a
    # reassociated near-zero gradient into up to one lr step
    ({"microbatch": 2}, 2e-3),
    ({"loss_chunk": 4}, 2e-3),
])
def test_tuned_train_step_matches_untuned(params, knob, param_tol):
    """Remat over each group (its self blocks and its cross block),
    microbatches that slice the image embeddings with the tokens, and the
    chunked loss: the loss and new params of the untuned step."""
    _, tp, _ = params
    batch = {"tokens": _tokens((4, S + 1), seed=6), "image_embeds": _image_embeds(seed=7, batch=4)}
    loss0, p0 = _train(tp, batch)
    knob = dict(knob)
    loss1, p1 = _train(tp, batch, remat=knob.pop("remat", "none"), **knob)
    assert abs(float(loss1) - float(loss0)) <= 1e-5 * abs(float(loss0))
    assert max(float((a - b).abs().max()) for a, b in zip(p0, p1)) <= param_tol


def test_decode_steps_match_reference(params):
    """Three greedy decode steps through make_serve_step against the
    reference's decode_step; every cache leaf after them; and the decode
    equals the port's forward position by position."""
    jp, tp, _ = params
    img = _image_embeds(seed=8)
    jcache = jax.tree_util.tree_map(lambda d: jnp.zeros(d.shape, jnp.float32),
                                    jax_cache_descs(CFG, B, MAX_LEN), is_leaf=jax_is_desc)
    tcache = tm.zeros_from_descs(tm.cache_descs(PORT_CFG, B, MAX_LEN), device="cpu")
    step_j = jax.jit(lambda p, c, t, i: jax_decode_step(CFG, p, c, t, i,
                                                        extras={"image_embeds": img}))
    serve_step = make_serve_step(PORT_CFG)
    tok, fed, got = np.zeros((B, 1), np.int32), [], []
    for i in range(3):
        fed.append(tok)
        lj, jcache = step_j(jp, jcache, jnp.asarray(tok), jnp.asarray(i, jnp.int32))
        lt, new = serve_step(tp, tcache, {"tokens": tok, "image_embeds": img}, i)
        assert new is tcache and lt.shape == (B, 1, PORT_CFG.vocab_padded)
        _close(lt.numpy(), lj)
        got.append(lt)
        tok = np.argmax(np.asarray(lj)[:, :, : CFG.vocab_size], axis=-1).astype(np.int32)
    for g, w in zip(tree_flatten(tcache)[0], jax.tree_util.tree_leaves(jcache)):
        _close(g.numpy(), w)
    _close(torch.cat(got, dim=1).numpy(),
           _port_forward(tp, np.concatenate(fed, axis=1), img)[0].numpy())


def test_prefill_step_matches_reference(params):
    jp, tp, _ = params
    batch = {"tokens": _tokens((B, S), seed=11), "image_embeds": _image_embeds(seed=12)}
    want = np.asarray(jax.jit(jax_make_prefill_step(CFG))(jp, batch))
    got = make_prefill_step(PORT_CFG)(tp, batch)
    assert got.shape == (B, 1, PORT_CFG.vocab_padded) == want.shape
    _close(got.numpy(), want)
    full = _port_forward(tp, batch["tokens"], batch["image_embeds"])[0]
    torch.testing.assert_close(got, full[:, -1:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kill_at", [None, 8])
def test_serving_matches_reference(params, tmp_path, kill_at):
    """16 tokens served with the image embeddings, failure-free and with a
    kill after 8 (the replay passes them to every decode step): the
    reference's tokens."""
    jp, tp, _ = params
    img = _image_embeds(seed=13, batch=1)
    want = jax_run_serving(tmp_path / "jax", CFG, jp, n_tokens=16, kill_at=kill_at,
                           extras={"image_embeds": jnp.asarray(img)})
    got = run_speculative_serving(tmp_path / "port", PORT_CFG, tp, n_tokens=16, kill_at=kill_at,
                                  extras={"image_embeds": img}, device="cpu")
    assert got.tokens_generated == 16 and len(got.durable_tokens) == 16
    assert got.rollbacks == want.rollbacks == (0 if kill_at is None else 1)
    assert got.durable_tokens == [int(t) for t in want.durable_tokens]
