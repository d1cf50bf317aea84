"""The encdec family (seamless-m4t: a non-causal encoder over the stub audio
frames, a decoder of self-attention, cross-attention to the encoder output
and an MLP) in the port, against the JAX package.

seamless smoke has 2 encoder and 2 decoder layers over 24 source frames.
Weights come from the JAX package (``params_from_jax``); tokens and frames
from numpy with a fixed seed, the frames scaled as an embedded token is
(``_frames``). f32 on the CPU; logits are held to 1e-4 of max |logit|, the
bound of tests/test_torch_arch_smoke.py.

The reference's serving session decodes against the zero ``enc_out`` of an
empty cache (``cache_descs`` gives it a zero leaf, and ``decode_step``
passes it as ``enc_out``), so its tokens do not depend on ``frames``; a
decode primed by a ``forward`` with the cache, as tests/test_arch_smoke.py
primes it, cross-attends to the real encoder output. The port does both as
the reference does.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jax_checkpoint  # noqa: E402
from repro import core as jax_core  # noqa: E402
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
from repro_torch import checkpoint as port_checkpoint  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.core import LocalCluster  # noqa: E402
from repro_torch.launch import make_prefill_step, make_serve_step, make_train_step  # noqa: E402
from repro_torch.models import tuning  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train import run_speculative_serving  # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: E402

CFG = get_config("seamless_m4t_large_v2", smoke=True)
PORT_CFG = port_get_config("seamless-m4t-large-v2", smoke=True)
B, S = 2, 16
TOL = 1e-4
LR = 1e-3
MAX_LEN = 32


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(jax_param_descs(CFG), jax.random.key(0), jnp.float32)
    return jp, tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape).astype(np.int32)


def _frames(seed, batch=B):
    """Seeded stub frames, scaled as an embedded token: rows of std
    1/sqrt(vocab_padded) (the init's fan-in), times sqrt(d_model) (gelu)."""
    scale = np.sqrt(CFG.d_model / CFG.vocab_padded)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, CFG.source_len, CFG.d_model)) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def _port_forward(tp, tok, frames, **kw):
    with torch.no_grad():
        return tm.forward(PORT_CFG, tp, torch.from_numpy(tok),
                          extras={"frames": torch.from_numpy(frames)}, **kw)


def test_plan_and_cache_layout_match_reference():
    descs = tm.param_descs(PORT_CFG)
    assert sorted(descs) == ["decoder", "embed", "encoder", "lm_head", "ln_f"]
    assert sorted(descs["decoder"]) == ["attn", "cross_attn", "ln1", "ln2", "ln_cross", "mlp"]
    assert "gate" not in descs["decoder"]["cross_attn"]
    j_leaves = jax.tree_util.tree_leaves(jax_param_descs(CFG), is_leaf=jax_is_desc)
    assert [(d.shape, d.axes, d.init) for d in tree_flatten(descs)[0]] == \
        [(d.shape, d.axes, d.init) for d in j_leaves]
    j_cache = jax.tree_util.tree_leaves(jax_cache_descs(CFG, B, MAX_LEN), is_leaf=jax_is_desc)
    t_cache = tm.cache_descs(PORT_CFG, B, MAX_LEN)
    assert [(d.shape, d.axes, d.init) for d in tree_flatten(t_cache)[0]] == \
        [(d.shape, d.axes, d.init) for d in j_cache]
    assert t_cache["enc_out"].shape == (B, CFG.source_len, CFG.d_model)


def test_forward_matches_reference(params):
    jp, tp = params
    tok, frames = _tokens((B, S), seed=1), _frames(seed=2)
    want, cache_j, aux_j = jax_forward(CFG, jp, tok, extras={"frames": frames})
    got, cache, aux = _port_forward(tp, tok, frames)
    assert cache is None and cache_j is None and float(aux) == float(aux_j) == 0.0
    assert got.shape == (B, S, CFG.vocab_padded)
    _close(got.numpy(), want)


def test_encoder_is_not_causal_and_feeds_every_position(params):
    """A change to the last frame changes the decoder's logits at position
    0: the encoder attends both ways and every decoder position attends to
    all of its output."""
    jp, tp = params
    tok, frames = _tokens((B, S), seed=1), _frames(seed=2)
    late = frames.copy()
    late[:, -1] = _frames(seed=3)[:, -1]
    base = _port_forward(tp, tok, frames)[0][:, 0]
    moved = _port_forward(tp, tok, late)[0][:, 0]
    assert float((moved - base).abs().max()) > 1e-3 * float(base.abs().max())
    _close(moved.numpy(), np.asarray(jax_forward(CFG, jp, tok, extras={"frames": late})[0])[:, 0])


def _port_grads(tp, batch, dtype):
    """The port's loss gradient, leaf by leaf, computed in ``dtype``."""
    leaves, td = tree_flatten(tp)
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in leaves]
    tok = torch.from_numpy(batch["tokens"])
    logits, _, aux = tm.forward(PORT_CFG, tree_unflatten(td, leaves), tok[:, :-1],
                                extras={"frames": torch.from_numpy(batch["frames"]).to(dtype)})
    return [g.double().numpy() for g in
            torch.autograd.grad(tm.lm_loss(PORT_CFG, logits, tok[:, 1:], aux), leaves)]


def test_train_step_matches_reference(params):
    """One optimizer step from the same state and batch. The loss within
    1e-5 relative. The random model's f32 gradients carry rounding of about
    1e-2 of each leaf's max |grad| (its attention is near a hard argmax: the
    init takes wq's fan-in as its 4 heads, and the unnormalised encoder
    output widens the cross-attention logits), in the reference as in the
    port, so the gradients are held to a float64 gradient: the port's f32
    gradient lies no further from it than the reference's does. Adam's
    first step moves each element by about lr in the direction of its
    gradient's sign, so the two new params may differ by up to 2 lr, only
    where the float64 gradient is within the two f32 gradients' rounding.
    The encoder's parameters get a gradient through the cross-attention,
    and so move."""
    jp, tp = params
    batch = {"tokens": _tokens((B, S + 1), seed=4), "frames": _frames(seed=5)}
    pj, _, lj = jax.jit(jax_make_train_step(CFG, JaxAdamWConfig(lr=LR), remat="none"))(
        jp, jax_adamw_init(jp), batch)
    pt, ot, lt = make_train_step(PORT_CFG, AdamWConfig(lr=LR), remat="none")(
        tp, adamw_init(tp), batch)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert 0.5 * np.log(CFG.vocab_size) < float(lt) < 2.5 * np.log(CFG.vocab_size)
    assert int(ot["step"]) == 1

    def jax_loss(p):
        logits, _, aux = jax_forward(CFG, p, batch["tokens"][:, :-1],
                                     extras={"frames": batch["frames"]})
        return jax_lm_loss(CFG, logits, batch["tokens"][:, 1:], aux)

    g_jax = [np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(jax.grad(jax_loss)(jp))]
    g32, g64 = _port_grads(tp, batch, torch.float32), _port_grads(tp, batch, torch.float64)
    moved = 0
    for a, b, gj, gt, g, was in zip(tree_flatten(pt)[0], jax.tree_util.tree_leaves(pj), g_jax,
                                    g32, g64, tree_flatten(tp)[0]):
        scale = np.abs(g).max()
        err_j, err_t = np.abs(gj - g).max(), np.abs(gt - g).max()
        assert err_j <= 5e-2 * scale  # the float64 gradient is the reference's, to rounding
        assert err_t <= max(err_j, 1e-6 * scale)
        diff = np.abs(a.numpy() - np.asarray(b))
        assert diff.max() <= 2 * LR
        apart = diff > LR / 2
        assert (np.abs(g[apart]) <= err_j + err_t).all()
        moved += int(apart.sum())
    assert moved <= 1e-3 * sum(t.numel() for t in tree_flatten(tp)[0])
    for got, was in zip(tree_flatten(pt["encoder"])[0], tree_flatten(tp["encoder"])[0]):
        assert not torch.equal(got, was)


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
    """Remat over the encoder layers and the decoder layers, microbatches
    that slice the frames with the tokens, and the chunked loss: the loss
    and new params of the untuned step (remat "none" of the default step)."""
    _, tp = params
    batch = {"tokens": _tokens((4, S + 1), seed=6), "frames": _frames(seed=7, batch=4)}
    loss0, p0 = _train(tp, batch)
    knob = dict(knob)
    loss1, p1 = _train(tp, batch, remat=knob.pop("remat", "none"), **knob)
    assert abs(float(loss1) - float(loss0)) <= 1e-5 * abs(float(loss0))
    assert max(float((a - b).abs().max()) for a, b in zip(p0, p1)) <= param_tol


def _jax_cache(batch=B):
    return jax.tree_util.tree_map(lambda d: jnp.zeros(d.shape, jnp.float32),
                                  jax_cache_descs(CFG, batch, MAX_LEN), is_leaf=jax_is_desc)


@pytest.mark.parametrize("primed", [True, False])
def test_decode_steps_match_reference(params, primed):
    """Three greedy decode steps through make_serve_step against the
    reference's decode_step. Primed: a forward with the cache at index 0
    runs the encoder and stores its output, as tests/test_arch_smoke.py
    does; unprimed: the cache's zero enc_out, as the serving session runs."""
    jp, tp = params
    frames = _frames(seed=8)
    jcache = _jax_cache()
    tcache = tm.zeros_from_descs(tm.cache_descs(PORT_CFG, B, MAX_LEN), device="cpu")
    if primed:
        zero = np.zeros((B, 1), np.int32)
        _, jcache, _ = jax_forward(CFG, jp, zero, extras={"frames": frames}, cache=jcache,
                                   cache_index=jnp.asarray(0, jnp.int32))
        _, new, _ = _port_forward(tp, zero, frames, cache=tcache, cache_index=0)
        assert new is tcache
        _close(tcache["enc_out"].numpy(), jcache["enc_out"])
        assert float(tcache["enc_out"].abs().max()) > 0
    step_j = jax.jit(lambda p, c, t, i: jax_decode_step(CFG, p, c, t, i,
                                                        extras={"frames": frames}))
    serve_step = make_serve_step(PORT_CFG)
    tok = np.zeros((B, 1), np.int32)
    for i in range(3):
        lj, jcache = step_j(jp, jcache, jnp.asarray(tok), jnp.asarray(i, jnp.int32))
        lt, new = serve_step(tp, tcache, {"tokens": tok, "frames": frames}, i)
        assert new is tcache and lt.shape == (B, 1, PORT_CFG.vocab_padded)
        _close(lt.numpy(), lj)
        tok = np.argmax(np.asarray(lj)[:, :, : CFG.vocab_size], axis=-1).astype(np.int32)
    for g, w in zip(tree_flatten(tcache)[0], jax.tree_util.tree_leaves(jcache)):
        _close(g.numpy(), w)
    if not primed:
        assert not tcache["enc_out"].any()


def test_primed_decode_equals_forward(params):
    """Teacher-forced decode after priming equals one forward position by
    position: the decoder's cached self-attention and its cross-attention
    to the stored encoder output."""
    _, tp = params
    tok, frames = _tokens((1, 12), seed=9), _frames(seed=10, batch=1)
    cache = tm.zeros_from_descs(tm.cache_descs(PORT_CFG, 1, MAX_LEN), device="cpu")
    _port_forward(tp, tok[:, :1], frames, cache=cache, cache_index=0)
    with torch.no_grad():
        got = torch.cat([tm.decode_step(PORT_CFG, tp, cache, torch.from_numpy(tok[:, i: i + 1]),
                                        i)[0] for i in range(12)], dim=1)
    _close(got.numpy(), _port_forward(tp, tok, frames)[0].numpy())


def test_prefill_step_matches_reference(params):
    jp, tp = params
    batch = {"tokens": _tokens((B, S), seed=11), "frames": _frames(seed=12)}
    want = np.asarray(jax.jit(jax_make_prefill_step(CFG))(jp, batch))
    got = make_prefill_step(PORT_CFG)(tp, batch)
    assert got.shape == (B, 1, PORT_CFG.vocab_padded) == want.shape
    _close(got.numpy(), want)
    full = _port_forward(tp, batch["tokens"], batch["frames"])[0]
    torch.testing.assert_close(got, full[:, -1:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kill_at", [None, 8])
def test_serving_matches_reference(params, tmp_path, kill_at):
    """16 tokens served with extras, failure-free and with a kill after 8
    (the replay passes the extras to every decode step): the reference's
    tokens."""
    jp, tp = params
    frames = _frames(seed=13, batch=1)
    want = jax_run_serving(tmp_path / "jax", CFG, jp, n_tokens=16, kill_at=kill_at,
                           extras={"frames": jnp.asarray(frames)})
    got = run_speculative_serving(tmp_path / "port", PORT_CFG, tp, n_tokens=16, kill_at=kill_at,
                                  extras={"frames": frames}, device="cpu")
    assert got.tokens_generated == 16 and len(got.durable_tokens) == 16
    assert got.rollbacks == want.rollbacks == (0 if kill_at is None else 1)
    assert got.durable_tokens == [int(t) for t in want.durable_tokens]


def test_session_tokens_do_not_depend_on_frames(params, tmp_path):
    """The session decodes against its cache's zero enc_out (the reference's
    behaviour): two different frames serve the same tokens, in both
    packages."""
    jp, tp = params
    runs = []
    for seed in (14, 15):
        frames = _frames(seed=seed, batch=1)
        runs.append(run_speculative_serving(tmp_path / f"port{seed}", PORT_CFG, tp, n_tokens=8,
                                            extras={"frames": frames}, device="cpu"))
        runs.append(jax_run_serving(tmp_path / f"jax{seed}", CFG, jp, n_tokens=8,
                                    extras={"frames": jnp.asarray(frames)}))
    tokens = [[int(t) for t in r.durable_tokens] for r in runs]
    assert len(tokens[0]) == 8 and all(t == tokens[0] for t in tokens)


def test_trainer_state_object_trains_with_extras(params, tmp_path):
    """TrainerStateObject.train_on(..., extras=...) carries the frames into
    the train step, in both packages: the same loss."""
    jp, tp = params
    tok, frames = _tokens((B, S + 1), seed=16), _frames(seed=17)
    jax_step = jax.jit(jax_make_train_step(CFG, JaxAdamWConfig(lr=LR), remat="none"))
    port_step = make_train_step(PORT_CFG, AdamWConfig(lr=LR), remat="none")
    runs = (
        (jax_core.LocalCluster, lambda root: jax_checkpoint.TrainerStateObject(
            root, lambda: (jp, jax_adamw_init(jp)), jax_step)),
        (LocalCluster, lambda root: port_checkpoint.TrainerStateObject(
            root, lambda: (tp, adamw_init(tp)), port_step, device="cpu")))
    losses = []
    for i, (cluster_cls, make) in enumerate(runs):
        with cluster_cls(tmp_path / str(i)) as cluster:
            trainer = cluster.add("trainer", lambda: make(tmp_path / str(i) / "trainer"))
            loss, _ = trainer.train_on(0, tok, None, extras={"frames": frames})
            assert trainer.current_step() == 1
        losses.append(loss)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
