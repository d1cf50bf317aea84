"""Twin of tests/test_tuning.py: the port's tuning knobs, remat policies and
the attention softcap preserve what a step computes.

Each tuned train step on yi smoke is held to the port's untuned step within
the reference's own bounds (tests/test_tuning.py), and to the JAX package's
step under the same flags. Against JAX the params are held as
tests/test_torch_model.py holds them: the two autodiffs round a near-zero
gradient's sign apart now and then, and Adam's first step turns that into
up to 2 lr, untuned or not. Weights come from the JAX package
(``params_from_jax``), tokens from numpy with a fixed seed; f32 on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import cache_descs as jax_cache_descs  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import param_descs as jax_param_descs  # noqa: E402
from repro.models.params import is_desc as jax_is_desc  # noqa: E402
from repro.models.tuning import Tuning as JaxTuning  # noqa: E402
from repro.models.tuning import tuning as jax_tuning  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.launch import make_step, make_train_step  # noqa: E402
from repro_torch.models import tuning  # noqa: E402
from repro_torch.models.tuning import Tuning, get_tuning  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

B, S = 4, 16
LR = 1e-3
CFG = get_config("yi_6b", smoke=True)
PORT_CFG = port_get_config("yi_6b", smoke=True)
#: the softcap case: no published config sets logit_softcap
SOFTCAP_CFG = dataclasses.replace(CFG, logit_softcap=30.0)
PORT_SOFTCAP_CFG = dataclasses.replace(PORT_CFG, logit_softcap=30.0)


@pytest.fixture(scope="module")
def setup():
    jp = jax_init_params(jax_param_descs(CFG), jax.random.key(0), jnp.float32)
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(1).integers(0, CFG.vocab_size, (B, S + 1)).astype(np.int32)
    return jp, tp, {"tokens": tokens}


def _port(setup, cfg=PORT_CFG, remat="none", **tune):
    _, tp, batch = setup
    with tuning(**tune):
        p2, _, loss = make_train_step(cfg, AdamWConfig(lr=LR), remat=remat)(
            tp, adamw_init(tp), batch)
    return float(loss), [t.numpy() for t in tree_flatten(p2)[0]]


def _jax(setup, cfg=CFG, remat="none", **tune):
    jp, _, batch = setup
    with jax_tuning(**tune):
        p2, _, loss = jax.jit(jax_make_train_step(cfg, JaxAdamWConfig(lr=LR), remat=remat))(
            jp, jax_adamw_init(jp), batch)
    return float(loss), [np.asarray(x) for x in jax.tree_util.tree_leaves(p2)]


def _max_diff(a, b) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _check_against_jax(port, ref):
    assert abs(port[0] - ref[0]) < 1e-4
    diffs = np.concatenate([np.abs(x - y).ravel() for x, y in zip(port[1], ref[1])])
    assert diffs.max() <= 2 * LR and diffs.mean() <= 1e-6


@pytest.fixture(scope="module")
def untuned(setup):
    return _port(setup)


def test_chunked_loss_matches_full(setup, untuned):
    got = _port(setup, loss_chunk=4)
    assert abs(got[0] - untuned[0]) < 1e-4
    assert _max_diff(got[1], untuned[1]) < 1e-4
    _check_against_jax(got, _jax(setup, loss_chunk=4))


def test_chunked_loss_falls_back_when_the_chunk_does_not_divide(setup, untuned):
    got = _port(setup, loss_chunk=5)  # 16 % 5 != 0: the full loss
    assert abs(got[0] - untuned[0]) < 1e-6
    assert _max_diff(got[1], untuned[1]) < 1e-6


def test_microbatch_matches_full(setup, untuned):
    got = _port(setup, microbatch=2)
    assert abs(got[0] - untuned[0]) < 1e-4
    # Adam at step 1 behaves like sign(g): reassociating the microbatch sum
    # flips near-zero grads, so post-update params are compared at the scale
    # of one lr step, as the reference's test does
    assert _max_diff(got[1], untuned[1]) < 2e-3
    _check_against_jax(got, _jax(setup, microbatch=2))


def test_microbatch_skipped_when_it_does_not_divide_the_batch(setup, untuned):
    got = _port(setup, microbatch=3)  # 4 % 3 != 0: one batch
    assert got[0] == untuned[0] and _max_diff(got[1], untuned[1]) == 0.0


def test_constrain_activations_is_noop_numerically(setup, untuned):
    got = _port(setup, constrain_activations=True)
    assert abs(got[0] - untuned[0]) < 1e-5
    _check_against_jax(got, _jax(setup, constrain_activations=True))


def test_tuning_flags_are_the_references_less_moe_impl():
    # every flag of the reference's, moe_impl among them since the MoE
    # layers that read it are ported (tests/test_torch_moe.py)
    want = {f.name: f.default for f in dataclasses.fields(JaxTuning)}
    assert {f.name: f.default for f in dataclasses.fields(Tuning)} == want


def test_tuning_context_restores_the_previous_flags():
    base = get_tuning()
    with tuning(loss_chunk=8) as t:
        assert t.loss_chunk == 8 and get_tuning() is t
        with tuning(microbatch=2):
            assert get_tuning().loss_chunk == 8 and get_tuning().microbatch == 2
        assert get_tuning().microbatch == 1
    assert get_tuning() is base and base == tm.Tuning()


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_policies_match_none(setup, untuned, remat):
    got = _port(setup, remat=remat)
    # recomputing a block on the CPU gives the same values: the same loss
    # and params as keeping every activation
    assert got[0] == untuned[0] and _max_diff(got[1], untuned[1]) == 0.0
    _check_against_jax(got, _jax(setup, remat=remat))


class _CountProducts(TorchDispatchMode):
    """Counts the ``bmm`` calls of a step: of batch 1 (torch.einsum's weight
    products x.W) and batched (attention's per-(batch, head) products)."""

    def __init__(self):
        super().__init__()
        self.weight = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            if args[0].shape[0] == 1:
                self.weight += 1
            else:
                self.batched += 1
        return func(*args, **(kwargs or {}))


def _products(setup, remat):
    _, tp, batch = setup
    step = make_train_step(PORT_CFG, AdamWConfig(lr=LR), remat=remat)
    with _CountProducts() as count:
        step(tp, adamw_init(tp), batch)
    return count.weight, count.batched


def test_remat_dots_keeps_the_weight_products(setup):
    """"dots" recomputes attention's two per-head products of every layer in
    the backward pass and none of the weight products, which it keeps;
    "full" recomputes both kinds (up to the last product a block's backward
    needs: PyTorch stops a recompute early)."""
    none, dots, full = (_products(setup, r) for r in ("none", "dots", "full"))
    recomputed_batched = 2 * PORT_CFG.num_layers  # q.k and p.v
    assert dots == (none[0], none[1] + recomputed_batched)
    assert full[1] == dots[1] and full[0] > none[0]


def test_remat_rejects_an_unknown_policy(setup):
    with pytest.raises(ValueError, match="remat policy"):
        _port(setup, remat="everything")


def test_make_step_builds_each_kind(setup, untuned):
    _, tp, batch = setup
    with torch.no_grad():
        want = tm.forward(PORT_CFG, tp, torch.as_tensor(batch["tokens"]))[0]
    last = make_step(PORT_CFG, "prefill")(tp, batch)
    torch.testing.assert_close(last, want[:, -1:], rtol=0, atol=1e-6)
    cache = tm.zeros_from_descs(tm.cache_descs(PORT_CFG, B, 8), device="cpu")
    logits, new = make_step(PORT_CFG, "decode")(tp, cache, {"tokens": batch["tokens"][:, :1]}, 0)
    assert new is cache and logits.shape == (B, 1, PORT_CFG.vocab_padded)
    _, _, loss = make_step(PORT_CFG, "train", remat="none")(tp, adamw_init(tp), batch)
    assert float(loss) == untuned[0]
    with pytest.raises(ValueError):
        make_step(PORT_CFG, "eval")


# --------------------------------------------------------------------------- #
# decode_seq_constraint: the grouped flash-decode einsum                       #
# --------------------------------------------------------------------------- #
def _roll_port(cfg, tp, flag, steps=4):
    cache = tm.zeros_from_descs(tm.cache_descs(cfg, batch=2, max_len=8), device="cpu")
    tok = torch.ones((2, 1), dtype=torch.int32)
    outs = []
    with tuning(decode_seq_constraint=flag), torch.no_grad():
        for i in range(steps):
            logits, cache = tm.decode_step(cfg, tp, cache, tok, i)
            outs.append(logits.numpy())
    return np.stack(outs)


def _roll_jax(cfg, jp, flag, steps=4):
    cache = jax.tree_util.tree_map(lambda d: jnp.zeros(d.shape, jnp.float32),
                                   jax_cache_descs(cfg, batch=2, max_len=8), is_leaf=jax_is_desc)
    tok = jnp.ones((2, 1), jnp.int32)
    outs = []
    with jax_tuning(decode_seq_constraint=flag):
        step = jax.jit(lambda p, c, t, i: jax_decode_step(cfg, p, c, t, i))
        for i in range(steps):
            logits, cache = step(jp, cache, tok, jnp.asarray(i, jnp.int32))
            outs.append(np.asarray(logits))
    return np.stack(outs)


@pytest.mark.parametrize("softcap", [False, True])
def test_flash_decode_path_matches_baseline(setup, softcap):
    jp, tp, _ = setup
    cfg, tcfg = (SOFTCAP_CFG, PORT_SOFTCAP_CFG) if softcap else (CFG, PORT_CFG)
    base, grouped = _roll_port(tcfg, tp, False), _roll_port(tcfg, tp, True)
    np.testing.assert_allclose(grouped, base, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(grouped, _roll_jax(cfg, jp, True), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------- #
# the attention logit softcap                                                  #
# --------------------------------------------------------------------------- #
def test_softcap_forward_and_train_step_match_reference(setup):
    jp, tp, batch = setup
    tok = batch["tokens"]
    want, _, _ = jax_forward(SOFTCAP_CFG, jp, tok[:, :-1])
    want = np.asarray(want)
    with torch.no_grad():
        got = tm.forward(PORT_SOFTCAP_CFG, tp, torch.from_numpy(tok[:, :-1]))[0].numpy()
        plain = tm.forward(PORT_CFG, tp, torch.from_numpy(tok[:, :-1]))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # the cap bites: tanh(l / 30) * 30 differs from l where |l| is large
    assert np.abs(got - plain).max() > 1e-3
    _check_against_jax(_port(setup, cfg=PORT_SOFTCAP_CFG), _jax(setup, cfg=SOFTCAP_CFG))
