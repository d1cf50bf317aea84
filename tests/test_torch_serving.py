"""The port's serving path (decode caches, ``decode_step``, ``train/serve.py``)
against the JAX package.

Both sides start from the same weights: the JAX package initialises them and
``params_from_jax`` loads them into the port. Inputs come from numpy with a
fixed seed; everything runs in f32 on the CPU, at the gemma-2b and mamba2
smoke configurations. The JAX decode step runs jitted, as the reference's
serving loop runs it; it reaches no Pallas kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import cache_descs as jax_cache_descs  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import param_descs as jax_param_descs  # noqa: E402
from repro.models.layers import attention as jax_attention  # noqa: E402
from repro.models.params import is_desc as jax_is_desc  # noqa: E402
from repro.train.serve import run_speculative_serving as jax_run_speculative_serving  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.models.layers import attention as port_attention  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.train import DecodeSessionStateObject, run_speculative_serving  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

ARCHS = ["gemma_2b", "mamba2_370m"]
#: logits of magnitude ~1-4 after a few layers of f32 sums in another order,
#: as tests/test_torch_model.py holds the forwards
TOL = 1e-4
MAX_LEN = 64
N_TOKENS = 10


@pytest.fixture(scope="module")
def setup():
    """Per architecture: the reference's config and params, the port's
    config and params, and the reference's jitted decode step."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        jp = jax_init_params(jax_param_descs(cfg), jax.random.key(0), dtype=jnp.float32)
        tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        step = jax.jit(lambda p, c, t, i, cfg=cfg: jax_decode_step(cfg, p, c, t, i))
        out[arch] = (cfg, jp, port_get_config(arch, smoke=True), tp, step)
    return out


def _jax_cache(cfg):
    return jax.tree_util.tree_map(lambda d: jnp.zeros(d.shape, jnp.float32),
                                  jax_cache_descs(cfg, batch=1, max_len=MAX_LEN),
                                  is_leaf=jax_is_desc)


def _port_cache(cfg):
    return tm.zeros_from_descs(tm.cache_descs(cfg, batch=1, max_len=MAX_LEN), device="cpu")


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n).astype(np.int32)


def _jax_decode(cfg, jp, step, feed):
    """Logits (len(feed), vocab_padded) and the final cache of the reference."""
    cache, logits = _jax_cache(cfg), []
    for i, t in enumerate(feed):
        lg, cache = step(jp, cache, jnp.asarray([[t]], jnp.int32), jnp.asarray(i, jnp.int32))
        logits.append(np.asarray(lg)[0, 0])
    return np.stack(logits), cache


def _port_decode(cfg, tp, feed):
    cache, logits = _port_cache(cfg), []
    with torch.no_grad():
        for i, t in enumerate(feed):
            lg, new = tm.decode_step(cfg, tp, cache, torch.tensor([[int(t)]], dtype=torch.int32), i)
            assert new is cache  # updated in place
            logits.append(lg[0, 0].numpy())
    return np.stack(logits), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_descs_match_reference(setup, arch):
    cfg, _, tcfg, _, _ = setup[arch]
    for batch, max_len in ((1, MAX_LEN), (3, 17)):
        j_leaves, _ = jax.tree_util.tree_flatten(jax_cache_descs(cfg, batch, max_len),
                                                 is_leaf=jax_is_desc)
        t_descs = tm.cache_descs(tcfg, batch, max_len)
        t_leaves = tree_flatten(t_descs)[0]
        assert all(tm.is_desc(d) for d in t_leaves)
        assert [(d.shape, d.axes, d.init) for d in t_leaves] == \
            [(d.shape, d.axes, d.init) for d in j_leaves]
        zeros = tree_flatten(tm.zeros_from_descs(t_descs, device="cpu"))[0]
        assert [tuple(z.shape) for z in zeros] == [d.shape for d in j_leaves]
        assert all(z.dtype == torch.float32 and not z.any() for z in zeros)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(setup, arch):
    cfg, jp, tcfg, tp, step = setup[arch]
    feed = _tokens(cfg, 8, seed=3)
    want, jcache = _jax_decode(cfg, jp, step, feed)
    got, tcache = _port_decode(tcfg, tp, feed)
    assert got.shape == (8, tcfg.vocab_padded)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the cached k/v and conv/SSM states reach |8|: held to TOL of the
    # largest magnitude of each leaf
    for g, w in zip(tree_flatten(tcache)[0], jax.tree_util.tree_leaves(jcache)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=TOL * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_equals_forward(setup, arch):
    """forward is causal: position i of one forward over T tokens sees only
    its prefix, which is what decode_step saw after i steps. For the ssm
    family T is a multiple of the smoke config's chunk of 8."""
    _, _, tcfg, tp, _ = setup[arch]
    feed = _tokens(tcfg, 16, seed=4)
    got, _ = _port_decode(tcfg, tp, feed)
    with torch.no_grad():
        want = tm.forward(tcfg, tp, torch.from_numpy(feed)[None])[0][0].numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _attn_inputs(cfg, steps, seed=5):
    rng = np.random.default_rng(seed)
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {"wq": rng.standard_normal((d, nq, hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, nkv, hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, nkv, hd)) / np.sqrt(d),
         "wo": rng.standard_normal((nq, hd, d)) / np.sqrt(nq * hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, steps, d)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("ring,window,smax", [
    (True, 3, 5),      # the ring of a local-attention layer, past two wrap-arounds
    (True, None, 5),
    (True, 5, 5),      # gemma3's ring: window-sized
    (False, 3, 12),
    (False, None, 12),
])
def test_attention_decode_cache_matches_reference(setup, ring, window, smax):
    cfg = setup["gemma_2b"][0]
    steps = 12
    p, x = _attn_inputs(cfg, steps)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    shape = (2, smax, cfg.num_kv_heads, cfg.resolved_head_dim)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for i in range(steps):
        pos = np.full((2, 1), i, np.int32)
        want, jc = jax_attention(jp, jnp.asarray(x[:, i: i + 1]), cfg, jnp.asarray(pos),
                                 window=window, cache=jc, cache_index=jnp.asarray(i, jnp.int32),
                                 ring=ring)
        got, new = port_attention(tp, torch.from_numpy(x[:, i: i + 1]), cfg,
                                  torch.from_numpy(pos), window=window, cache=tc,
                                  cache_index=i, ring=ring)
        assert new is tc
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("window", [3, None])
def test_attention_prefill_window_matches_reference(setup, window):
    cfg = setup["gemma_2b"][0]
    p, x = _attn_inputs(cfg, 12)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want, _ = jax_attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg,
                            jnp.asarray(pos), window=window)
    got, cache = port_attention({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), cfg, torch.from_numpy(pos.copy()),
                                window=window)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def reference_runs(setup, tmp_path_factory):
    """The reference's serving runs, failure-free and with a kill, per arch
    (twins of tests/test_serving.py)."""
    root = tmp_path_factory.mktemp("jax_serving")
    out = {}
    for arch in ARCHS:
        cfg, jp = setup[arch][:2]
        out[arch] = {kill: jax_run_speculative_serving(root / f"{arch}_{kill}", cfg, jp,
                                                       n_tokens=N_TOKENS, kill_at=kill)
                     for kill in (None, 5)}
    return out


@pytest.mark.parametrize("kill_at", [None, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference(setup, reference_runs, tmp_path, arch, kill_at):
    cfg, jp, tcfg, tp, step = setup[arch]
    ref = reference_runs[arch][kill_at]
    base = reference_runs[arch][None]
    assert ref.durable_tokens == base.durable_tokens and len(base.durable_tokens) == N_TOKENS
    res = run_speculative_serving(tmp_path / "s", tcfg, tp, n_tokens=N_TOKENS, kill_at=kill_at,
                                  device="cpu")
    assert res.tokens_generated == N_TOKENS
    assert res.rollbacks == (0 if kill_at is None else 1) == ref.rollbacks
    if res.durable_tokens != base.durable_tokens:
        # Greedy argmax can flip on a near-tie under f32 rounding: say whether
        # the first differing step is one, from the reference's own logits
        logits, _ = _jax_decode(cfg, jp, step, [0] + base.durable_tokens[:-1])
        first = next(i for i, (a, b) in enumerate(zip(res.durable_tokens, base.durable_tokens))
                     if a != b)
        top2 = np.sort(logits[first, : cfg.vocab_size])[-2:]
        pytest.fail(f"token {first} differs: port {res.durable_tokens}, reference "
                    f"{base.durable_tokens}; the reference's top-2 margin there is "
                    f"{top2[1] - top2[0]:.3e} against the logit tolerance {TOL} "
                    + ("(a near-tie)" if top2[1] - top2[0] <= TOL else "(not a tie)"))


def test_decode_step_refuses_what_it_cannot_do(setup):
    cfg, tp = setup["gemma_2b"][2:4]
    cache = _port_cache(cfg)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with torch.no_grad():
        # jax.lax.dynamic_update_slice would clamp these indices silently
        for bad in (MAX_LEN, MAX_LEN + 3, -1):
            with pytest.raises(ValueError, match=f"cache index {bad} does not fit"):
                tm.decode_step(cfg, tp, cache, tok, bad)
        assert not any(t.any() for t in tree_flatten(cache)[0])
        tm.decode_step(cfg, tp, cache, tok, MAX_LEN - 1)  # the last slot fits
    # every family of the reference is ported (the encdec and vlm ones in
    # tests/test_torch_encdec.py and test_torch_vlm.py); a family that
    # neither package has is refused by both
    other = dataclasses.replace(cfg, family="audio")
    with pytest.raises(ValueError, match="audio"):
        jax_cache_descs(other, 1, MAX_LEN)
    with pytest.raises(KeyError, match="audio"):
        jax_decode_step(other, {}, {}, jnp.zeros((1, 1), jnp.int32), jnp.asarray(0))
    with pytest.raises(ValueError, match="unknown model family 'audio'"):
        tm.cache_descs(other, 1, MAX_LEN)
    with pytest.raises(ValueError, match="unknown model family 'audio'"):
        tm.decode_step(other, tp, cache, tok, 0)
    with pytest.raises(ValueError, match="unknown model family 'audio'"):
        tm.forward(other, tp, tok)


def test_session_replays_its_tokens_into_the_cache(setup, tmp_path):
    """Restore's replay of [0] + tokens[:-1] rebuilds the cache that decoding
    those tokens built, for the ssm family's conv/state cache too."""
    cfg, tp = setup["mamba2_370m"][2:4]
    feed = [int(t) for t in _tokens(cfg, 6, seed=6)]
    _, want = _port_decode(cfg, tp, [0] + feed[:-1])
    so = DecodeSessionStateObject(tmp_path / "s", cfg, tp, max_len=MAX_LEN, device="cpu")
    so.tokens = feed
    so._rebuild_cache()
    for g, w in zip(tree_flatten(so._cache)[0], tree_flatten(want)[0]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_float64_model_stays_float64(setup):
    """The reference normalises and takes the softmax in f32; the port does
    so in at least f32, so a float64 model (chip_smoke.py's check of
    gemma-2b's decode) computes in float64 throughout."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)))
    w = torch.from_numpy(rng.standard_normal(64) * 0.1)
    want = x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) * (1 + w)
    got = rms_norm(x, w, 1e-6)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
    cfg, tp = setup["gemma_2b"][2:4]
    tp64 = tree_map(lambda t: t.double(), tp)
    feed = torch.from_numpy(_tokens(cfg, 16, seed=8))[None]
    cache = tm.zeros_from_descs(tm.cache_descs(cfg, 1, 16), torch.float64, device="cpu")
    with torch.no_grad():
        got = torch.cat([tm.decode_step(cfg, tp64, cache, feed[:, i: i + 1], i)[0]
                         for i in range(16)], dim=1)
        want = tm.forward(cfg, tp64, feed)[0]
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
