"""The port's multi-head latent attention (``models/layers.py::mla_attention``,
DeepSeek-V2) against the JAX package's, and the deepseek plan's caches.

Both sides start from the same weights: the JAX package initialises them and
``params_from_jax`` loads them into the port. Activations come from numpy
with a fixed seed; f32 on the CPU, at the deepseek-v2-lite smoke config
(kv_lora_rank 32, rope 8, nope 16, v 16, 4 heads), with its full-rank Q
(q_lora_rank 0, as V2-Lite) and with a low-rank Q branch (q_lora_rank 16).
Outputs are held to 1e-4 of their max |value|, the bound of
tests/test_torch_arch_smoke.py.
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
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.layers import mla_attention as jax_mla  # noqa: E402
from repro.models.layers import mla_descs as jax_mla_descs  # noqa: E402
from repro.models.params import is_desc as jax_is_desc  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.models.layers import mla_attention, mla_descs  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

TOL = 1e-4
B, S, MAX_LEN = 2, 12, 16


def _q_rank(cfg, rank):
    return dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, q_lora_rank=rank))


@pytest.fixture(scope="module", params=[0, 16], ids=["full_rank_q", "low_rank_q"])
def layer(request):
    cfg = _q_rank(get_config("deepseek_v2_lite_16b", smoke=True), request.param)
    tcfg = _q_rank(port_get_config("deepseek_v2_lite_16b", smoke=True), request.param)
    jp = jax_init_params(jax_mla_descs(cfg), jax.random.key(2), dtype=jnp.float32)
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


def _x(cfg, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def test_descs_match_reference(layer):
    cfg, tcfg, _, _ = layer
    j = jax_mla_descs(cfg)
    t = mla_descs(tcfg)
    assert sorted(t) == sorted(j)
    assert all((t[k].shape, t[k].axes, t[k].init) == (j[k].shape, j[k].axes, j[k].init)
               for k in j)
    assert ("w_dq" in t) == bool(tcfg.mla.q_lora_rank) == ("w_q" not in t)


def test_prefill_matches_reference(layer):
    cfg, tcfg, jp, tp = layer
    x = _x(cfg)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    want, cache = jax_mla(jp, jnp.asarray(x), cfg, jnp.asarray(pos))
    with torch.no_grad():
        got, tcache = mla_attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos.copy()))
    assert cache is None and tcache is None and got.shape == (B, S, cfg.d_model)
    _close(got.numpy(), want)


def _caches(cfg, tcfg):
    m = cfg.mla
    shapes = {"ckv": (B, MAX_LEN, m.kv_lora_rank), "kpe": (B, MAX_LEN, m.qk_rope_head_dim)}
    jc = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    tc = {k: torch.zeros(s) for k, s in shapes.items()}
    return jc, tc


def test_decode_and_compressed_cache_match_reference(layer):
    """S single-token steps from an empty cache on both sides: each step's
    output, and the cached latent ckv (B, Smax, R) and rope key kpe
    (B, Smax, P) written in place at the step's index; the decode equals
    the prefill position by position."""
    cfg, tcfg, jp, tp = layer
    x = _x(cfg, seed=1)
    jc, tc = _caches(cfg, tcfg)
    step = jax.jit(lambda p, xx, pos, c, i: jax_mla(p, xx, cfg, pos, cache=c, cache_index=i))
    outs = []
    with torch.no_grad():
        for i in range(S):
            pos = np.full((B, 1), i, np.int32)
            want, jc = step(jp, jnp.asarray(x[:, i: i + 1]), jnp.asarray(pos), jc,
                            jnp.asarray(i, jnp.int32))
            got, new = mla_attention(tp, torch.from_numpy(x[:, i: i + 1].copy()), tcfg,
                                     torch.from_numpy(pos), cache=tc, cache_index=i)
            assert new is tc
            _close(got.numpy(), want)
            outs.append(got)
        for k in ("ckv", "kpe"):
            _close(tc[k].numpy(), jc[k])
            assert not tc[k][:, S:].any()   # slots past the last step stay empty
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
        full, _ = mla_attention(tp, torch.from_numpy(x), tcfg, pos)
    _close(torch.cat(outs, dim=1).numpy(), full.numpy())


def test_decode_refuses_an_index_the_cache_cannot_hold(layer):
    _, tcfg, _, tp = layer
    _, tc = _caches(tcfg, tcfg)
    x = torch.zeros(B, 1, tcfg.d_model)
    with torch.no_grad():
        for bad in (MAX_LEN, -1):
            with pytest.raises(ValueError, match=f"cache index {bad} does not fit"):
                mla_attention(tp, x, tcfg, torch.full((B, 1), bad), cache=tc, cache_index=bad)
    assert not any(t.any() for t in tc.values())


def test_deepseek_plan_and_cache_layout_match_reference():
    """One dense MLA layer (d_ff ``dense_d_ff``), then MLA + MoE layers;
    the decode cache stacks the compressed ckv / kpe the same way."""
    cfg = get_config("deepseek_v2_lite_16b", smoke=True)
    tcfg = port_get_config("deepseek_v2_lite_16b", smoke=True)
    descs = tm.param_descs(tcfg)
    assert sorted(descs) == ["dense_layers", "embed", "lm_head", "ln_f", "moe_layers"]
    assert descs["dense_layers"]["mlp"]["wi_gate"].shape == (1, 64, 96)
    assert descs["moe_layers"]["moe"]["w_gate"].shape == (2, 4, 64, 32)
    assert descs["moe_layers"]["moe"]["shared"]["wi_gate"].shape == (2, 64, 32)
    j_leaves, _ = jax.tree_util.tree_flatten(jax_cache_descs(cfg, 2, MAX_LEN),
                                             is_leaf=jax_is_desc)
    t_descs = tm.cache_descs(tcfg, 2, MAX_LEN)
    assert [(d.shape, d.axes, d.init) for d in tree_flatten(t_descs)[0]] == \
        [(d.shape, d.axes, d.init) for d in j_leaves]
    assert t_descs["dense_layers"]["ckv"].shape == (1, 2, MAX_LEN, 32)
    assert t_descs["moe_layers"]["kpe"].shape == (2, 2, MAX_LEN, 8)
