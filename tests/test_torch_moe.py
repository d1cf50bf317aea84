"""The port's MoE layer (``models/layers.py::moe``, the GShard one-hot einsum
dispatch) against the JAX package's; tests/test_torch_moe_loop.py runs the
moe family's loop and serving path.

Both sides start from the same weights: the JAX package initialises them and
``params_from_jax`` loads them into the port. Activations and tokens come
from numpy with a fixed seed; f32 on the CPU, at the granite-moe and
deepseek-v2-lite smoke configs (4 experts, top 2; deepseek's with one shared
expert). Outputs and gradients are held to 1e-4 of their max |value|, the
bound of tests/test_torch_arch_smoke.py; the routing ids must be identical
(top-k is discontinuous: a flip would be a jump, not a rounding, and each
test prints the smallest gap between the k-th and (k+1)-th probability, so
a flip is recognisable for what it is).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.layers import moe as jax_moe  # noqa: E402
from repro.models.layers import moe_descs as jax_moe_descs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.models.layers import mlp, moe, route  # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: E402

ARCHS = ["granite_moe_3b_a800m", "deepseek_v2_lite_16b"]
TOL = 1e-4


def _with_capacity(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """One MoE layer's weights, the reference's and the port's configs."""
    cfg = get_config(request.param, smoke=True)
    jp = jax_init_params(jax_moe_descs(cfg), jax.random.key(1), dtype=jnp.float32)
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return cfg, port_get_config(request.param, smoke=True), jp, tp


def _x(cfg, batch, seq, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, seq, cfg.d_model)).astype(
        np.float32)


def _jax_ids(cfg, p, x, group_size=2048):
    """The reference's routing (layers.py:336-341): softmax of the f32
    router logits per token group, then ``jax.lax.top_k``."""
    B, S, D = x.shape
    tg = min(group_size, B * S)
    logits = jnp.einsum("gtd,de->gte", x.reshape(-1, tg, D), p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1]), np.asarray(probs)


def _port_ids(cfg, p, x, group_size=2048):
    B, S, D = x.shape
    tg = min(group_size, B * S)
    logits = torch.einsum("gtd,de->gte", x.reshape(-1, tg, D), p["router"]).float()
    return route(torch.softmax(logits, dim=-1), cfg.moe.top_k)[1].numpy()


def _min_gap(probs, k):
    top = -np.sort(-probs, axis=-1)
    return float((top[..., k - 1] - top[..., k]).min())


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def _drops(cfg, ids, tg):
    """(token, slot) assignments past their expert's capacity, counted in
    the (t, k) order of the dispatch."""
    capacity = int(np.ceil(tg * cfg.moe.top_k / cfg.moe.num_experts * cfg.moe.capacity_factor))
    flat = ids.reshape(ids.shape[0], -1)
    seen = [np.bincount(row, minlength=cfg.moe.num_experts) for row in flat]
    return int(sum(np.maximum(s - capacity, 0).sum() for s in seen))


def _check(cfg, tcfg, jp, tp, x, group_size=2048):
    want, aux_j = jax_moe(jp, jnp.asarray(x), cfg, group_size=group_size)
    with torch.no_grad():
        got, aux_t = moe(tp, torch.from_numpy(x), tcfg, group_size=group_size)
    ids_j, probs = _jax_ids(cfg, jp, jnp.asarray(x), group_size)
    ids_t = _port_ids(tcfg, tp, torch.from_numpy(x), group_size)
    print(f"{cfg.name} T={x.shape[0] * x.shape[1]}: smallest gap between the k-th and "
          f"(k+1)-th router probability {_min_gap(probs, cfg.moe.top_k):.3e}")
    np.testing.assert_array_equal(ids_t, ids_j)
    _close(got.numpy(), want)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5, atol=0)
    return ids_j


def test_moe_output_aux_and_routing_match_reference(layer):
    cfg, tcfg, jp, tp = layer
    x = _x(cfg, 2, 16)
    _check(cfg, tcfg, jp, tp, x)


def test_moe_gradients_match_reference(layer):
    """d/d(params, x) of sum(out * w) + aux: through the gates, the
    experts, the shared MLP and the aux loss."""
    cfg, tcfg, jp, tp = layer
    x = _x(cfg, 2, 16)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jax_moe(p, xx, cfg)
        return jnp.sum(out * w) + aux

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves, td = tree_flatten(tp)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe(tree_unflatten(td, leaves), xt, tcfg)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)) + aux, leaves + [xt])
    for got, want in zip(grads[:-1], jax.tree_util.tree_leaves(gp_j)):
        _close(got.numpy(), want)
    _close(grads[-1].numpy(), gx_j)


def test_moe_overflow_drops_follow_the_reference(layer):
    """capacity_factor 0.5: capacity ceil(32 x 2 / 4 x 0.5) = 8 slots per
    expert for 64 (token, slot) assignments, so some overflow and are
    dropped, in the (t, k) order of the exclusive cumsum."""
    cfg, tcfg, jp, tp = layer
    cfg, tcfg = _with_capacity(cfg, 0.5), _with_capacity(tcfg, 0.5)
    x = _x(cfg, 2, 16, seed=5)
    ids = _check(cfg, tcfg, jp, tp, x)
    assert _drops(cfg, ids, 32) > 0
    with torch.no_grad():
        got, _ = moe(tp, torch.from_numpy(x), tcfg)
        want = _loop_moe(tcfg, tp, torch.from_numpy(x))
    _close(got.numpy(), want.numpy())


def _loop_moe(cfg, p, x):
    """The dispatch written as a loop over tokens in (t, k) order, one
    group: each (token, slot) takes its expert's next free slot, or is
    dropped when the expert's ``capacity`` slots are taken."""
    mo = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf @ p["router"], dim=-1)
    out = torch.zeros_like(xf)
    capacity = int(np.ceil(xf.shape[0] * mo.top_k / mo.num_experts * mo.capacity_factor))
    used = [0] * mo.num_experts
    for t in range(xf.shape[0]):
        gates, ids = route(probs[t], mo.top_k)
        gates = gates / gates.sum()
        for g, e in zip(gates, ids.tolist()):
            if used[e] >= capacity:
                continue
            used[e] += 1
            h = torch.nn.functional.silu(xf[t] @ p["w_gate"][e]) * (xf[t] @ p["w_up"][e])
            out[t] += g * (h @ p["w_down"][e])
    out = out.reshape(x.shape)
    if mo.num_shared:
        out = out + mlp(p["shared"], x, cfg.activation)
    return out


def test_moe_token_groups_past_group_size(layer):
    """T = 48 > group_size 16: three groups, each routed and dispatched on
    its own (capacity from the group's 16 tokens)."""
    cfg, tcfg, jp, tp = layer
    x = _x(cfg, 3, 16, seed=6)
    _check(cfg, tcfg, jp, tp, x, group_size=16)


def test_moe_impl_ep_runs_the_einsum_dispatch(layer):
    """Without an EP mesh "ep" takes the einsum dispatch, as the reference
    does without ``get_ep_mesh()``: bit-identical (the EP route under a mesh
    is tests/test_torch_ep_moe.py's)."""
    _, tcfg, _, tp = layer
    x = torch.from_numpy(_x(tcfg, 2, 16))
    with torch.no_grad():
        base = moe(tp, x, tcfg)
        with tm.tuning(moe_impl="ep"):
            ep = moe(tp, x, tcfg)
    assert all(torch.equal(a, b) for a, b in zip(base, ep))


def test_route_breaks_ties_toward_the_lower_expert():
    """``jax.lax.top_k`` puts the lower index first among equal values; the
    port's stable sort does the same (``torch.topk`` gives no order)."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.2, 0.4, 0.0]], np.float32)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = route(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
