"""The port's expert-parallel MoE (``parallel/ep_moe.py`` through
``models/layers.py::moe`` under ``Tuning.moe_impl="ep"``) against the JAX
package's ``ep_moe`` and against the port's own einsum dispatch.

World of one (in this process, a ``gloo`` group with a ``file://``
rendezvous): the all-to-alls are identities and the capacity is the einsum
dispatch's, so EP equals the einsum dispatch, drops included.

Four ranks: one subprocess runs the reference on four placeholder CPU
devices (``XLA_FLAGS``, as tests/test_ep_moe.py does), one spawns four
``gloo`` ranks of the port (``torch.multiprocessing.spawn``, ``file://``
rendezvous under ``tmp_path``, one thread each); both read the same
numpy-made inputs and write ``.npz`` files that the tests compare, on
meshes (data, model) = (1, 4) and (2, 2):
  * y and aux equal the reference's EP on the same mesh, at the default
    capacity factor (slots drop), with 6 experts padded to 8, and with a
    sequence that 4 does not divide (every rank routes it whole);
  * at capacity factor 8.0 (nothing drops) the gradients equal the
    single-process einsum dispatch's for a fixed cotangent on y, and with
    the aux loss added they equal the reference EP's global gradients once
    the data ranks' gradients are averaged; every rank of a model group
    holds the same gradients;
  * whole granite-moe and deepseek-v2-lite smoke forwards under "ep" on
    (1, 4) equal the reference's under its EP mesh.
The layer weights come from numpy with the router drawn at the std of a
normal-init weight (1/sqrt(D)), so that top-k gaps are wide; the whole
forwards use the JAX package's init. Values are held to 1e-4 of each
tensor's max |value|, the bound of tests/test_torch_moe.py (f32 sums in
another order on each side).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import tuning  # noqa: E402
from repro_torch.models.layers import moe, moe_descs, route  # noqa: E402
from repro_torch.parallel import ep_moe as ep  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
#: the four-rank cases: arch, mesh (data, model), batch, seq, capacity factor
#: (None: the config's 1.25), num_experts (None: the config's 4), gradients
CASES = {
    "granite_1x4": ("granite_moe_3b_a800m", (1, 4), 2, 16, None, None, False),
    "granite_2x2": ("granite_moe_3b_a800m", (2, 2), 4, 16, None, None, False),
    "deepseek_1x4": ("deepseek_v2_lite_16b", (1, 4), 2, 16, None, None, False),
    "deepseek_2x2": ("deepseek_v2_lite_16b", (2, 2), 4, 16, None, None, False),
    "granite_pad6_1x4": ("granite_moe_3b_a800m", (1, 4), 2, 16, None, 6, False),
    "granite_seq6_1x4": ("granite_moe_3b_a800m", (1, 4), 1, 6, None, None, False),
    "grad_granite_1x4": ("granite_moe_3b_a800m", (1, 4), 2, 16, 8.0, None, True),
    "grad_deepseek_2x2": ("deepseek_v2_lite_16b", (2, 2), 4, 16, 8.0, None, True),
    "grad_granite_seq6_1x4": ("granite_moe_3b_a800m", (1, 4), 2, 6, 8.0, None, True),
}
#: whole smoke forwards under "ep": arch, mesh, batch, seq
FORWARDS = {
    "fwd_granite_1x4": ("granite_moe_3b_a800m", (1, 4), 2, 16),
    "fwd_deepseek_1x4": ("deepseek_v2_lite_16b", (1, 4), 2, 16),
}


def _cfg(arch, cf=None, n_exp=None, get=get_config):
    cfg = get(arch, smoke=True)
    over = {k: v for k, v in (("capacity_factor", cf), ("num_experts", n_exp)) if v}
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over)) if over else cfg


def _layer_inputs(name, case, seed):
    """Numpy-made weights (the router at a normal-init std), x and a
    cotangent on y for one layer case, keyed "<case>/..."."""
    arch, _, B, S, cf, n_exp, _ = case
    cfg = _cfg(arch, cf, n_exp)
    rng = np.random.default_rng(seed)
    out = {}
    for path, d in zip(*_flat_descs(moe_descs(cfg))):
        fan_in = d.shape[-2]
        out[f"{name}/p/{path}"] = (rng.standard_normal(d.shape) / np.sqrt(fan_in)).astype(np.float32)
    out[f"{name}/x"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    out[f"{name}/ct"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return out


def _flat_descs(tree, prefix=""):
    paths, leaves = [], []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            p, l = _flat_descs(v, f"{prefix}{k}/")
            paths += p
            leaves += l
        else:
            paths.append(prefix + k)
            leaves.append(v)
    return paths, leaves


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *parents, last = k.split("/")
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[last] = torch.from_numpy(np.array(v))
    return out


# --------------------------------------------------------------------------- #
# the reference on four placeholder devices                                    #
# --------------------------------------------------------------------------- #
_JAX = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses as dc
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import forward, init_params, param_descs
from repro.models.layers import moe
from repro.models.tuning import tuning
from repro.parallel.ep_moe import ep_mesh

out = sys.argv[1]
spec = json.load(open(os.path.join(out, "cases.json")))
inp = np.load(os.path.join(out, "inputs.npz"))


def cfg_of(arch, cf, n_exp):
    cfg = get_config(arch, smoke=True)
    over = {k: v for k, v in (("capacity_factor", cf), ("num_experts", n_exp)) if v}
    return dc.replace(cfg, moe=dc.replace(cfg.moe, **over)) if over else cfg


def nest(prefix):
    tree = {}
    for k in inp.files:
        if k.startswith(prefix):
            *parents, last = k[len(prefix):].split("/")
            d = tree
            for p in parents:
                d = d.setdefault(p, {})
            d[last] = jnp.asarray(inp[k])
    return tree


def flat(tree, prefix):
    return {prefix + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


res = {}
for name, (arch, mesh_shape, B, S, cf, n_exp, grads) in spec["cases"].items():
    cfg = cfg_of(arch, cf, n_exp)
    p, x = nest(name + "/p/"), jnp.asarray(inp[name + "/x"])
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"))
    with mesh, ep_mesh(mesh), tuning(moe_impl="ep"):
        y, aux = jax.jit(lambda p, x: moe(p, x, cfg))(p, x)
        res[name + "/y"], res[name + "/aux"] = np.asarray(y), np.asarray(aux)
        if grads:
            ct = jnp.asarray(inp[name + "/ct"])

            for part, loss in (("gy", lambda p, x: jnp.sum(moe(p, x, cfg)[0] * ct)),
                               ("ga", lambda p, x: moe(p, x, cfg)[1])):
                gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
                res.update(flat(gp, f"{name}/{part}/"))
                res[f"{name}/{part}/x"] = np.asarray(gx)
params = {}
for name, (arch, mesh_shape, B, S) in spec["forwards"].items():
    cfg = get_config(arch, smoke=True)
    p = init_params(param_descs(cfg), jax.random.key(3), jnp.float32)
    tokens = jnp.asarray(inp[name + "/tokens"])
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"))
    with mesh, ep_mesh(mesh), tuning(moe_impl="ep"):
        logits, _, aux = jax.jit(lambda p, t: forward(cfg, p, t))(p, tokens)
    res[name + "/logits"], res[name + "/aux"] = np.asarray(logits), np.asarray(aux)
    params.update(flat(p, name + "/"))
np.savez(os.path.join(out, "ref.npz"), **res)
np.savez(os.path.join(out, "params.npz"), **params)
print("JAX-EP-OK")
'''

# --------------------------------------------------------------------------- #
# the port on four gloo ranks                                                  #
# --------------------------------------------------------------------------- #
_RANKS = r'''
import dataclasses as dc
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def cfg_of(arch, cf, n_exp):
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    over = {k: v for k, v in (("capacity_factor", cf), ("num_experts", n_exp)) if v}
    return dc.replace(cfg, moe=dc.replace(cfg.moe, **over)) if over else cfg


def nest(flat, prefix, requires_grad=False):
    tree, leaves = {}, {}
    for k in sorted(flat):
        if k.startswith(prefix):
            key = k[len(prefix):]
            *parents, last = key.split("/")
            d = tree
            for p in parents:
                d = d.setdefault(p, {})
            d[last] = torch.from_numpy(np.array(flat[k])).requires_grad_(requires_grad)
            leaves[key] = d[last]
    return tree, leaves


def rank_main(rank, out, world):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import forward, tuning
    from repro_torch.models.layers import moe
    from repro_torch.parallel.ep_moe import ep_mesh

    dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rdzv"),
                            world_size=world, rank=rank)
    try:
        spec = json.load(open(os.path.join(out, "cases.json")))
        inp = dict(np.load(os.path.join(out, "inputs.npz")))
        params = dict(np.load(os.path.join(out, "params.npz")))
        meshes = {}
        for group, cases in (("cases", spec["cases"]), ("forwards", spec["forwards"])):
            for name, case in cases.items():
                (D, M), B = case[1], case[2]
                if M not in meshes:
                    meshes[M] = make_host_mesh(model=M, device_type="cpu")
                mesh = meshes[M]
                d = mesh.get_local_rank("data")
                rows = slice(d * B // D, (d + 1) * B // D)
                res = {}
                if group == "forwards":
                    cfg = cfg_of(case[0], None, None)
                    p, _ = nest(params, name + "/")
                    tokens = torch.from_numpy(inp[name + "/tokens"][rows])
                    with ep_mesh(mesh), tuning(moe_impl="ep"), torch.no_grad():
                        logits, _, aux = forward(cfg, p, tokens)
                    res["logits"], res["aux"] = logits.numpy(), aux.numpy()
                else:
                    arch, _, _, _, cf, n_exp, grads = case
                    cfg = cfg_of(arch, cf, n_exp)
                    p, leaves = nest(inp, name + "/p/", requires_grad=grads)
                    x = torch.from_numpy(inp[name + "/x"][rows]).requires_grad_(grads)
                    with ep_mesh(mesh), tuning(moe_impl="ep"):
                        y, aux = moe(p, x, cfg)
                    res["y"], res["aux"] = y.detach().numpy(), aux.detach().numpy()
                    if grads:
                        keys = sorted(leaves) + ["x"]
                        wrt = [leaves[k] for k in sorted(leaves)] + [x]
                        ct = torch.from_numpy(inp[name + "/ct"][rows])
                        gy = torch.autograd.grad(D * (y * ct).sum(), wrt, retain_graph=True)
                        ga = torch.autograd.grad(aux, wrt, allow_unused=True)
                        for k, a, b in zip(keys, gy, ga):
                            res["gy/" + k] = a.numpy()
                            res["ga/" + k] = np.zeros_like(a.numpy()) if b is None else b.numpy()
                np.savez(os.path.join(out, f"{name}_r{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1], 4), nprocs=4)
    print("TORCH-EP-OK")
'''


def _run(code: str, path: Path, out: Path, marker: str) -> None:
    path.write_text(code)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, str(path), str(out)], capture_output=True, text=True,
                         timeout=600, env=env, cwd=str(ROOT))
    assert marker in run.stdout, run.stderr[-4000:]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Runs the reference, then the port's four ranks, once for the module;
    returns (inputs, reference outputs, {case: [rank outputs]})."""
    out = tmp_path_factory.mktemp("ep4")
    inputs = {}
    for seed, (name, case) in enumerate(CASES.items()):
        inputs.update(_layer_inputs(name, case, seed))
    rng = np.random.default_rng(99)
    for name, (arch, _, B, S) in FORWARDS.items():
        vocab = get_config(arch, smoke=True).vocab_size
        inputs[f"{name}/tokens"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
    np.savez(out / "inputs.npz", **inputs)
    (out / "cases.json").write_text(json.dumps({"cases": CASES, "forwards": FORWARDS}))
    _run(_JAX, out / "ref_ep.py", out, "JAX-EP-OK")
    _run(_RANKS, out / "port_ep.py", out, "TORCH-EP-OK")
    ref = dict(np.load(out / "ref.npz"))
    ranks = {name: [dict(np.load(out / f"{name}_r{r}.npz")) for r in range(4)]
             for name in list(CASES) + list(FORWARDS)}
    return inputs, ref, ranks


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol} x max |want| {scale:.3e}"


def _coords(case):
    """Rank r -> (data, model) coordinates on make_host_mesh's mesh."""
    D, M = case[1]
    return [(r // M, r % M) for r in range(D * M)]


def _dropped(inputs, name, case):
    """(token, slot)s past their expert's capacity over all ranks' slices,
    by the port's routing (a property of the data, not a check of EP)."""
    arch, (D, M), B, S, cf, n_exp, _ = case
    cfg = _cfg(arch, cf, n_exp)
    x = torch.from_numpy(inputs[f"{name}/x"])
    router = torch.from_numpy(inputs[f"{name}/p/router"])
    n = 0
    for d, m in _coords(case):
        xs = x[d * B // D:(d + 1) * B // D]
        if S % M == 0:
            xs = xs[:, m * S // M:(m + 1) * S // M]
        xf = xs.reshape(-1, cfg.d_model)
        ids = route(torch.softmax(xf @ router, -1), cfg.moe.top_k)[1]
        cap = int(np.ceil(xf.shape[0] * cfg.moe.top_k / cfg.moe.num_experts
                          * cfg.moe.capacity_factor))
        counts = torch.bincount(ids.reshape(-1), minlength=cfg.moe.num_experts)
        n += int(torch.clamp(counts - cap, min=0).sum())
    return n


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if not c[-1]])
def test_four_rank_ep_matches_reference_ep(four_ranks, name):
    inputs, ref, ranks = four_ranks
    case = CASES[name]
    (D, M), B = case[1], case[2]
    if case[4] is None:
        assert _dropped(inputs, name, case) > 0, "the case should drop slots"
    for r, (d, m) in enumerate(_coords(case)):
        rows = slice(d * B // D, (d + 1) * B // D)
        _close(ranks[name][r]["y"], ref[f"{name}/y"][rows])
        _close(ranks[name][r]["aux"], ref[f"{name}/aux"])
        lead = ranks[name][d * M]
        assert np.array_equal(ranks[name][r]["y"], lead["y"])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[-1]])
def test_four_rank_ep_gradients(four_ranks, name):
    """y's part against the single-process einsum dispatch and against the
    reference EP's global gradient, the aux loss's part against the
    reference EP's (the einsum aux differs), each after the mean over the
    data ranks; every rank of a model group holds the same gradients."""
    inputs, ref, ranks = four_ranks
    arch, (D, M), B, S, cf, n_exp, _ = case = CASES[name]
    keys = [k[3:] for k in ranks[name][0] if k.startswith("gy/")]
    for r, (d, m) in enumerate(_coords(case)):
        for k in keys:
            for part in ("gy/", "ga/"):
                assert np.array_equal(ranks[name][r][part + k], ranks[name][d * M][part + k]), k

    cfg = _cfg(arch, cf, n_exp)
    p = _nest({k[len(name) + 3:]: v for k, v in inputs.items() if k.startswith(name + "/p/")})
    leaves, _ = tree_flatten(p)
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(inputs[f"{name}/x"]).requires_grad_(True)
    y, _ = moe(p, x, cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(inputs[f"{name}/ct"])).sum(), leaves + [x])
    einsum = dict(zip(_flat_descs(p)[0] + ["x"], grads))
    assert sorted(einsum) == sorted(keys)
    leads = [ranks[name][d * M] for d in range(D)]
    for k in keys:
        for part in ("gy", "ga"):
            if k == "x":  # each data rank's rows, over D (its loss is D x its share)
                got = np.concatenate([lead[f"{part}/x"] / D for lead in leads])
            else:  # the mean over the data ranks
                got = np.mean([lead[f"{part}/{k}"] for lead in leads], axis=0)
            if part == "gy":
                _close(got, einsum[k].numpy())
            _close(got, ref[f"{name}/{part}/{k}"])


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_four_rank_whole_forward_matches_reference(four_ranks, name):
    _, ref, ranks = four_ranks
    for r in range(4):
        _close(ranks[name][r]["logits"], ref[f"{name}/logits"])
        _close(ranks[name][r]["aux"], ref[f"{name}/aux"])
        assert np.array_equal(ranks[name][r]["logits"], ranks[name][0]["logits"])


# --------------------------------------------------------------------------- #
# a world of one, in this process                                              #
# --------------------------------------------------------------------------- #
@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv", world_size=1, rank=0)
    try:
        yield make_host_mesh(model=1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _layer(arch, cf=None, seed=0):
    from repro_torch.models import init_params

    cfg = _cfg(arch, cf)
    p = init_params(moe_descs(cfg), torch.Generator().manual_seed(seed), device="cpu")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    return cfg, p, x


def _spy(monkeypatch):
    calls = []
    real = ep.ep_moe

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ep, "ep_moe", spy)
    return calls


@pytest.mark.parametrize("cf", [None, 8.0])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_v2_lite_16b"])
def test_world_of_one_ep_equals_einsum(world_of_one, monkeypatch, arch, cf):
    """Same capacity and the same (t, k) drop order as the einsum dispatch
    (T = 32 <= group_size): equal within f32 rounding, at the default
    capacity factor too; the EP route was taken."""
    cfg, p, x = _layer(arch, cf)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        y0, aux0 = moe(p, x, cfg)
        with ep.ep_mesh(world_of_one), tuning(moe_impl="ep"):
            y1, aux1 = moe(p, x, cfg)
    assert calls == [1]
    _close(y1, y0)
    assert abs(float(aux1) - float(aux0)) <= TOL * abs(float(aux0))


def test_world_of_one_ep_gradients_flow(world_of_one):
    """Twin of tests/test_ep_moe.py::test_ep_gradients_flow, and the
    gradients equal the einsum dispatch's (capacity factor 8.0)."""
    cfg, p, x = _layer("granite_moe_3b_a800m", 8.0)
    leaves, _ = tree_flatten(p)

    def grads(**tune):
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        with ep.ep_mesh(world_of_one), tuning(**tune):
            torch.sum(moe(p, x, cfg)[0] ** 2).backward()
        return [t.grad.clone() for t in leaves]

    g_ep, g_einsum = grads(moe_impl="ep"), grads()
    gn = sum(float(g.abs().sum()) for g in g_ep)
    assert np.isfinite(gn) and gn > 0
    for a, b in zip(g_ep, g_einsum):
        _close(a, b)


def test_ep_route_needs_a_mesh(monkeypatch):
    """Without an EP mesh "ep" takes the einsum dispatch (ep_moe is never
    called), and ep_moe alone raises."""
    cfg, p, x = _layer("granite_moe_3b_a800m")
    calls = _spy(monkeypatch)
    assert ep.get_ep_mesh() is None
    with tuning(moe_impl="ep"), torch.no_grad():
        moe(p, x, cfg)
    assert calls == []
    with pytest.raises(RuntimeError, match="ep_mesh"):
        ep.ep_moe(p, x, cfg)
