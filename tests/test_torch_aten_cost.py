"""The port's per-device cost counter (``analysis/aten_cost.py``) and its
SPMD rules (``parallel/spmd.py``), against hand counts, against the JAX
package's ring factors, and against single-device results.

  * ring factors: the reference's ``collective_wire_bytes`` on
    tests/test_analysis.py's HLO string equals the port's on the same
    ``(kind, bytes, group)`` records, exactly;
  * the counter is per device: a TP einsum pair on a fake 16 x 16 mesh
    counts 2^39 dot FLOP on one rank, not the global 2^47 (nor 2^47 + 2^39,
    which a counter that saw DTensor's sharding propagation would give on a
    cold cache), and the same cell traced twice counts the same;
  * one TP MLP block costs exactly one all-reduce of B_local * S * D * 4 bytes;
  * the count at full depth equals the reference's two-point extrapolation
    (``scaled_pair`` / ``extrapolate``) in dot flops, exactly: the port loops
    over layers, so each layer is counted once;
  * the partitioning computes the right values: four ``gloo`` ranks
    (``torch.multiprocessing.spawn``, ``file://`` rendezvous under
    ``tmp_path``) run the smoke config of every architecture (each family:
    dense, local/global, MoE, MLA, SSM, hybrid, encdec with its frames, vlm
    with its image embeddings and non-zero gates) under ``spmd(mesh)`` on a
    (data, model) = (2, 2) mesh with the production rules: the forward with the prefill profile (tokens sharded over batch
    and sequence) within 1e-5 of max |logit| of the single-device forward,
    the loss and every gradient with the train profile within 1e-6 relative
    (its f32 cross-entropy rounds differently), and three decode steps into
    a sequence-sharded cache within 1e-5. The models run in float64: the
    random smoke gemma models amplify f32 rounding past 1e-5 over a few
    layers, and the test is of the partitioning, not of f32 arithmetic;
    the same three checks on a (1, 4) mesh where "model" does not divide
    the heads (yi-6b's smoke with 6 query and 2 kv heads) and through the
    SSD rules (mamba2 and zamba2);
  * ``spmd`` refuses to nest and restores what it patched; an index outside
    the indexed dim raises, as torch's own indexing does, on a DTensor too.

Every fake or gloo process group is created in a fixture and destroyed in it.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402

from repro.analysis.hlo import collective_wire_bytes as ref_wire_bytes  # noqa: E402
from repro.analysis.hlo import parse_collectives  # noqa: E402
from repro_torch.analysis.aten_cost import OpCounter, collective_wire_bytes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.dryrun import _trace_cell, extrapolate, scaled_pair  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.layers import mlp  # noqa: E402
from repro_torch.parallel.spmd import spmd  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _hlo_of_test_analysis() -> str:
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and [t.id for t in node.targets] == ["HLO"]:
            return ast.literal_eval(node.value)
    raise LookupError("tests/test_analysis.py has no HLO string")


def test_ring_factors_equal_the_references():
    hlo = _hlo_of_test_analysis()
    records = parse_collectives(hlo)
    assert len(records) == 5
    assert collective_wire_bytes(records) == ref_wire_bytes(hlo)
    assert collective_wire_bytes([("all-reduce", 1 << 20, 1)]) == {"total": 0}


@pytest.fixture
def fake_world(request):
    """A fake process group of ``request.param`` ranks (256 or 4), destroyed
    on teardown; yields its production mesh (256) or a (2, 2) host mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = request.param
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield (make_production_mesh(device_type="cpu") if world == 256
               else make_host_mesh(model=2, device_type="cpu"))
    finally:
        dist.destroy_process_group()


def _fake_dtensor(fake, mesh, shape, placements, dtype=torch.float32):
    with fake:
        return distribute_tensor(torch.empty(shape, dtype=dtype), mesh, placements,
                                 src_data_rank=None)


@pytest.mark.parametrize("fake_world", [256], indirect=True)
def test_counter_is_per_device_and_stable(fake_world):
    """x (B, D) over "data", W1 (D, F) and W2 (F, D) over "model", a gelu
    between: 2^47 dot FLOP in all, 2^39 on one of 256 ranks, and one gelu
    output element per local element. The counter is entered outside the
    fake mode, where DTensor's propagation of the gelu at global shapes
    would reach it; the shapes are this test's own, so the propagation
    cache is cold on the first trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = fake_world
    B, D, F = 2 ** 15, 2 ** 14, 2 ** 16
    fake = FakeTensorMode()
    x = _fake_dtensor(fake, mesh, (B, D), [Shard(0), Replicate()])
    w1 = _fake_dtensor(fake, mesh, (D, F), [Replicate(), Shard(1)])
    w2 = _fake_dtensor(fake, mesh, (F, D), [Replicate(), Shard(0)])
    counts = []
    for _ in range(2):
        with OpCounter() as c, fake, spmd(mesh):
            h = torch.nn.functional.gelu(torch.einsum("bd,df->bf", x, w1))
            y = torch.einsum("bf,fd->bd", h, w2)
        assert tuple(y.placements) == (Shard(0), Replicate())
        counts.append((c.dot_flops, c.elementwise_flops, c.bytes_accessed, c.collectives))
    assert 4 * B * D * F == 2 ** 47
    assert counts[0][:2] == (2 ** 39, (B // 16) * (F // 16))
    assert counts[0] == counts[1]
    assert counts[0][3] == [("all-reduce", B // 16 * D * 4, 16)]


@pytest.mark.parametrize("fake_world", [256], indirect=True)
def test_one_tp_mlp_block_is_one_all_reduce(fake_world):
    """gemma-2b's MLP (D 2048, F 16384) on 16 x 4096 local tokens: the
    gated products are column-parallel, the down product row-parallel, and
    its partial sum is all-reduced once over the 16 ranks of "model"."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = fake_world
    cfg = get_config("gemma_2b")
    B, S, D, F = 256, 4096, cfg.d_model, cfg.d_ff
    fake = FakeTensorMode()
    x = _fake_dtensor(fake, mesh, (B, S, D), [Shard(0), Replicate()])
    p = {"wi_gate": _fake_dtensor(fake, mesh, (D, F), [Replicate(), Shard(1)]),
         "wi_up": _fake_dtensor(fake, mesh, (D, F), [Replicate(), Shard(1)]),
         "wo": _fake_dtensor(fake, mesh, (F, D), [Replicate(), Shard(0)])}
    with fake, spmd(mesh), OpCounter() as c:
        y = mlp(p, x, cfg.activation)
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert c.collectives == [("all-reduce", (B // 16) * S * D * 4, 16)]
    assert c.dot_flops == 3 * 2 * (B // 16) * S * D * (F // 16)


@pytest.mark.parametrize("fake_world", [4], indirect=True)
def test_full_depth_count_equals_the_two_point_extrapolation(fake_world):
    """yi-6b at full width, prefill 4 x 512 on a (2, 2) fake mesh: the count
    at 32 layers equals extrapolate(2 layers, 4 layers, 15) in dot flops,
    exactly; a propagation double count or a depth-dependent plan would
    break the equality."""
    cfg = get_config("yi_6b")
    shape = ShapeConfig("prefill_512", "prefill", 512, 4)
    small, large, extra = scaled_pair(cfg)
    assert (small.num_layers, large.num_layers, extra) == (2, 4, 15)
    dots = {}
    for name, c in (("full", cfg), ("small", small), ("large", large)):
        counter, _, _ = _trace_cell(c, shape, fake_world, "full")
        dots[name] = {"dot flops": float(counter.dot_flops)}
    assert extrapolate(dots["small"], dots["large"], extra) == dots["full"]
    assert dots["large"]["dot flops"] > dots["small"]["dot flops"] > 0


@pytest.mark.parametrize("fake_world", [4], indirect=True)
def test_spmd_does_not_nest_and_restores_what_it_patched(fake_world):
    from torch.distributed.tensor import DTensor

    before = (torch.einsum, torch.logsumexp, torch.softmax,
              vars(DTensor).get("__getitem__"), vars(DTensor).get("__setitem__"))
    with spmd(fake_world):
        assert torch.einsum is not before[0]
        with pytest.raises(RuntimeError, match="already open"):
            with spmd(fake_world):
                pass
        assert torch.einsum is not before[0]
    assert (torch.einsum, torch.logsumexp, torch.softmax, vars(DTensor).get("__getitem__"),
            vars(DTensor).get("__setitem__")) == before


@pytest.mark.parametrize("fake_world", [4], indirect=True)
@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("bad", [-1, 8])
def test_an_index_out_of_range_raises_on_a_dtensor(fake_world, sharded, bad):
    """The indexed dim (8 rows) replicated or sharded over "model": an index
    outside [0, 8) raises instead of being clamped or masked to zero."""
    x = distribute_tensor(torch.arange(32.0).reshape(8, 4), fake_world,
                          [Replicate(), Shard(0) if sharded else Replicate()],
                          src_data_rank=None)
    with spmd(fake_world), pytest.raises(IndexError, match="out of range"):
        x[torch.tensor([0, bad])]


# --------------------------------------------------------------------------- #
# four gloo ranks against one device                                           #
# --------------------------------------------------------------------------- #
#: every family: dense, local/global, MoE, MLA + MoE, SSM, hybrid, encdec, vlm
ARCHS = ("gemma_2b", "yi_6b", "gemma3_4b", "granite_moe_3b_a800m", "deepseek_v2_lite_16b",
         "mamba2_370m", "zamba2_1p2b", "seamless_m4t_large_v2", "llama_3p2_vision_90b")
_RANKS = r'''
import dataclasses, json, os, sys
import numpy as np
import torch, torch.distributed as dist, torch.multiprocessing as mp


def rank_main(rank, out, world):
    torch.set_num_threads(1)
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import (PDesc, cache_descs, decode_step, forward, lm_loss,
                                    param_descs, shape_by_name)
    from repro_torch.parallel.sharding import profile_for, tree_shardings
    from repro_torch.parallel.spmd import spmd
    from repro_torch.tree import tree_flatten, tree_unflatten

    dist.init_process_group("gloo", init_method=f"file://{out}/rdv", rank=rank,
                            world_size=world)
    try:
        # argv[3]: the "model" mesh size (2 unless given); argv[4]: per name,
        # the architecture and the config fields that replace its smoke ones
        mesh = make_host_mesh(model=int(sys.argv[3]) if len(sys.argv) > 3 else 2,
                              device_type="cpu")
        over = json.loads(sys.argv[4]) if len(sys.argv) > 4 else {}
        inp = np.load(os.path.join(out, "inputs.npz"))
        res = {}

        def placed(tree, descs, prof):
            pls = []

            def walk(d, p):
                if isinstance(d, dict):
                    for k in sorted(d):
                        walk(d[k], p[k])
                else:
                    pls.append(p)

            walk(descs, tree_shardings(descs, prof, mesh))
            leaves, td = tree_flatten(tree)
            return tree_unflatten(td, [distribute_tensor(t, mesh, list(p), src_data_rank=None)
                                       for t, p in zip(leaves, pls)])

        for arch in sys.argv[2].split(","):
            base, fields = over.get(arch, (arch, {}))
            cfg = dataclasses.replace(get_config(base, smoke=True), **fields)
            descs = param_descs(cfg)
            n = len(tree_flatten(descs)[0])
            params = tree_unflatten(tree_flatten(descs)[1],
                                    [torch.from_numpy(inp[f"{arch}/p/{i}"]) for i in range(n)])
            tokens = torch.from_numpy(inp[f"{arch}/tokens"])
            B, S = tokens.shape[0], tokens.shape[1] - 1
            tok = lambda t, prof, axes: placed({"t": t}, {"t": PDesc(tuple(t.shape), axes)},
                                               prof)["t"]
            xs = {k.rsplit("/", 1)[1]: torch.from_numpy(inp[k]) for k in inp.files
                  if k.startswith(f"{arch}/x/")}
            ext = lambda prof: {k: tok(v, prof, ("batch", None, None)) for k, v in xs.items()}
            prof = profile_for(cfg, shape_by_name("prefill_32k"), mesh)
            with spmd(mesh), torch.no_grad():
                logits = forward(cfg, placed(params, descs, prof),
                                 tok(tokens[:, :S], prof, ("batch", "seq")), extras=ext(prof))[0]
            res[f"{arch}/logits"] = logits.full_tensor().numpy()

            prof = profile_for(cfg, shape_by_name("train_4k"), mesh)
            leaves, td = tree_flatten(placed(params, descs, prof))
            leaves = [p.detach().requires_grad_(True) for p in leaves]
            with spmd(mesh):
                hid, _, aux = forward(cfg, tree_unflatten(td, leaves),
                                      tok(tokens[:, :S], prof, ("batch", "seq")), remat="full",
                                      extras=ext(prof))
                loss = lm_loss(cfg, hid, tok(tokens[:, 1:], prof, ("batch", "seq")), aux)
                grads = torch.autograd.grad(loss, leaves)
            res[f"{arch}/loss"] = loss.full_tensor().detach().numpy()
            for i, g in enumerate(grads):
                res[f"{arch}/g{i}"] = g.full_tensor().numpy()

            prof = profile_for(cfg, shape_by_name("decode_32k"), mesh)
            cd = cache_descs(cfg, batch=B, max_len=S)
            cache = placed(tree_unflatten(tree_flatten(cd)[1],
                                          [torch.zeros(d.shape, dtype=torch.float64)
                                           for d in tree_flatten(cd)[0]]), cd, prof)
            p, x = placed(params, descs, prof), ext(prof)
            with spmd(mesh), torch.no_grad():
                for i in range(3):
                    lg, cache = decode_step(cfg, p, cache, tok(tokens[:, i:i + 1], prof,
                                                               ("batch", None)), i, extras=x)
            res[f"{arch}/decode"] = lg.full_tensor().numpy()
            for j, c in enumerate(tree_flatten(cache)[0]):
                res[f"{arch}/cache{j}"] = c.full_tensor().numpy()
        if rank == 0:
            np.savez(os.path.join(out, "ranks.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1], 4), nprocs=4)
    print("SPMD-RANKS-OK")
'''


#: smoke configs whose sharded dims do not divide "model" = 4 on a (1, 4)
#: mesh: 6 query heads (replicated) over 2 kv heads (sharded unevenly, as
#: GSPMD shards them 2-way), and the SSD families (B/C, dt and the heads
#: sharded with the conv split per part): name -> (architecture, fields)
UNEVEN = {"yi_6b_6q2kv": ("yi_6b", {"num_heads": 6, "num_kv_heads": 2, "head_dim": 16}),
          "mamba2_370m": ("mamba2_370m", {}), "zamba2_1p2b": ("zamba2_1p2b", {})}


def _smoke(name):
    import dataclasses

    base, fields = UNEVEN.get(name, (name, {}))
    return dataclasses.replace(get_config(base, smoke=True), **fields)


def _run_ranks(out, names, model=2):
    """Seeded float64 params, tokens and extras per name (the vlm's gates
    seeded non-zero, as they are 0 at init), and the four ranks' results on
    a ("data", "model") = (4 / model, model) mesh (rank 0's gathered
    tensors)."""
    import json

    from repro_torch.models import init_params, param_descs
    from repro_torch.tree import tree_flatten

    inputs = {}
    rng = np.random.default_rng(7)
    for seed, arch in enumerate(names):
        cfg = _smoke(arch)
        params = init_params(param_descs(cfg), torch.Generator().manual_seed(seed),
                             dtype=torch.float64, device="cpu")
        if cfg.family == "vlm":
            cross = params["group_cross"]
            for holder, key in ((cross["attn"], "gate"), (cross, "mlp_gate")):
                holder[key] = torch.from_numpy(rng.uniform(0.5, 1.5, holder[key].shape)
                                               * rng.choice([-1.0, 1.0], holder[key].shape))
        if cfg.family in ("encdec", "vlm"):
            n = cfg.source_len if cfg.family == "encdec" else cfg.num_image_tokens
            key = "frames" if cfg.family == "encdec" else "image_embeds"
            inputs[f"{arch}/x/{key}"] = rng.standard_normal((4, n, cfg.d_model)) * 0.1
        for i, leaf in enumerate(tree_flatten(params)[0]):  # in flatten order
            inputs[f"{arch}/p/{i}"] = leaf.numpy()
        inputs[f"{arch}/tokens"] = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int64)
    np.savez(out / "inputs.npz", **inputs)
    (out / "ranks.py").write_text(_RANKS)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    over = {n: UNEVEN[n] for n in names if n in UNEVEN}
    run = subprocess.run([sys.executable, str(out / "ranks.py"), str(out), ",".join(names),
                          str(model), json.dumps(over)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))
    assert "SPMD-RANKS-OK" in run.stdout, run.stderr[-4000:]
    return inputs, dict(np.load(out / "ranks.npz"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every architecture's smoke config on a (2, 2) mesh (``_run_ranks``)."""
    return _run_ranks(tmp_path_factory.mktemp("spmd4"), ARCHS)


@pytest.fixture(scope="module")
def four_ranks_uneven(tmp_path_factory):
    """The ``UNEVEN`` configs on a (1, 4) mesh (``_run_ranks``)."""
    return _run_ranks(tmp_path_factory.mktemp("spmd4u"), list(UNEVEN), model=4)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-300))


def _single_device(arch, inputs):
    from repro_torch.models import param_descs
    from repro_torch.tree import tree_flatten, tree_unflatten

    cfg = _smoke(arch)
    descs = param_descs(cfg)
    leaves, td = tree_flatten(descs)
    params = tree_unflatten(td, [torch.from_numpy(inputs[f"{arch}/p/{i}"])
                                 for i in range(len(leaves))])
    extras = {k.rsplit("/", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
              if k.startswith(f"{arch}/x/")}
    return cfg, params, torch.from_numpy(inputs[f"{arch}/tokens"]), extras


@pytest.mark.parametrize("arch", ARCHS)
def test_four_gloo_ranks_forward_equals_one_device(four_ranks, arch):
    _check_forward(four_ranks, arch)


def _check_forward(four_ranks, arch):
    from repro_torch.models import forward

    inputs, ranks = four_ranks
    cfg, params, tokens, extras = _single_device(arch, inputs)
    with torch.no_grad():
        want = forward(cfg, params, tokens[:, :-1], extras=extras)[0]
    assert _rel(ranks[f"{arch}/logits"], want.numpy()) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_four_gloo_ranks_gradients_equal_one_device(four_ranks, arch):
    _check_gradients(four_ranks, arch)


def _check_gradients(four_ranks, arch):
    from repro_torch.models import forward, lm_loss
    from repro_torch.tree import tree_flatten, tree_unflatten

    inputs, ranks = four_ranks
    cfg, params, tokens, extras = _single_device(arch, inputs)
    leaves, td = tree_flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    hid, _, aux = forward(cfg, tree_unflatten(td, leaves), tokens[:, :-1], remat="full",
                          extras=extras)
    loss = lm_loss(cfg, hid, tokens[:, 1:], aux)
    grads = torch.autograd.grad(loss, leaves)
    assert _rel(ranks[f"{arch}/loss"], loss.detach().numpy()) <= 1e-6
    for i, g in enumerate(grads):
        assert _rel(ranks[f"{arch}/g{i}"], g.numpy()) <= 1e-6, i


@pytest.mark.parametrize("arch", ARCHS)
def test_four_gloo_ranks_decode_into_a_sharded_cache(four_ranks, arch):
    _check_decode(four_ranks, arch)


def _check_decode(four_ranks, arch):
    from repro_torch.models import cache_descs, decode_step, zeros_from_descs
    from repro_torch.tree import tree_flatten

    inputs, ranks = four_ranks
    cfg, params, tokens, extras = _single_device(arch, inputs)
    B, S = tokens.shape[0], tokens.shape[1] - 1
    cache = zeros_from_descs(cache_descs(cfg, batch=B, max_len=S), dtype=torch.float64,
                             device="cpu")
    with torch.no_grad():
        for i in range(3):
            lg, cache = decode_step(cfg, params, cache, tokens[:, i:i + 1], i, extras=extras)
    assert _rel(ranks[f"{arch}/decode"], lg.numpy()) <= 1e-5
    for j, c in enumerate(tree_flatten(cache)[0]):
        assert _rel(ranks[f"{arch}/cache{j}"], c.numpy()) <= 1e-5, j


@pytest.mark.parametrize("arch", list(UNEVEN))
@pytest.mark.parametrize("check", ["forward", "gradients", "decode"])
def test_four_gloo_ranks_with_dims_model_does_not_divide(four_ranks_uneven, arch, check):
    """On a (1, 4) mesh: 6 query heads and 2 kv heads (the kv products
    sharded unevenly, 2 of the 4 ranks holding a head, and gathered before
    the GQA repeat), and the SSD families' scans on their ranks' own heads;
    each against one device at the (2, 2) checks' tolerances."""
    {"forward": _check_forward, "gradients": _check_gradients,
     "decode": _check_decode}[check](four_ranks_uneven, arch)


def test_quad_probe_splits_the_attention_quadratic_bytes():
    """gemma-2b at prefill 32 x 32768 against 64 x 16384 on the production
    mesh: the plain attention's S^2 tensors are most, not all, of the bytes."""
    from repro_torch.analysis.quad_probe import quad_decompose

    out = quad_decompose("gemma-2b", "prefill_32k", device_type="cpu")
    assert 0.0 < out["quad_fraction"] < 1.0
    assert 0.0 < out["memory_s_flash_adjusted"] < out["memory_s_plain"]
    assert out["roofline_fraction_flash_adjusted"] >= out["roofline_fraction_plain"]
    assert not dist.is_initialized()
