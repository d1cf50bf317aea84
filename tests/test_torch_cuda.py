"""The port's CUDA kernels (delta codec, SSD, flash attention) against
their plain versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is False (a
CUDA kernel has no CPU mode). This file imports no JAX, so it runs on a GPU
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as flash_attention_core  # noqa: E402


def _launches():
    return dict(ops.LAUNCHES)

# the shapes of tests/test_kernels.py, plus full 1024-wide codec rows
SHAPES = [(4, 256), (16, 1024), (1, 128), (2048, 1024)]


def _inputs(nb, blk, seed=4):
    rng = np.random.default_rng(seed)
    prev = rng.standard_normal((nb, blk)).astype(np.float32)
    new = (prev + 0.01 * rng.standard_normal((nb, blk))).astype(np.float32)
    return new, prev


@pytest.mark.cuda
@pytest.mark.parametrize("nb,blk", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_kernels_match_plain_versions_bit_for_bit(nb, blk, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    new, prev = (torch.from_numpy(a).to("cuda", tdt) for a in _inputs(nb, blk))
    before = dict(ops.LAUNCHES)
    codes, scales = ops.delta_encode(new, prev)
    codes_r, scales_r = ref.delta_encode_ref(new, prev)
    torch.cuda.synchronize()
    assert torch.equal(codes, codes_r) and torch.equal(scales, scales_r)
    for out in (torch.float32, torch.bfloat16):
        dec = ops.delta_decode(codes, scales, prev, dtype=out)
        assert torch.equal(dec, ref.delta_decode_ref(codes, scales, prev, dtype=out))
    assert ops.LAUNCHES["delta_encode"] == before["delta_encode"] + 1
    assert ops.LAUNCHES["delta_decode"] == before["delta_decode"] + 2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # the plain versions' products must run in full f32 (PyTorch's default)
    assert not torch.backends.cuda.matmul.allow_tf32


def _ssd_inputs(b, s, h, p, n, g, seed=2, strong=False):
    """The recipe of tests/test_kernels.py:72-81; ``strong``: dt about 1.4,
    so that the decay sums of a 256 chunk reach a few hundred."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    z = rng.standard_normal((b, s, h))
    dt = (np.log1p(np.exp(z + 1.0)) if strong else np.log1p(np.exp(z)) * 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,p,n,g,chunk", [
    (64, 2, 16, 16, 1, 16),     # the shapes of tests/test_kernels.py
    (128, 4, 32, 32, 2, 32),
    (64, 2, 64, 128, 1, 32),
    (32, 8, 16, 16, 1, 8),      # the mamba2 smoke mixer (chunk 8)
    (512, 2, 64, 128, 1, 256),  # mamba2-370m's head and chunk: 4 x 4 tiles per chunk
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_ssd_matches_plain_version(s, h, p, n, g, chunk, dtype):
    _cuda()
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, dt, A, Bm, Cm = _ssd_inputs(2, s, h, p, n, g)
    x, dt, Bm, Cm = (torch.from_numpy(a).to("cuda", tdt) for a in (x, dt, Bm, Cm))
    A = torch.from_numpy(A).cuda()
    before = _launches()
    y = ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd"] == before["ssd"] + 1
    assert y.dtype == tdt and y.shape == x.shape
    tol = 5e-2 if dtype == "bf16" else 1e-4
    torch.testing.assert_close(y.float(), ref.ssd_ref(x, dt, A, Bm, Cm).float(),
                               atol=tol, rtol=tol)


def _ssd_case(b, s, h, p, n, g, chunk, dtype, strong=False):
    _cuda()
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, dt, A, Bm, Cm = _ssd_inputs(b, s, h, p, n, g, strong=strong)
    x, dt, Bm, Cm = (torch.from_numpy(a).to("cuda", tdt) for a in (x, dt, Bm, Cm))
    A = torch.from_numpy(A).cuda()
    before = _launches()
    y = ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd"] == before["ssd"] + 1
    assert y.dtype == tdt and y.shape == x.shape
    tol = 5e-2 if dtype == "bf16" else 1e-4
    torch.testing.assert_close(y.float(), ref.ssd_ref(x, dt, A, Bm, Cm).float(),
                               atol=tol, rtol=tol)
    return (x, dt, A, Bm, Cm), y


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,g,chunk,strong", [
    (1, 768, 4, 64, 128, 2, 256, True),    # mamba2-370m's head, 3 chunks, 2 groups, cum ~ -500
    (1, 1024, 2, 64, 128, 1, 256, False),  # batch x heads 2, far below the 132 SMs
    (2, 192, 2, 32, 64, 1, 64, False),     # 3 chunks of one 64-row tile
    (1, 256, 2, 128, 128, 1, 128, False),  # two column tiles of P
    (2, 96, 3, 24, 40, 1, 32, False),      # P and N not multiples of 16
], ids=["mamba2-head-strong-decay", "few-ctas", "nc3-chunk64", "p128", "ragged-p-n"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_ssd_redesign_shapes(b, s, h, p, n, g, chunk, strong, dtype):
    """The shapes the chunk-parallel kernels tile differently: several
    chunks whose states pass between kernels, few (batch, head) pairs,
    zero-padded tiles of P and N, two column tiles of P."""
    _ssd_case(b, s, h, p, n, g, chunk, dtype, strong=strong)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_ssd_two_calls_bit_identical(dtype):
    """No atomics: every output is summed in a fixed order."""
    args, y = _ssd_case(2, 768, 4, 64, 128, 1, 256, dtype)
    for _ in range(2):
        assert torch.equal(ops.ssd(*args, chunk=256), y)


@pytest.mark.cuda
def test_cuda_ssd_smem_opt_in_per_kernel_function():
    """Each of the five kernel functions has the 227 KB dynamic
    shared-memory opt-in set."""
    _cuda()
    from repro_torch.kernels import ssd as k_ssd

    limits = k_ssd.smem_limits()
    assert sorted(limits) == sorted(k_ssd.KERNELS)
    assert all(v == 227 * 1024 for v in limits.values()), limits


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,chunk", [(64, 256, 64), (20, 16, 16), (16, 16, 96)])
def test_cuda_ssd_refuses_shapes_it_cannot_tile(p, n, chunk):
    """N above 128, P or N not a multiple of 8, a chunk above 64 that is
    not a multiple of 64: the wrapper raises, with no fallback."""
    _cuda()
    x, dt, A, Bm, Cm = (torch.from_numpy(a).cuda() for a in _ssd_inputs(1, 192, 2, p, n, 1))
    before = _launches()
    with pytest.raises(ValueError, match="SSD kernels take"):
        ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    assert ops.LAUNCHES["ssd"] == before["ssd"]


@pytest.mark.cuda
def test_cuda_mamba2_smoke_forward_through_the_kernel():
    """Every mixer of the mamba2 smoke model through ops.ssd_model_impl
    against the model's own chunked path, on the card."""
    _cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import apply_head, forward_ssm, init_params, param_descs
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.ssm import mamba2_mixer
    from repro_torch.tree import tree_map

    cfg = get_config("mamba2-370m", smoke=True)
    params = init_params(param_descs(cfg), torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))).cuda()
    with torch.no_grad():
        want = forward_ssm(cfg, params, tokens)[0]
        before = _launches()
        x = params["embed"][tokens]
        for i in range(cfg.num_layers):
            lp = tree_map(lambda w: w[i], params["layers"])
            out, _ = mamba2_mixer(lp["mixer"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                                  ssd_impl=ops.ssd_model_impl)
            x = x + out
        got = apply_head(cfg, params, x)
    assert ops.LAUNCHES["ssd"] == before["ssd"] + cfg.num_layers
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-4, rel


def _flash_case(b, s, t, d, causal, dtype, seed):
    """The kernel through the core wrapper on one (b, s, d) x (b, t, d)
    problem, held against flash_attention_ref at tests/test_kernels.py:39's
    bounds."""
    _cuda()
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to("cuda", tdt)
    k, v = (torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to("cuda", tdt)
            for _ in range(2))
    before = _launches()
    o = flash_attention_core(q, k, v, causal=causal, block_q=s, block_k=t)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert o.dtype == tdt and o.shape == q.shape
    tol = 2e-2 if dtype == "bf16" else 2e-5
    torch.testing.assert_close(o.float(), ref.flash_attention_ref(q, k, v, causal=causal).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(128, 64), (256, 128), (64, 32), (96, 32), (192, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_flash_matches_plain_version(s, d, causal, dtype):
    """The sweep of tests/test_kernels.py, plus a sequence that is not a
    multiple of the kernel's 64-row tile and gemma-2b's head dim 256."""
    _flash_case(2, s, s, d, causal, dtype, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (8, 1)])
def test_cuda_flash_gqa_reads_kv_heads_in_place(nq, nkv):
    _cuda()
    b, s, hd = 2, 128, 64
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((b, s, nq, hd)).astype(np.float32)).cuda()
    k, v = (torch.from_numpy(rng.standard_normal((b, s, nkv, hd)).astype(np.float32)).cuda()
            for _ in range(2))
    before = _launches()
    o = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True, block_q=64, block_k=64)
    torch.testing.assert_close(o.cpu(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("s,t,d", [
    (200, 200, 64), (130, 130, 256), (72, 72, 128), (130, 130, 32),  # ragged S = T
    (96, 160, 64), (192, 64, 128), (64, 200, 256), (130, 72, 32),    # S != T
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_flash_ragged_and_unequal_lengths(s, t, d, causal, dtype):
    """S and T not multiples of the kernel's 64- and 128-row query tiles or
    of its 32- and 64-row kv tiles, at every head dim; with S != T, causal
    masks cols <= rows in absolute positions, as the reference does."""
    _flash_case(2, s, t, d, causal, dtype, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_flash_unaligned_storage(dtype):
    """Contiguous inputs whose storage starts off a 16-byte boundary (the
    kernel's cp.async copies need aligned rows) are copied, not refused."""
    _cuda()
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(2 * 64 * 32 + 1).astype(np.float32))
               .to("cuda", tdt)[1:].view(2, 64, 32) for _ in range(3))
    assert q.data_ptr() % 16 != 0
    o = flash_attention_core(q, k, v, causal=True, block_q=64, block_k=64)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    torch.testing.assert_close(o.float(), ref.flash_attention_ref(q, k, v, causal=True).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_flash_long_bf16_causal_row():
    """One (batch, head) at gemma-2b's sequence and head dim: 32 kv tiles of
    online softmax with P rounded to bf16."""
    _flash_case(1, 2048, 2048, 256, True, "bf16", seed=6)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_gqa_8_to_1_bf16_d256(causal):
    """gemma-2b's head layout (8 q heads on 1 kv head, head dim 256) in bf16."""
    _cuda()
    b, s, hd = 2, 256, 256
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((b, s, 8, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, 1, hd)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to("cuda", torch.bfloat16) for t in (q, k, v))
    before = _launches()
    o = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    torch.testing.assert_close(o.float(), ref.flash_attention_gqa_ref(q, k, v, causal=causal).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_370m"])
def test_cuda_serving_decode_and_replay(arch, tmp_path):
    """The serving path on the card at the smoke configs: teacher-forced
    decode_step equals one forward position by position (16 tokens, two of
    the mamba2 smoke config's chunks of 8), and a serving run with a kill
    gives the failure-free run's tokens. The path launches no kernel."""
    _cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import (cache_descs, decode_step, forward, init_params, param_descs,
                                    zeros_from_descs)
    from repro_torch.train import run_speculative_serving

    cfg = get_config(arch, smoke=True)
    params = init_params(param_descs(cfg), torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 16))).cuda()
    before = _launches()
    with torch.no_grad():
        cache = zeros_from_descs(cache_descs(cfg, 1, 16), device="cuda")
        got = torch.cat([decode_step(cfg, params, cache, tokens[:, i: i + 1], i)[0]
                         for i in range(16)], dim=1)
        want = forward(cfg, params, tokens)[0]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    base = run_speculative_serving(tmp_path / "base", cfg, params, n_tokens=10)
    killed = run_speculative_serving(tmp_path / "kill", cfg, params, n_tokens=10, kill_at=5)
    assert killed.rollbacks == 1 and killed.tokens_generated == 10
    assert len(base.durable_tokens) == 10 and killed.durable_tokens == base.durable_tokens
    assert _launches() == before


# --------------------------------------------------------------------------- #
# the launch layer on the card: tuning knobs, remat, the ssm train step        #
# --------------------------------------------------------------------------- #
def _smoke(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_descs

    cfg = get_config(arch, smoke=True)
    params = init_params(param_descs(cfg), torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    return cfg, params, {"tokens": tokens}


def _train(cfg, params, batch, remat="none", **tune):
    from repro_torch.launch import make_train_step
    from repro_torch.models import tuning
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_flatten

    with tuning(**tune):
        p2, _, loss = make_train_step(cfg, AdamWConfig(lr=1e-3), remat=remat)(
            params, adamw_init(params), batch)
    return loss, tree_flatten(p2)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("knob,loss_tol,param_tol", [
    # the bounds of tests/test_tuning.py (microbatch: Adam's first step
    # turns a reassociated near-zero gradient into up to one lr step)
    ({"loss_chunk": 4}, 1e-4, 1e-4),
    ({"microbatch": 2}, 1e-4, 2e-3),
    ({"constrain_activations": True}, 1e-5, 1e-5),
    ({"remat": "dots"}, 1e-5, 1e-5),
    ({"remat": "full"}, 1e-5, 1e-5),
])
def test_cuda_tuned_train_step_matches_untuned(knob, loss_tol, param_tol):
    """The tuning knobs and remat policies on the card at yi smoke: the same
    loss and params as the untuned step."""
    _cuda()
    cfg, params, batch = _smoke("yi_6b")
    loss0, p0 = _train(cfg, params, batch)
    loss1, p1 = _train(cfg, params, batch, **knob)
    assert abs(float(loss1) - float(loss0)) < loss_tol
    assert max(float((a - b).abs().max()) for a, b in zip(p0, p1)) < param_tol


@pytest.mark.cuda
def test_cuda_flash_decode_matches_baseline_decode():
    from repro_torch.models import cache_descs, decode_step, tuning, zeros_from_descs

    _cuda()
    cfg, params, _ = _smoke("yi_6b")
    tok = torch.ones((2, 1), dtype=torch.int32, device="cuda")
    outs = {}
    for flag in (False, True):
        cache = zeros_from_descs(cache_descs(cfg, 2, 8), device="cuda")
        with tuning(decode_seq_constraint=flag), torch.no_grad():
            outs[flag] = torch.cat([decode_step(cfg, params, cache, tok, i)[0]
                                    for i in range(4)], dim=1)
    torch.testing.assert_close(outs[True], outs[False], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_mamba2_train_step_bit_identical_under_determinism(monkeypatch):
    """Two calls of the mamba2 smoke train step from one state, under
    torch.use_deterministic_algorithms(True) (the setting of the resilient
    loop's bit-identical claim), give bit-identical loss and params; the
    full remat policy matches keeping every activation."""
    _cuda()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cfg, params, batch = _smoke("mamba2_370m")
        loss_a, pa = _train(cfg, params, batch)
        loss_b, pb = _train(cfg, params, batch)
        loss_f, pf = _train(cfg, params, batch, remat="full")
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.isfinite(loss_a) and torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert abs(float(loss_f) - float(loss_a)) < 1e-5
    assert max(float((a - b).abs().max()) for a, b in zip(pa, pf)) < 1e-5


@pytest.mark.cuda
def test_cuda_gemma3_serving_equals_cpu(tmp_path):
    """gemma3 smoke served on the card: 24 tokens (its window-8 rings wrap),
    failure-free and with a kill, equal a CPU run's from the same weights;
    no kernel is launched."""
    from repro_torch.train import run_speculative_serving
    from repro_torch.tree import tree_map

    _cuda()
    cfg, params, _ = _smoke("gemma3_4b")
    before = _launches()
    card = run_speculative_serving(tmp_path / "card", cfg, params, n_tokens=24)
    killed = run_speculative_serving(tmp_path / "kill", cfg, params, n_tokens=24, kill_at=12)
    cpu = run_speculative_serving(tmp_path / "cpu", cfg, tree_map(lambda t: t.cpu(), params),
                                  n_tokens=24, device="cpu")
    assert len(cpu.durable_tokens) == 24 and card.durable_tokens == cpu.durable_tokens
    assert killed.rollbacks == 1 and killed.durable_tokens == card.durable_tokens
    assert _launches() == before


# --------------------------------------------------------------------------- #
# the moe, mla and hybrid families on the card                                #
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
def test_cuda_granite_train_step_bit_identical_under_determinism(monkeypatch):
    """Two calls of the granite-moe smoke train step from one state, under
    torch.use_deterministic_algorithms(True): the MoE dispatch (stable-sort
    routing, the gates as a product with the ids' one-hot, the one-hot
    einsums) has no scatter, so loss and params are bit-identical."""
    _cuda()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cfg, params, batch = _smoke("granite_moe_3b_a800m")
        loss_a, pa = _train(cfg, params, batch)
        loss_b, pb = _train(cfg, params, batch)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.isfinite(loss_a) and torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_v2_lite_16b", "zamba2_1p2b"])
def test_cuda_new_family_serving_equals_cpu(arch, tmp_path):
    """The moe, mla and hybrid smoke configs served on the card: 16 tokens,
    failure-free and with a kill after 8, equal a CPU run's from the same
    weights; no kernel is launched."""
    from repro_torch.train import run_speculative_serving
    from repro_torch.tree import tree_map

    _cuda()
    cfg, params, _ = _smoke(arch)
    before = _launches()
    card = run_speculative_serving(tmp_path / "card", cfg, params, n_tokens=16)
    killed = run_speculative_serving(tmp_path / "kill", cfg, params, n_tokens=16, kill_at=8)
    cpu = run_speculative_serving(tmp_path / "cpu", cfg, tree_map(lambda t: t.cpu(), params),
                                  n_tokens=16, device="cpu")
    assert len(cpu.durable_tokens) == 16 and card.durable_tokens == cpu.durable_tokens
    assert killed.rollbacks == 1 and killed.durable_tokens == card.durable_tokens
    assert _launches() == before


# --------------------------------------------------------------------------- #
# the encdec and vlm families on the card                                     #
# --------------------------------------------------------------------------- #
def _with_extras(arch, batch):
    """The smoke config, its params on the card (a vlm's cross-block gates,
    0 at init, set to seeded values of magnitude 0.5-1.5 and random sign)
    and seeded extras of the std of an embedded token for ``batch`` rows."""
    cfg, params, _ = _smoke(arch)
    rng = np.random.default_rng(3)
    if cfg.family == "vlm":
        gc = params["group_cross"]
        for holder, key in ((gc["attn"], "gate"), (gc, "mlp_gate")):
            shape = tuple(holder[key].shape)
            vals = rng.uniform(0.5, 1.5, shape) * rng.choice([-1.0, 1.0], shape)
            holder[key] = torch.from_numpy(vals.astype(np.float32)).cuda()
    std = np.sqrt((cfg.d_model if cfg.activation == "gelu" else 1) / cfg.vocab_padded)
    key, n = (("frames", cfg.source_len) if cfg.family == "encdec"
              else ("image_embeds", cfg.num_image_tokens))
    extras = {key: (rng.standard_normal((batch, n, cfg.d_model)) * std).astype(np.float32)}
    return cfg, params, extras


@pytest.mark.cuda
def test_cuda_seamless_train_step_bit_identical_under_determinism(monkeypatch):
    """Two calls of the seamless smoke train step (the encoder, the decoder's
    cross-attention to it) from one state, under
    torch.use_deterministic_algorithms(True): bit-identical loss and params."""
    _cuda()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cfg, params, extras = _with_extras("seamless_m4t_large_v2", 4)
        batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 17)), **extras}
        loss_a, pa = _train(cfg, params, batch)
        loss_b, pb = _train(cfg, params, batch)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.isfinite(loss_a) and torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "llama_3p2_vision_90b"])
def test_cuda_encdec_vlm_serving_equals_cpu(arch, tmp_path):
    """The encdec and vlm smoke configs served on the card with their
    extras: 16 tokens, failure-free and with a kill after 8, equal a CPU
    run's from the same weights; no kernel is launched."""
    from repro_torch.train import run_speculative_serving
    from repro_torch.tree import tree_map

    _cuda()
    cfg, params, extras = _with_extras(arch, 1)
    before = _launches()
    card = run_speculative_serving(tmp_path / "card", cfg, params, n_tokens=16, extras=extras)
    killed = run_speculative_serving(tmp_path / "kill", cfg, params, n_tokens=16, kill_at=8,
                                     extras=extras)
    cpu = run_speculative_serving(tmp_path / "cpu", cfg, tree_map(lambda t: t.cpu(), params),
                                  n_tokens=16, extras=extras, device="cpu")
    assert len(cpu.durable_tokens) == 16 and card.durable_tokens == cpu.durable_tokens
    assert killed.rollbacks == 1 and killed.durable_tokens == card.durable_tokens
    assert _launches() == before


# --------------------------------------------------------------------------- #
# expert parallelism on a world of one, and gradient compression              #
# --------------------------------------------------------------------------- #
@pytest.fixture
def nccl_world_of_one(tmp_path):
    """A world-of-one NCCL group (file:// rendezvous) and its (1, 1) mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    _cuda()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv", world_size=1, rank=0,
                            device_id=torch.device("cuda:0"))
    try:
        yield make_host_mesh(model=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_v2_lite_16b"])
def test_cuda_ep_equals_einsum_on_a_world_of_one(nccl_world_of_one, arch):
    """The EP route on the card (NCCL all-to-all of one rank): the einsum
    dispatch's capacity and drop order, so y within 1e-5 of max |y|, the
    aux within 1e-5 relative; no kernel of the port is launched."""
    from repro_torch.models import tuning
    from repro_torch.models.layers import moe
    from repro_torch.parallel.ep_moe import ep_mesh

    cfg, params, _ = _smoke(arch)
    p = params["moe_layers" if "moe_layers" in params else "layers"]["moe"]
    p = {k: (v[0] if k != "shared" else {n: t[0] for n, t in v.items()}) for k, v in p.items()}
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    before = _launches()
    with torch.no_grad():
        y0, aux0 = moe(p, x, cfg)
        with ep_mesh(nccl_world_of_one), tuning(moe_impl="ep"):
            y1, aux1 = moe(p, x, cfg)
    assert float((y1 - y0).abs().max()) <= 1e-5 * float(y0.abs().max())
    assert abs(float(aux1) - float(aux0)) <= 1e-5 * abs(float(aux0))
    assert _launches() == before


@pytest.mark.cuda
def test_cuda_ep_train_steps_bit_identical_under_determinism(nccl_world_of_one, monkeypatch):
    """Two granite smoke train steps through the EP route under
    torch.use_deterministic_algorithms(True) (the scatter into the buckets,
    and the index_put with accumulation that is the backward of the gather
    back from them): bit-identical; the loss within 1e-5 of the einsum
    step's."""
    from repro_torch.parallel.ep_moe import ep_mesh

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cfg, params, batch = _smoke("granite_moe_3b_a800m")
        loss_e, _ = _train(cfg, params, batch)
        with ep_mesh(nccl_world_of_one):
            loss_a, pa = _train(cfg, params, batch, moe_impl="ep")
            loss_b, pb = _train(cfg, params, batch, moe_impl="ep")
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.isfinite(loss_a) and torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert abs(float(loss_a) - float(loss_e)) <= 1e-5 * abs(float(loss_e))


@pytest.mark.cuda
def test_cuda_compress_gradients_bit_equal_to_cpu():
    """Three steps of int8 compression with error feedback on the card equal
    the same calls on the CPU bit for bit (codes, scales, residuals)."""
    from repro_torch.optim import compress_gradients_int8
    from repro_torch.tree import tree_flatten, tree_map

    _cuda()
    rng = np.random.default_rng(0)
    grads = [{"a": torch.from_numpy(rng.standard_normal((512, 384)).astype(np.float32)),
              "b": torch.from_numpy((rng.standard_normal(1000) * 1e-3).astype(np.float32))}
             for _ in range(3)]
    ef_card = ef_cpu = tree_map(torch.zeros_like, grads[0])
    ef_card = tree_map(lambda t: t.cuda(), ef_card)
    for g in grads:
        out_card = compress_gradients_int8(tree_map(lambda t: t.cuda(), g), ef_card)
        out_cpu = compress_gradients_int8(g, ef_cpu)
        ef_card, ef_cpu = out_card[2], out_cpu[2]
        for a, b in zip(tree_flatten(out_card)[0], tree_flatten(out_cpu)[0]):
            assert torch.equal(a.cpu(), b)
