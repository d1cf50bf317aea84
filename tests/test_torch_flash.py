"""The port's flash attention (plain version of the CUDA kernel) against the
JAX package.

On the CPU the port's wrappers run their plain version
``ref.flash_attention_ref``. They are held against the reference's Pallas
kernel (interpret mode), its ``ref.flash_attention_ref`` and its GQA
wrapper ``ops.flash_attention`` on the same numpy inputs, at the sweep and
tolerances of ``tests/test_kernels.py``. The CUDA kernel itself is held
against the plain version in ``tests/test_torch_cuda.py``, on a card.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_fa_core  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


def _pair(a: np.ndarray, bf16: bool):
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("s,d,bq,bk", [
    (128, 64, 64, 64),
    (256, 64, 128, 64),
    (256, 128, 128, 128),
    (64, 32, 32, 32),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_flash_matches_jax_kernel_and_oracle(s, d, bq, bk, causal, bf16):
    q, k, v = _qkv((2, s, d), (2, s, d), seed=0)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, bf16) for a in (q, k, v))
    got = tfa.flash_attention(qt, kt, vt, causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == qt.dtype and got.shape == (2, s, d)
    # the bounds of tests/test_kernels.py:39
    tol = 2e-2 if bf16 else 2e-5
    for want in (jax_fa_core(qj, kj, vj, causal=causal, block_q=bq, block_k=bk, interpret=True),
                 jref.flash_attention_ref(qj, kj, vj, causal=causal)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (8, 1)])
def test_gqa_wrapper_matches_jax(nq, nkv):
    b, s, hd = 2, 128, 64
    q, k, v = _qkv((b, s, nq, hd), (b, s, nkv, hd), seed=1)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                block_q=64, block_k=64, interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                              block_q=64, block_k=64)
    assert got.shape == (b, s, nq, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    # head h reads kv head h // (nq / nkv), as jnp.repeat lays it out
    kr = torch.repeat_interleave(torch.from_numpy(k), nq // nkv, dim=2)
    vr = torch.repeat_interleave(torch.from_numpy(v), nq // nkv, dim=2)
    for h in range(nq):
        torch.testing.assert_close(
            got[:, :, h], ref.flash_attention_ref(torch.from_numpy(q)[:, :, h], kr[:, :, h],
                                                  vr[:, :, h], causal=True),
            atol=2e-5, rtol=2e-5)


def test_shape_contract_errors():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 96, 32), (2, 96, 32), seed=2))
    with pytest.raises(ValueError, match="not multiples of the blocks"):
        tfa.flash_attention(q, k, v, block_q=64, block_k=32)
    with pytest.raises(ValueError, match="not multiples of the blocks"):
        tfa.flash_attention(q, k, v, block_q=32, block_k=64)
    tfa.flash_attention(q, k, v, block_q=32, block_k=32)
    # the GQA wrapper clamps the blocks to the sequence, as the reference's
    q4, k4, v4 = (torch.from_numpy(a) for a in _qkv((1, 96, 2, 32), (1, 96, 1, 32), seed=3))
    with pytest.raises(ValueError, match="not multiples of the blocks"):
        ops.flash_attention(q4, k4, v4, block_q=64, block_k=64)
    short = ops.flash_attention(q4[:, :48], k4[:, :48], v4[:, :48], block_q=128, block_k=128)
    assert short.shape == (1, 48, 2, 32)


def _emulate_bf16_kernel(q, k, v, *, causal: bool, block_k: int = 64) -> torch.Tensor:
    """A plain emulation of the CUDA kernel's bf16 arithmetic (csrc/
    flash_attention.cu): q k^T of the bf16 inputs summed in f32, scaled by
    scale * log2(e) once; -1e30 on masked causal positions; online softmax
    over ``block_k``-wide kv tiles with exp2 in f32; the denominator summed
    from the f32 P; P rounded to bf16 before P V; out = acc / max(l, 1e-30)
    rounded to bf16. q (BH, S, D), k/v (BH, T, D) bf16."""
    bh, s, d = q.shape
    t = k.shape[1]
    sl2 = torch.tensor(1.0 / np.sqrt(d) * np.log2(np.e), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, s, 1), -1e30)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, d))
    rows = torch.arange(s)[:, None]
    for j0 in range(0, t, block_k):
        sc = torch.einsum("bqd,bkd->bqk", qf, kf[:, j0:j0 + block_k]) * sl2
        if causal:
            cols = torch.arange(j0, min(j0 + block_k, t))[None, :]
            sc = torch.where(cols <= rows, sc, torch.full_like(sc, -1e30))
        mn = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp2(sc - mn)
        c = torch.exp2(m - mn)
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + torch.einsum("bqk,bkd->bqd", p.to(torch.bfloat16).float(),
                                     vf[:, j0:j0 + block_k])
        m = mn
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_rounding_matches_jax_kernel(causal):
    """The card's one numeric choice, P rounded to bf16 before P V, stays
    within the 2e-2 bound of the reference's Pallas kernel (interpret mode)
    at bf16, S 256, D 256, blocks 64."""
    q, k, v = _qkv((2, 256, 256), (2, 256, 256), seed=8)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, True) for a in (q, k, v))
    got = _emulate_bf16_kernel(qt, kt, vt, causal=causal)
    want = jax_fa_core(qj, kj, vj, causal=causal, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_bf16_kernel_rounding_matches_float64_softmax_long_row():
    """The same emulation through 32 kv tiles (S 2048, D 256, causal) against
    a float64 softmax of the same bf16 inputs, within 2e-2."""
    q, k, v = _qkv((1, 2048, 256), (1, 2048, 256), seed=9)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _emulate_bf16_kernel(qt, kt, vt, causal=True)
    q64, k64, v64 = (t.double() for t in (qt, kt, vt))
    sc = torch.einsum("bqd,bkd->bqk", q64, k64) / np.sqrt(256)
    mask = torch.arange(2048)[None, :] <= torch.arange(2048)[:, None]
    sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    want = torch.einsum("bqk,bkd->bqd", torch.softmax(sc, -1), v64)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), atol=2e-2, rtol=2e-2)
