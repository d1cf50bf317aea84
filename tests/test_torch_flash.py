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
