"""Delta-codec kernels of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain versions; they are held
against the reference's Pallas kernel (interpret mode) and its plain
``ref`` functions on the same numpy inputs, at the shapes and tolerances of
``tests/test_kernels.py``. The CUDA kernels themselves are held against the
plain versions in ``tests/test_torch_cuda.py``, which runs only on a card.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SHAPES = [(4, 256), (16, 1024), (1, 128)]


def _inputs(nb, blk, seed=4):
    rng = np.random.default_rng(seed)
    prev = rng.standard_normal((nb, blk)).astype(np.float32)
    new = (prev + 0.01 * rng.standard_normal((nb, blk))).astype(np.float32)
    return new, prev


def _pair(a: np.ndarray, bf16: bool):
    """The same values as a jax array and a torch tensor (bf16: both round
    the f32 input to nearest even)."""
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("nb,blk", SHAPES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_delta_encode_matches_jax_and_roundtrips(nb, blk, bf16):
    new, prev = _inputs(nb, blk)
    new_j, new_t = _pair(new, bf16)
    prev_j, prev_t = _pair(prev, bf16)
    codes_t, scales_t = ops.delta_encode(new_t, prev_t)
    assert codes_t.dtype == torch.int8 and scales_t.dtype == torch.float32
    for codes_j, scales_j in (jops.delta_encode(new_j, prev_j, interpret=True),
                              jref.delta_encode_ref(new_j, prev_j)):
        # tolerance of tests/test_kernels.py: codes may differ by 1 at exact
        # rounding ties on fewer than 2% of elements; scales to rtol 1e-6
        diff = np.abs(np.asarray(codes_j, np.int32) - codes_t.numpy().astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.02
        np.testing.assert_allclose(scales_t.numpy(), np.asarray(scales_j), rtol=1e-6)
    dec = ops.delta_decode(codes_t, scales_t, prev_t, dtype=torch.float32)
    err = np.max(np.abs(dec.numpy() - new_t.float().numpy()))
    # quantisation bound: half a step per element
    assert err <= float(scales_t.max()) * 0.51 + 1e-6


@pytest.mark.parametrize("nb,blk", SHAPES)
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_delta_decode_matches_jax(nb, blk, out):
    new, prev = _inputs(nb, blk, seed=7)
    codes_j, scales_j = jref.delta_encode_ref(jnp.asarray(new), jnp.asarray(prev))
    jdt, tdt = (jnp.float32, torch.float32) if out == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jops.delta_decode(codes_j, scales_j, jnp.asarray(prev), dtype=jdt, interpret=True)
    got = ops.delta_decode(torch.from_numpy(np.array(codes_j)),
                           torch.from_numpy(np.array(scales_j)),
                           torch.from_numpy(prev), dtype=tdt)
    assert got.dtype == tdt
    # same codes and scales: one multiply and one add in f32. XLA may fuse
    # them into an FMA, which skips the rounding of the product: allow one
    # f32 ulp of the largest product plus one ulp of the result (one bf16
    # ulp of the result after the cast)
    atol = 2 ** -23 * 127 * float(np.max(np.asarray(scales_j)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -23 if out == "f32" else 2 ** -7, atol=atol)


def test_wrapper_validates_rows_and_devices():
    meta = torch.zeros(2, 1024, device="meta")
    with pytest.raises(ValueError, match="is on cpu, expected meta"):
        ops.delta_encode(meta, torch.zeros(2, 1024))
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.delta_encode(torch.zeros(2, 1030, device="meta"), torch.zeros(2, 1030, device="meta"))
    before = dict(ops.LAUNCHES)
    ops.delta_decode(*ops.delta_encode(torch.ones(2, 8), torch.zeros(2, 8)), torch.zeros(2, 8))
    assert ops.LAUNCHES == before  # tensors on the CPU take the plain versions
