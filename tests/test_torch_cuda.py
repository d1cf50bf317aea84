"""The port's CUDA kernels against their plain versions, on the card.

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
