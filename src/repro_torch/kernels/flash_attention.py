"""Flash attention forward: the hand-written CUDA kernel and its wrappers.

Port of ``repro/kernels/flash_attention.py`` (``_flash_kernel`` :26 and the
core wrapper ``flash_attention`` :79) and of the GQA wrapper
``repro/kernels/ops.py:26``. The kernel lives in ``csrc/flash_attention.cu``.
It is compute-bound on the H100 in both types. bf16 inputs run on the tensor
cores (``mma.sync`` m16n8k16 with f32 accumulators, 128 query rows per CTA,
S and O in registers, K/V through a cp.async ring); the probabilities P are
rounded to bf16 before P V, the one arithmetic difference from the
reference's f32 P (within its 2e-2 bound). f32 inputs run register-tiled
FP32 FMA (no TF32: the 2e-5 bound rules it out). See that file for the
bounds and the design. ``block_q``/``block_k`` keep the reference's shape
contract; the kernel chooses its own tiles for the card. GQA reads kv head
``h // (Nq/Nkv)`` in place rather than repeating kv to ``Nq`` heads.

Inputs that all lie on the CPU go to the plain versions
``ref.flash_attention_ref`` / ``ref.flash_attention_gqa_ref``; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build, ref
from .build import LAUNCHES

SOURCE = build.CSRC / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return build.load(SOURCE, {
        "flash_attention_forward": ([p] * 4 + [i32] * 6 + [i64] * 6
                                    + [ctypes.c_float, i32, i32, p], i32),
    })


def _check_blocks(s: int, t: int, block_q: int, block_k: int) -> None:
    if s % block_q or t % block_k:
        raise ValueError(f"sequence lengths ({s}, {t}) are not multiples of the blocks "
                         f"({block_q}, {block_k})")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    """q (B,S,Nq,D), k/v (B,T,Nkv,D) on one CUDA device -> o (B,S,Nq,D)."""
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
    if dev.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for device {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    b, s, nq, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if k.shape != (b, t, nkv, d) or v.shape != k.shape or nq % nkv:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "do not form a GQA attention")
    # the kernel's 16-byte cp.async copies need 16-byte aligned rows
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
               for x in (q.contiguous(), k.contiguous(), v.contiguous()))
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, nq, nkv, s, t, d, *q.stride()[:3], *k.stride()[:3],
            float(scale), int(causal), _DTYPE_CODE[q.dtype], stream,
        )
    build.raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    block_q: int = 128, block_k: int = 128,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Core entry point: q (BH, S, D), k/v (BH, T, D) -> (BH, S, D) in q's dtype."""
    bh, s, d = q.shape
    _check_blocks(s, k.shape[1], block_q, block_k)
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None], causal, scale)[:, :, 0]


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, block_q: int = 128,
                        block_k: int = 128) -> torch.Tensor:
    """GQA flash attention. q (B,S,Nq,H); k/v (B,T,Nkv,H). Returns (B,S,Nq,H)."""
    s, hd, t = q.shape[1], q.shape[3], k.shape[1]
    _check_blocks(s, t, min(block_q, s), min(block_k, t))
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return ref.flash_attention_gqa_ref(q, k, v, causal=causal)
    return _launch(q, k, v, causal, 1.0 / np.sqrt(hd))
