"""Checkpoint delta codec: the hand-written CUDA kernels and their wrappers.

Port of ``repro/kernels/delta_encode.py``. The kernels live in
``csrc/delta_codec.cu`` (one CTA per row of the ``(nblocks, block)`` stream,
int8 codes with a per-row f32 scale); see that file for what bounds them on
the H100 and how the design follows.

Build: ``build.py`` compiles the source with ``nvcc`` for ``sm_90a`` at first
use on a CUDA tensor and loads it with ``ctypes``. Nothing is built on import.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import torch

from . import build, ref
from .build import LAUNCHES

SOURCE = build.CSRC / "delta_codec.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    return build.load(SOURCE, {
        "delta_encode": ([p, p, p, p, i64, i32, i32, p], i32),
        "delta_decode": ([p, p, p, p, i64, i32, i32, i32, p], i32),
    })


def _check_rows(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_block(blk: int) -> None:
    if blk % 4 or not 0 < blk <= 1024:
        raise ValueError(f"rows must be a multiple of 4 elements, at most 1024; got {blk}")


def delta_encode(new: torch.Tensor, prev: torch.Tensor):
    """(nblocks, block) new/prev (f32 or bf16) -> int8 codes, (nblocks,) f32 scales."""
    if new.device.type == "cpu" and prev.device.type == "cpu":
        return ref.delta_encode_ref(new, prev)
    nb, blk = new.shape
    _check_block(blk)
    _check_rows("new", new, (nb, blk), tuple(_DTYPE_CODE), new.device)
    _check_rows("prev", prev, (nb, blk), (new.dtype,), new.device)
    if new.device.type != "cuda":
        raise ValueError(f"delta_encode has no kernel for device {new.device}")
    codes = torch.empty((nb, blk), dtype=torch.int8, device=new.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=new.device)
    with torch.cuda.device(new.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().delta_encode(
            new.data_ptr(), prev.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            nb, blk, _DTYPE_CODE[new.dtype], stream,
        )
    build.raise_on(err, "delta_encode")
    LAUNCHES["delta_encode"] += 1
    return codes, scales


def delta_decode(codes: torch.Tensor, scales: torch.Tensor, prev: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """out = dtype(f32(prev) + f32(codes) * scales[row]); dtype f32 or bf16."""
    if all(t.device.type == "cpu" for t in (codes, scales, prev)):
        return ref.delta_decode_ref(codes, scales, prev, dtype=dtype)
    nb, blk = codes.shape
    _check_block(blk)
    dev = codes.device
    _check_rows("codes", codes, (nb, blk), (torch.int8,), dev)
    _check_rows("scales", scales, (nb,), (torch.float32,), dev)
    _check_rows("prev", prev, (nb, blk), tuple(_DTYPE_CODE), dev)
    if dev.type != "cuda":
        raise ValueError(f"delta_decode has no kernel for device {dev}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"delta_decode writes float32 or bfloat16, not {dtype}")
    out = torch.empty((nb, blk), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().delta_decode(
            codes.data_ptr(), scales.data_ptr(), prev.data_ptr(), out.data_ptr(),
            nb, blk, _DTYPE_CODE[prev.dtype], _DTYPE_CODE[dtype], stream,
        )
    build.raise_on(err, "delta_decode")
    LAUNCHES["delta_decode"] += 1
    return out
