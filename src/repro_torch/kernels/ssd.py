"""Mamba-2 chunked SSD: the hand-written CUDA kernels and their wrapper.

Port of ``repro/kernels/ssd.py`` (``_ssd_kernel`` :24 and ``ssd`` :77). The
kernels live in ``csrc/ssd.cu``: one call runs the chunk states, the state
passing over the chunks and the chunk scan as three kernels, the chunks in
parallel (FP32 FMA for f32 inputs, the tensor cores for bf16); see that file
for what bounds them on the H100 and how the design follows. Unlike the
reference's wrapper it reads the G groups of B and C in place rather than
repeating them to H heads, and it keeps the (B, S, H, P) layout rather than
transposing to head-major.

A tensor on the CPU goes to the plain version ``ref.ssd_ref``; a CUDA tensor
launches the kernels or raises. The kernels take a chunk of at most 64 or a
multiple of 64, P and N multiples of 8 and N up to 128; the wrapper raises on
other shapes. It allocates the f32 workspace of chunk states (B H (S/L) N P,
33.5 MB at mamba2-370m's shape) with ``torch.empty`` on the input's device.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .build import LAUNCHES

SOURCE = build.CSRC / "ssd.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    return build.load(SOURCE, {"ssd_forward": ([p] * 8 + [i32] * 8 + [p], i32),
                               "ssd_smem_limits": ([p], i32)})


#: the kernel functions of one call, in the order ``smem_limits`` reports them
KERNELS = ("ssd_chunk_state_f32", "ssd_chunk_state_bf16", "ssd_state_passing",
           "ssd_chunk_scan_f32", "ssd_chunk_scan_bf16")
#: the largest N the kernels take
MAX_STATE = 128


def smem_limits() -> dict:
    """The dynamic shared memory each kernel function may use (bytes), after
    the library has set its 227 KB opt-in, as every call does."""
    out = (ctypes.c_int * len(KERNELS))()
    build.raise_on(_library().ssd_smem_limits(out), "ssd_smem_limits")
    return dict(zip(KERNELS, out))


def _check_shapes(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x must be (B,S,H,P) and Bm/Cm (B,S,G,N); got {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    want = {"dt": (b, s, h), "A": (h,), "Bm": (b, s, g, n), "Cm": (b, s, g, n)}
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """x (B,S,H,P), dt (B,S,H) post-softplus, A (H,) negative, Bm/Cm (B,S,G,N)
    -> y (B,S,H,P) in x's dtype (the final state stays in the kernel)."""
    _check_shapes(x, dt, A, Bm, Cm, chunk)
    if all(t.device.type == "cpu" for t in (x, dt, A, Bm, Cm)):
        return ref.ssd_ref(x, dt, A, Bm, Cm, chunk)
    dev = x.device
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dev.type != "cuda":
        raise ValueError(f"ssd has no kernel for device {dev}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm and Cm must share float32 or bfloat16; got {x.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (chunk > 64 and chunk % 64) or p % 8 or n % 8 or n > MAX_STATE:
        raise ValueError(f"the SSD kernels take a chunk of at most 64 or a multiple of 64, P and "
                         f"N multiples of 8 and N <= {MAX_STATE}; got chunk {chunk}, P {p}, N {n}")
    # exact for dt and A: the kernels compute in f32. The 16-byte cp.async
    # copies need 16-byte aligned storage
    x, Bm, Cm, dt32, A32 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (
        x.contiguous(), Bm.contiguous(), Cm.contiguous(),
        dt.to(torch.float32).contiguous(), A.to(torch.float32).contiguous()))
    y = torch.empty_like(x)
    nc = s // chunk
    states = torch.empty(b * h * nc * n * p, dtype=torch.float32, device=dev)
    decay = torch.empty(b * h * nc, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().ssd_forward(
            x.data_ptr(), dt32.data_ptr(), A32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(), b, s, h, p, g, n, chunk,
            _DTYPE_CODE[x.dtype], stream,
        )
    build.raise_on(err, "ssd")
    LAUNCHES["ssd"] += 1
    return y
