"""Plain PyTorch versions of the hand-written kernels (the allclose targets).

Mirrors ``repro/kernels/ref.py:50-63``. The CPU tests run these, and the
kernel wrappers fall back to them only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch


def delta_encode_ref(new: torch.Tensor, prev: torch.Tensor):
    delta = new.float() - prev.float()
    amax = delta.abs().amax(dim=1)
    # divide by a tensor: PyTorch turns division by a Python scalar into a
    # multiply by its reciprocal, which rounds differently from IEEE x / 127
    scales = torch.clamp(amax, min=1e-30) / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(delta / scales[:, None]), -127, 127).to(torch.int8)
    return codes, scales


def delta_decode_ref(codes: torch.Tensor, scales: torch.Tensor, prev: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    delta = codes.float() * scales[:, None]
    return (prev.float() + delta).to(dtype)
