"""Public entry points of the port's kernels (counterpart of
``repro/kernels/ops.py``). A CUDA tensor launches the hand-written kernel; a
CPU tensor takes the plain version. There is no ``interpret`` flag: the
reference's ``_default_interpret`` and ``_compat.py`` are TPU-only.

``LAUNCHES`` counts kernel launches by name (``delta_encode``,
``delta_decode``, ``ssd``, ``flash_attention``)."""
from __future__ import annotations

from .build import LAUNCHES, reset_launch_counts
from .delta_encode import delta_decode, delta_encode
from .flash_attention import flash_attention_gqa as flash_attention
from .ssd import ssd


def ssd_model_impl(x, dt, A, Bm, Cm, chunk=256):
    """Adapter matching ``models/ssm.py``'s ``ssd_impl`` signature (y, state);
    the kernel keeps the final state to itself."""
    return ssd(x, dt, A, Bm, Cm, chunk=chunk), None


__all__ = ["LAUNCHES", "delta_decode", "delta_encode", "flash_attention",
           "reset_launch_counts", "ssd", "ssd_model_impl"]
