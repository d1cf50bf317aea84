"""Public entry points of the port's kernels (counterpart of
``repro/kernels/ops.py``). A CUDA tensor launches the hand-written kernel; a
CPU tensor takes the plain version. There is no ``interpret`` flag: the
reference's ``_default_interpret`` and ``_compat.py`` are TPU-only.

``flash_attention`` and ``ssd`` are not ported yet (ROADMAP.md)."""
from __future__ import annotations

from .delta_encode import LAUNCHES, delta_decode, delta_encode, reset_launch_counts

__all__ = ["LAUNCHES", "delta_decode", "delta_encode", "reset_launch_counts"]
