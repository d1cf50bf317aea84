"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it. Entry points run on the card (``device=None`` means ``"cuda"``) unless
the caller passes ``device="cpu"``."""
