"""Plain PyTorch reference of the timed training step, one module per
model family (``ssm``, ``hybrid``), the shared layers in ``common``."""
