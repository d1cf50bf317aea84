"""The cost model (port of ``repro/analysis``): the roofline terms, the
per-card HBM estimate, the per-device operator counter beneath DTensor
(``aten_cost.py``, the counterpart of ``hlo.py``, which reads XLA's HLO),
the attention-quadratic probe (``quad_probe.py``) and the dry-run report
(``report.py``, a copy)."""
from .aten_cost import OpCounter, collective_wire_bytes
from .roofline import model_flops, roofline_terms

__all__ = ["OpCounter", "collective_wire_bytes", "model_flops", "roofline_terms"]
