"""The analytic cost model (port of ``repro/analysis``, its arithmetic
part): the roofline terms and the per-card HBM estimate. The modules that
read XLA's HLO (``hlo.py``, ``quad_probe.py``, ``report.py``) are not
ported."""
from .roofline import model_flops, roofline_terms

__all__ = ["model_flops", "roofline_terms"]
