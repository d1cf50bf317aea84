from .loop import TrainRunResult, run_resilient_training
from .serve import DecodeSessionStateObject, ServeRunResult, run_speculative_serving

__all__ = ["DecodeSessionStateObject", "ServeRunResult", "TrainRunResult",
           "run_resilient_training", "run_speculative_serving"]
