from .loop import TrainRunResult, run_resilient_training

__all__ = ["TrainRunResult", "run_resilient_training"]
