from .trainer_so import MetricsStateObject, TrainerStateObject
from .delta import DeltaCheckpointCodec

__all__ = ["MetricsStateObject", "TrainerStateObject", "DeltaCheckpointCodec"]
