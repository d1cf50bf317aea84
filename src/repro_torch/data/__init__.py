from .pipeline import DataPipelineStateObject, SyntheticLMData

__all__ = ["DataPipelineStateObject", "SyntheticLMData"]
