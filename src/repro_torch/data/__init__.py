from .pipeline import SyntheticDataPipeline

__all__ = ["SyntheticDataPipeline"]
