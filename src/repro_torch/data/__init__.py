"""Data pipeline of the port: deterministic synthetic LM batches with
straggler-mitigation accounting."""

from .pipeline import DataConfig, LMDataPipeline

__all__ = ["DataConfig", "LMDataPipeline"]
