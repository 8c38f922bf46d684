"""The LM models of the port (``dense`` and ``vlm`` families)."""
from .api import Model, build_model, param_counts
from .config import ModelConfig

__all__ = ["ModelConfig", "build_model", "Model", "param_counts"]
