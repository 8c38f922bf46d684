"""The LM models of the port: every family of ``repro.models`` (dense,
vlm, moe, ssm, hybrid, encdec)."""
from .api import Model, build_model, param_counts
from .config import ModelConfig

__all__ = ["ModelConfig", "build_model", "Model", "param_counts"]
