"""internlm2-1.8b [dense] — GQA (arXiv:2403.17297)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="internlm2-1.8b", family="dense", layers=24, d_model=2048,
    n_heads=16, kv_heads=8, d_ff=8192, vocab=92544,
    rope_theta=1e6, tie_embeddings=False,
)

SMOKE = CONFIG.scaled(layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
                      vocab=128, param_dtype="float32",
                      compute_dtype="float32")

SKIPS = {"long_500k": "pure full attention: sub-quadratic required"}
