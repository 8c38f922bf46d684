"""deepseek-coder-33b [dense] — llama-arch GQA (arXiv:2401.14196)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="deepseek-coder-33b", family="dense", layers=62, d_model=7168,
    n_heads=56, kv_heads=8, d_ff=19200, vocab=32256,
    rope_theta=10000.0, tie_embeddings=False,
)

SMOKE = CONFIG.scaled(layers=2, d_model=64, n_heads=8, kv_heads=2, d_ff=192,
                      vocab=128, param_dtype="float32",
                      compute_dtype="float32")

SKIPS = {"long_500k": "pure full attention: sub-quadratic required"}
