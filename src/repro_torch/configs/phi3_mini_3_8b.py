"""phi3-mini-3.8b [dense] — RoPE SwiGLU, MHA (kv == q heads)
(arXiv:2404.14219)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="phi3-mini-3.8b", family="dense", layers=32, d_model=3072,
    n_heads=32, kv_heads=32, d_ff=8192, vocab=32064,
    rope_theta=10000.0, tie_embeddings=False,
)

SMOKE = CONFIG.scaled(layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
                      vocab=128, param_dtype="float32",
                      compute_dtype="float32")

SKIPS = {"long_500k": "pure full attention: sub-quadratic required"}
