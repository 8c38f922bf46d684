"""qwen2.5-3b [dense] — GQA with QKV bias (hf:Qwen/Qwen2.5 family)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2.5-3b", family="dense", layers=36, d_model=2048,
    n_heads=16, kv_heads=2, d_ff=11008, vocab=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = CONFIG.scaled(layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=160,
                      vocab=128, param_dtype="float32",
                      compute_dtype="float32")

SKIPS = {"long_500k": "pure full attention: sub-quadratic required"}
