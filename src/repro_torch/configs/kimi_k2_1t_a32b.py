"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 384 experts top-8
(paper-table spec). head_dim 112 (7168/64)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="kimi-k2-1t-a32b", family="moe", layers=61, d_model=7168,
    n_heads=64, kv_heads=8, d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, capacity_factor=1.25,
    rope_theta=50000.0, tie_embeddings=False,
)

SMOKE = CONFIG.scaled(layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=64,
                      vocab=128, n_experts=8, top_k=2,
                      param_dtype="float32", compute_dtype="float32")

SKIPS = {"long_500k": "pure full attention: sub-quadratic required"}
