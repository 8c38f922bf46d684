"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, early fusion
(hf:meta-llama/Llama-4 family). Per the assignment spec every layer is MoE
with per-expert d_ff=8192; the resulting total parameter count from these
published dims is reported by api.param_counts (the marketing '400b' name is
nominal)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="llama4-maverick-400b-a17b", family="moe", layers=48, d_model=5120,
    n_heads=40, kv_heads=8, d_ff=8192, vocab=202048,
    n_experts=128, top_k=1, capacity_factor=1.25,
    rope_theta=500000.0, tie_embeddings=False,
)

SMOKE = CONFIG.scaled(layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=96,
                      vocab=128, n_experts=8, top_k=1,
                      param_dtype="float32", compute_dtype="float32")

SKIPS = {"long_500k": "pure full attention: sub-quadratic required"}
