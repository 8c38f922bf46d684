"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent :
1 local-attention pattern (arXiv:2402.19427)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="recurrentgemma-9b", family="hybrid", layers=38, d_model=4096,
    n_heads=16, kv_heads=1, d_ff=12288, vocab=256000,
    pattern=("rec", "rec", "attn"), window=2048, lru_width=4096,
    conv_width=4, rope_theta=10000.0, tie_embeddings=True,
    subquadratic=True,  # RG-LRU state + 2048-window local attention
)

SMOKE = CONFIG.scaled(layers=6, d_model=64, n_heads=4, kv_heads=1, d_ff=128,
                      vocab=128, lru_width=64, window=16,
                      param_dtype="float32", compute_dtype="float32")

SKIPS = {}
