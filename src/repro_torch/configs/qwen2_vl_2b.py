"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution backbone
(arXiv:2409.12191). Vision frontend is a stub: input_specs supplies
precomputed patch-grid M-RoPE position ids alongside token ids."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-vl-2b", family="vlm", layers=28, d_model=1536,
    n_heads=12, kv_heads=2, d_ff=8960, vocab=151936,
    qkv_bias=True, pos="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1e6, tie_embeddings=True,
)

SMOKE = CONFIG.scaled(layers=2, d_model=96, n_heads=6, kv_heads=2, d_ff=256,
                      vocab=128, mrope_sections=(4, 2, 2),
                      param_dtype="float32", compute_dtype="float32")

SKIPS = {"long_500k": "full attention (no windowing in published config): "
                      "524288-token decode cache is quadratic-history; "
                      "sub-quadratic attention required per assignment"}
