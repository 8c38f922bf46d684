"""mamba2-1.3b [ssm] — SSD, attention-free (arXiv:2405.21060)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-1.3b", family="ssm", layers=48, d_model=2048,
    n_heads=0, kv_heads=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    conv_width=4, tie_embeddings=True, pos="none",
    subquadratic=True,
)

SMOKE = CONFIG.scaled(layers=2, d_model=64, vocab=128, ssm_state=16,
                      ssm_head_dim=16, ssm_chunk=8,
                      param_dtype="float32", compute_dtype="float32")

SKIPS = {}  # SSM decode state is O(1) in context — long_500k runs
