"""whisper-small [audio] — encoder-decoder backbone (arXiv:2212.04356).
Conv/audio frontend is a STUB: input_specs supplies precomputed frame
embeddings (B, S, d) to the encoder."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-small", family="encdec", layers=12, enc_layers=12,
    dec_layers=12, d_model=768, n_heads=12, kv_heads=12, d_ff=3072,
    vocab=51865, act="gelu", rope_theta=10000.0, tie_embeddings=True,
)

SMOKE = CONFIG.scaled(layers=2, enc_layers=2, dec_layers=2, d_model=64,
                      n_heads=4, kv_heads=4, d_ff=128, vocab=128,
                      param_dtype="float32", compute_dtype="float32")

SKIPS = {"long_500k": "full attention enc-dec: 524288-token decode cache is "
                      "quadratic-history; sub-quadratic attention required"}
