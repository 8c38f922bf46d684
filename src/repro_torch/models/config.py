"""Model configuration of the port, field for field as
``repro.models.config.ModelConfig``: the same names, types and defaults,
with ``pdt`` / ``cdt`` returning ``torch.dtype``s."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    arch: str                      # config id, e.g. 'qwen2.5-3b'
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention / position
    rope_theta: float = 1e6
    qkv_bias: bool = False
    pos: str = "rope"              # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    window: Optional[int] = None   # sliding-window size for local attention

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "auto"

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    ssm_expand: int = 2

    # hybrid (recurrentgemma): layer pattern unit, e.g. ('rec','rec','attn')
    pattern: Tuple[str, ...] = ()
    lru_width: Optional[int] = None

    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0

    # misc
    act: str = "swiglu"            # swiglu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # attention chunking (flash-style blocks)
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 512
    # long-context capability: True iff decode state is sub-quadratic in ctx
    subquadratic: bool = False
    unroll_layers: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return replace(self, **kw)
