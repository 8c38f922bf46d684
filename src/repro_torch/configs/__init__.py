"""Assigned-architecture registry of the port: 10 archs x their shape
sets (40 cells), the same data as ``repro.configs``.

Each ``<arch>.py`` defines CONFIG (exact published shape), SMOKE (reduced
same-family config for CPU smoke tests) and SKIPS (shape-cell skips with
rationale, per the assignment rules).
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from ..models.config import ModelConfig

# shape id -> (kind, seq_len, global_batch)
SHAPES: Dict[str, Tuple[str, int, int]] = {
    "train_4k": ("train", 4096, 256),
    "prefill_32k": ("prefill", 32768, 32),
    "decode_32k": ("decode", 32768, 128),
    "long_500k": ("decode", 524288, 1),
}

_MODULES = {
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-small": "whisper_small",
    "qwen2.5-3b": "qwen2_5_3b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "internlm2-1.8b": "internlm2_1_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}

ARCH_IDS = list(_MODULES)


def get_arch(arch_id: str):
    """Returns the arch module (CONFIG, SMOKE, SKIPS)."""
    mod = importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")
    return mod


def get_config(arch_id: str) -> ModelConfig:
    return get_arch(arch_id).CONFIG


def cells():
    """All (arch, shape) cells with skip rationale where applicable."""
    out = []
    for a in ARCH_IDS:
        mod = get_arch(a)
        skips = getattr(mod, "SKIPS", {})
        for s in SHAPES:
            out.append((a, s, skips.get(s)))
    return out
