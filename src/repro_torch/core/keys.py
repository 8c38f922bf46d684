"""Vertex-ID key handling (port of ``repro.core.keys``).

IDs live in a universe [0, 2^x). Keys keep the JAX package's ``(..., 2)``
``[hi, lo]`` layout (hi = bits 32..63, lo = bits 0..31) so SORT slot
indices match exactly, but each word is held in an **int64** tensor
masked to 32 bits: torch's ``uint32`` lacks most CUDA operators.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import resolve_device

__all__ = ["pack_keys", "unpack_keys", "extract_bits", "layer_bit_offsets"]

_MASK32 = 0xFFFFFFFF


def pack_keys(ids, key_bits: int, device="cuda") -> torch.Tensor:
    """Python/numpy ints (or uint32/uint64 array) -> (..., 2) int64 keys
    on ``device``."""
    device = resolve_device(device)
    arr = np.asarray(ids, dtype=np.uint64)
    if key_bits < 64 and int(arr.max(initial=0)) >= (1 << key_bits):
        raise ValueError("ID exceeds universe")
    hi = (arr >> np.uint64(32)).astype(np.int64)
    lo = (arr & np.uint64(_MASK32)).astype(np.int64)
    return torch.from_numpy(np.stack([hi, lo], axis=-1)).to(device)


def unpack_keys(keys) -> np.ndarray:
    """(..., 2) keys (tensor or array) -> numpy uint64."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    k = np.asarray(keys).astype(np.uint64)
    return (k[..., 0] << np.uint64(32)) | k[..., 1]


def extract_bits(keys: torch.Tensor, start_lsb: int, width: int
                 ) -> torch.Tensor:
    """Extract ``width`` bits whose least-significant absolute bit index is
    ``start_lsb`` (0 = LSB of the 64-bit value). Returns int32 in
    [0, 2^width)."""
    if not 0 <= width <= 31:
        raise ValueError("layer fanout bits must fit int32")
    hi, lo = keys[..., 0], keys[..., 1]
    mask = (1 << width) - 1
    if width == 0:
        return torch.zeros(hi.shape, dtype=torch.int32, device=keys.device)
    if start_lsb >= 32:
        v = (hi >> (start_lsb - 32)) & mask
    elif start_lsb + width <= 32:
        v = (lo >> start_lsb) & mask
    else:  # spans the word boundary
        lo_bits = 32 - start_lsb
        low_part = lo >> start_lsb
        high_part = hi & ((1 << (start_lsb + width - 32)) - 1)
        v = (high_part << lo_bits) | low_part
    return v.to(torch.int32)


def layer_bit_offsets(fanout_bits: Sequence[int], key_bits: int):
    """LSB offset of each layer's segment. Layer 0 owns the top ``a_0`` bits
    of the x-bit key; when sum(a) > x the key is logically left-padded with
    zeros (the root layer simply has dead high branches)."""
    total = sum(fanout_bits)
    if total > 64:
        raise ValueError("configuration exceeds 64-bit container")
    offs = []
    consumed = 0
    for a in fanout_bits:
        offs.append(total - consumed - a)
        consumed += a
    return offs
