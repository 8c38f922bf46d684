"""Gradient compression of the port (counterpart of
``repro.dist.compress``): symmetric-scale int8 quantization.

``q = round(x / s)`` with ``s = max|x| / 127`` maps the tensor onto
[-127, 127] with reconstruction error at most ``s / 2`` per element.
Feeding the residual ``x - dequantize(quantize(x))`` back into the next
step (:func:`error_feedback`) telescopes, so the accumulated compressed
signal tracks the accumulated true signal to within one residual. Codes
and scales equal the JAX package's bit for bit: the same float32
division, and ``torch.round`` rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["quantize_int8", "dequantize_int8", "error_feedback"]


def quantize_int8(x: torch.Tensor, axis: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale float32). ``axis=None`` uses one tensor-wide
    scale; an int axis computes per-slice scales along that axis (kept
    broadcastable so ``dequantize_int8(q, s)`` works unchanged)."""
    x32 = x.float()
    amax = x32.abs().amax() if axis is None else \
        x32.abs().amax(dim=axis, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, 1.0).float()
    q = torch.round(x32 / s)
    return torch.clamp(q, -127, 127).to(torch.int8), s


def dequantize_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def error_feedback(g: torch.Tensor, residual: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback step: compress ``g + residual``, return the
    decompressed signal to apply and the new residual to carry."""
    corrected = g + residual
    deq = dequantize_int8(*quantize_int8(corrected))
    return deq, corrected - deq
