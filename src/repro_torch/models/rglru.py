"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin,
arXiv:2402.19427; counterpart of ``repro.models.rglru``).

h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t),
a_t = exp(-c · softplus(Λ) · r_t),  r/i = sigmoid gates.

Prefill runs a log-depth (Hillis-Steele) scan over the sequence, where
the JAX package runs ``jax.lax.associative_scan``: the same linear
recurrence, combined in another order, so the two agree to float32
rounding, not bit for bit. Decode is the O(1) recurrence.
"""
from __future__ import annotations

import torch

from .layers import softplus, up32

C_FACTOR = 8.0


def _gates(x, r, i, lam):
    a = torch.exp(-C_FACTOR * softplus(lam) * torch.sigmoid(up32(r)))
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        torch.sigmoid(up32(i)) * up32(x))
    return a, gated


def rglru_scan(x, r, i, lam):
    """x, r, i: (B, S, D); lam: (D,) raw Λ. Returns (y, final_h): an
    inclusive Hillis-Steele scan, ceil(log2 S) rounds, each combining
    every position t with t - shift as ``(a1 * a2, b1 * a2 + b2)``."""
    aa, bb = _gates(x, r, i, lam[None, None])
    S = x.shape[1]
    shift = 1
    while shift < S:
        bb = torch.cat([bb[:, :shift],
                        bb[:, :-shift] * aa[:, shift:] + bb[:, shift:]], 1)
        aa = torch.cat([aa[:, :shift], aa[:, :-shift] * aa[:, shift:]], 1)
        shift *= 2
    return bb.to(x.dtype), up32(bb[:, -1])


def rglru_step(x, r, i, lam, h):
    """One-token step. x, r, i: (B, D); h: (B, D) float32."""
    a, gated = _gates(x, r, i, lam[None])
    h = a * h + gated
    return h.to(x.dtype), h
