"""Mamba2 SSD (state-space duality) block of the port (counterpart of
``repro.models.ssm``, the same math in plain PyTorch; the JAX block is
``jnp`` and a ``lax.scan``, no Pallas kernel).

The block decomposition of arXiv:2405.21060: within a chunk the output
is a masked quadratic form (matmuls); across chunks one recurrent state
(B, H, P, N) is carried by a sequential pass over the chunks (the JAX
package's ``lax.scan``). Decode is the O(1) recurrence
h = decay·h + dt·B⊗x.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import silu


class SSMCache(NamedTuple):
    h: torch.Tensor        # (B, H, P, N) recurrent state, float32
    conv: torch.Tensor     # (B, W-1, conv_dim) conv tail


def ssd_chunked(x, dt, A, B_, C_, D, chunk: int):
    """x: (B, S, H, P); dt: (B, S, H) (softplus applied); A: (H,) < 0;
    B_, C_: (B, S, N); D: (H,). Returns y (B, S, H, P) and the final state
    (B, H, P, N), float32."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    f32 = torch.float32
    xc = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = F.pad(dt, (0, 0, 0, pad)).reshape(Bsz, nc, chunk, H)
    Bc = F.pad(B_, (0, 0, 0, pad)).reshape(Bsz, nc, chunk, N).to(f32)
    Cc = F.pad(C_, (0, 0, 0, pad)).reshape(Bsz, nc, chunk, N).to(f32)

    dA = dtc * A[None, None, None, :]             # (B, nc, L, H), <= 0
    cs = torch.cumsum(dA, dim=2)                  # within-chunk cumulative

    # intra-chunk: L[i,j] = exp(cs_i - cs_j) for j <= i
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]   # (B,nc,L,L,H)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    Lmat = torch.where(causal, torch.exp(diff), 0.0)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)   # (B,nc,L,L)
    M = G[..., None] * Lmat                       # (B,nc,L,L,H)
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xdt)

    # chunk states: S_c = sum_j exp(cs_last - cs_j) * dt_j * B_j x_j^T
    decay_tail = torch.exp(cs[:, :, -1:, :] - cs)  # (B,nc,L,H)
    SB = torch.einsum("bclh,bcln,bclhp->bchpn", decay_tail * dtc, Bc, xc)

    # inter-chunk pass: h_c = exp(sum dA_c) * h_{c-1} + S_c
    chunk_decay = torch.exp(cs[:, :, -1, :])      # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    h_prevs = []                                  # the state before chunk c
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + SB[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)         # (B,nc,H,P,N)

    # inter-chunk contribution: y += C_i exp(cs_i) h_prev
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, h_prevs,
                           torch.exp(cs))
    y = y_intra + y_inter + xc * D[None, None, None, :, None]
    y = y.reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_decode_step(x, dt, A, B_, C_, D, h):
    """One-token recurrence. x: (B, H, P); dt: (B, H); B_, C_: (B, N);
    h: (B, H, P, N). Returns (y, h')."""
    dA = torch.exp(dt * A[None, :])                              # (B,H)
    hB = torch.einsum("bh,bn,bhp->bhpn", dt, B_.float(), x.float())
    h = h * dA[..., None, None] + hB
    y = torch.einsum("bn,bhpn->bhp", C_.float(), h)
    y = y + x.float() * D[None, :, None]
    return y.to(x.dtype), h


def causal_conv(x, w, cache=None):
    """Depthwise causal conv1d. x: (B, S, C); w: (W, C). cache: (B, W-1, C),
    the tail of the previous call (the JAX package reads it in prefill
    too). Returns (y, new_cache)."""
    W = w.shape[0]
    if cache is None:
        cache = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xx = torch.cat([cache, x], dim=1)
    S = x.shape[1]
    y = sum(xx[:, i:i + S] * w[i][None, None] for i in range(W))
    new_cache = xx[:, -(W - 1):] if W > 1 else cache
    return silu(y), new_cache
