"""Shared model layers of the port: norms, RoPE / M-RoPE, chunked flash
attention (GQA; causal, bidirectional, sliding window), decode attention,
SwiGLU / GELU FFN. Counterpart of ``repro.models.layers``, the same math
in plain PyTorch (the JAX attention is ``jnp`` inside ``lax.scan``, no
Pallas kernel).

Pure functions over explicit param dicts. Every init helper also emits a
*logical sharding spec* (a tuple of logical axis names parallel to the
array's dims), as the JAX package does, for a later sharding slice.

Matrix products promote mixed operand dtypes as JAX does (a bfloat16
activation times a float32 weight computes in float32): ``mm``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30        # the JAX masks' fill


# ---------------------------------------------------------------------------
# init helpers (params + logical specs)
# ---------------------------------------------------------------------------

def dense_init(generator: Optional[torch.Generator], shape, dtype, spec,
               scale=None, device=None):
    """A normal draw in float32 from ``generator`` (on its device), cast to
    ``dtype`` and scaled by ``scale`` (default ``1 / sqrt(shape[0])``, as
    the JAX package: the leading dim, which is L for stacked layers). With
    no generator the draw is unseeded: for ``device="meta"``, where only
    the shape counts."""
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    if generator is not None:
        device = generator.device
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.to(dtype) * float(scale), spec


def split_tree(pairs):
    """dict of name -> (array, spec)  ->  (params dict, specs dict)."""
    params = {k: v[0] if isinstance(v, tuple) else split_tree(v)[0]
              for k, v in pairs.items()}
    specs = {k: v[1] if isinstance(v, tuple) else split_tree(v)[1]
             for k, v in pairs.items()}
    return params, specs


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two (JAX's rule; torch's
    matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rmsnorm(x, g, eps=1e-6):
    """Statistics in float32, products in ``x``'s dtype, in this order:
    ``x * r * g`` (a bfloat16 run drifts from the JAX one otherwise)."""
    x32 = x.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return x * r.to(x.dtype) * g.to(x.dtype)


def silu(x):
    """``jax.nn.silu``'s expression, ``x * sigmoid(x)`` with the sigmoid
    as ``1 / (1 + exp(-x))``: in bfloat16 each op rounds, as the JAX
    package's does (``F.silu`` rounds once and differs in 25-40% of
    bfloat16 elements)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(x, w1, w3, w2):
    h = silu(mm(x, w1)) * mm(x, w3)
    return mm(h, w2)


def gelu_mlp(x, w1, w2):
    return mm(F.gelu(mm(x, w1), approximate="tanh"), w2)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x, ang):
    """``x`` rotated by ``ang`` (..., S, Dh/2): the products promote a
    bfloat16 ``x`` to float32 (cos / sin are not cast down first); the
    result is cast back to ``x``'s dtype."""
    hd = x.shape[-1]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta):
    """x: (..., S, H, Dh); positions: (..., S) int."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * inv)


def apply_mrope(x, positions3, theta, sections):
    """Multimodal RoPE (qwen2-vl): positions3 (3, ..., S) for (t, h, w);
    frequency planes are partitioned into ``sections`` (halves of Dh/2)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    sec = torch.cumsum(torch.tensor((0,) + tuple(sections),
                                    device=x.device), 0)
    plane = torch.searchsorted(sec[1:], torch.arange(hd // 2,
                                                     device=x.device),
                               right=True).clamp(0, 2)
    pos = torch.movedim(positions3.float()[plane], 0, -1)
    return _rotate(x, pos * inv)


# ---------------------------------------------------------------------------
# chunked flash attention (GQA; causal / bidirectional / sliding window)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    q_offset: int = 0):
    """Online-softmax attention over (q chunk, kv chunk) blocks, the JAX
    package's double scan as two loops: the same blocks, masks and order.

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh) with Hq % Hkv == 0.
    ``q_offset`` is the absolute position of q[0] (prefill continuation).
    Padded KV positions are masked (``kv_valid``); masked scores are
    -1e30; the softmax statistics and the accumulator are float32.
    """
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    nq = -(-Sq // q_chunk)
    nk = -(-Skv // kv_chunk)
    scale = float(1.0 / np.sqrt(Dh))
    dev = q.device

    def blocks(t, n, c):        # (B, S, H, Dh) -> (n, B, H, c, Dh)
        t = F.pad(t, (0, 0, 0, 0, 0, n * c - t.shape[1]))
        return t.reshape(B, n, c, t.shape[2], Dh).permute(1, 0, 3, 2, 4)

    qs, ks, vs = blocks(q, nq, q_chunk), blocks(k, nk, kv_chunk), \
        blocks(v, nk, kv_chunk)
    kv_valid = torch.arange(nk * kv_chunk, device=dev) < Skv
    outs = []
    for qi in range(nq):
        qblk = qs[qi].float()
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, Hq, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, Hq, q_chunk), device=dev)
        acc = torch.zeros((B, Hq, q_chunk, Dh), device=dev)
        for ki in range(nk):
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            kg = ks[ki].repeat_interleave(G, dim=1).float()
            vg = vs[ki].repeat_interleave(G, dim=1).float()
            s = torch.einsum("bhqd,bhkd->bhqk", qblk, kg) * scale
            mask = kv_valid[kpos][None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vg)
            m = m_new
        outs.append((acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(
        B, nq * q_chunk, Hq, Dh)
    return out[:, :Sq]


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None):
    """Single-token decode: q (B, 1, Hq, Dh); caches (B, Smax, Hkv, Dh).

    cache_len: (B,) valid prefix length (the new token's position)."""
    B, _, Hq, Dh = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = float(1.0 / np.sqrt(Dh))
    pos = torch.arange(Smax, device=q.device)
    mask = pos[None, :] < cache_len[:, None]           # (B, Smax)
    if window is not None:
        mask = mask & (pos[None, :] > cache_len[:, None] - window)
    qh = q[:, 0].reshape(B, Hkv, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), k_cache.float()) * scale
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, Hq, Dh).to(q.dtype)
