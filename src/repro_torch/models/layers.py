"""Shared model layers of the port: norms, RoPE / M-RoPE, chunked flash
attention (GQA; causal, bidirectional, sliding window), decode attention,
SwiGLU / GELU FFN, MoE dispatch. Counterpart of ``repro.models.layers``,
the same math in plain PyTorch (the JAX attention and MoE are ``jnp``,
inside ``lax.scan`` for the attention; no Pallas kernel).

Pure functions over explicit param dicts. Every init helper also emits a
*logical sharding spec* (a tuple of logical axis names parallel to the
array's dims), as the JAX package does, for a later sharding slice.

Matrix products promote mixed operand dtypes as JAX does (a bfloat16
activation times a float32 weight computes in float32): ``mm``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.local_ops import mean_last, reduced

NEG_INF = -1e30        # the JAX masks' fill


# ---------------------------------------------------------------------------
# init helpers (params + logical specs)
# ---------------------------------------------------------------------------

# a leaf of more elements is drawn in slices of its leading dims, each of
# at most this many (a 1 GB float32 temporary, not one the leaf's size)
INIT_SLICE = 1 << 28


def dense_init(generator: Optional[torch.Generator], shape, dtype, spec,
               scale=None, device=None):
    """A normal draw in float32 from ``generator`` (on its device), cast to
    ``dtype`` and scaled by ``scale`` (default ``1 / sqrt(shape[0])``, as
    the JAX package: the leading dim, which is L for stacked layers). With
    no generator the draw is unseeded: for ``device="meta"``, where only
    the shape counts. A leaf of over ``INIT_SLICE`` elements is drawn in
    slices of whole rows (its last dim), one after another from the same
    generator, into a tensor of ``dtype``."""
    scale = float(scale if scale is not None else 1.0 / np.sqrt(shape[0]))
    if generator is not None:
        device = generator.device
    n = math.prod(shape)
    if n <= INIT_SLICE or str(device) == "meta":
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.to(dtype) * scale, spec
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, shape[-1])
    step = max(1, INIT_SLICE // shape[-1])
    for lo in range(0, rows.shape[0], step):
        part = rows[lo:lo + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=device)
                   .to(dtype) * scale)
    return out, spec


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

def up32(x):
    """``x`` in float32, the JAX package's ``astype(float32)`` for its
    statistics, logits and attention; a float64 tensor stays float64 (a
    float64 model, the reference of a float32 gate, computes in float64
    throughout; JAX never meets one)."""
    return x if x.dtype == torch.float64 else x.float()


def rmsnorm(x, g, eps=1e-6):
    """Statistics in float32 (``up32``), products in ``x``'s dtype, in this
    order: ``x * r * g`` (a bfloat16 run drifts from the JAX one
    otherwise). On DTensors a partial sum is reduced first
    (``dist.local_ops.reduced``), and the mean of a row split over ranks
    is an all-reduce of one sum a row (``dist.local_ops.mean_last``)."""
    x = reduced(x)
    x32 = up32(x)
    r = torch.rsqrt(mean_last(x32 * x32) + eps)
    return x * r.to(x.dtype) * g.to(x.dtype)


def silu(x):
    """``jax.nn.silu``'s expression, ``x * sigmoid(x)`` with the sigmoid
    as ``1 / (1 + exp(-x))``: in bfloat16 each op rounds, as the JAX
    package's does (``F.silu`` rounds once and differs in 25-40% of
    bfloat16 elements)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x):
    """``jax.nn.gelu``'s tanh form, op by op (in bfloat16 each op rounds,
    as the JAX package's; ``F.gelu(approximate="tanh")`` rounds once)."""
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3))))
    return x * cdf


def softplus(x):
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|))
    (``F.softplus`` switches to ``x`` past 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def swiglu(x, w1, w3, w2):
    h = silu(mm(x, w1)) * mm(x, w3)
    return mm(h, w2)


def gelu_mlp(x, w1, w2):
    return mm(gelu(mm(x, w1)), w2)


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
    -1e30; the softmax statistics and the accumulator are float32
    (``up32``).
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
        if n * c > t.shape[1]:
            t = F.pad(t, (0, 0, 0, 0, 0, n * c - t.shape[1]))
        return t.reshape(B, n, c, t.shape[2], Dh).permute(1, 0, 3, 2, 4)

    qs, ks, vs = blocks(q, nq, q_chunk), blocks(k, nk, kv_chunk), \
        blocks(v, nk, kv_chunk)
    kv_valid = torch.arange(nk * kv_chunk, device=dev) < Skv
    outs = []
    for qi in range(nq):
        qblk = up32(qs[qi])
        f = dict(dtype=qblk.dtype, device=dev)
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, Hq, q_chunk), NEG_INF, **f)
        l = torch.zeros((B, Hq, q_chunk), **f)
        acc = torch.zeros((B, Hq, q_chunk, Dh), **f)
        for ki in range(nk):
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            kg = up32(ks[ki].repeat_interleave(G, dim=1))
            vg = up32(vs[ki].repeat_interleave(G, dim=1))
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
    Scores, softmax and sum in float32 (``up32``).

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
    s = torch.einsum("bkgd,bskd->bkgs", up32(qh), up32(k_cache)) * scale
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, up32(v_cache))
    return o.reshape(B, 1, Hq, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, capacity-based, sort-based dispatch)
# ---------------------------------------------------------------------------

def moe_capacity(T: int, top_k: int, E: int, capacity_factor: float) -> int:
    """Slots an expert serves in a call of ``T`` tokens: JAX's
    ``max(1, ceil(T * k / E * cf))``. It depends on the call: the tokens
    of a batch compete for the same slots."""
    return max(1, int(np.ceil(T * top_k / E * capacity_factor)))


def moe_route(logits, top_k: int, C: int, offsets=None):
    """The dispatch of ``moe_ffn`` from router ``logits`` (..., T, E)
    float32 (leading dims: independent token groups, such as the shards
    of ``models.moe_a2a``): ``lax.top_k`` (a stable descending sort: a
    tie goes to the lower expert), the softmax gates over the k chosen,
    then the (token, expert) pairs stably sorted by expert, each pair's
    rank among its expert's pairs (a segmented iota via ``cummax``), and
    its slot ``e * C + rank`` where the rank is under ``C`` (else the
    overflow slot ``E * C``).

    ``offsets``, given, maps the pairs' experts in token order (..., T *
    k) to a count per expert (..., E) that is added to each pair's rank:
    the same experts' pairs on the token shards before these tokens
    (``dist.local_ops.moe_dense``), so that the rank is the pair's rank
    in the stable sort of all shards' pairs.

    Returns ``dict(gidx, gates, stt, sg, rank, keep, slot)``: gidx / gates
    (..., T, k); the rest (..., T * k) in expert order, ``stt`` the token
    and ``sg`` the gate of each pair."""
    T, E = logits.shape[-2:]
    lead = logits.shape[:-2]
    gval, gidx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gval, gidx = gval[..., :top_k], gidx[..., :top_k]
    gates = torch.softmax(gval, dim=-1)
    dev = logits.device
    flat_e = gidx.reshape(lead + (T * top_k,))
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = torch.gather(flat_e, -1, order)
    stt = torch.div(order, top_k, rounding_mode="floor")
    sg = torch.gather(gates.reshape(lead + (T * top_k,)), -1, order)
    idx = torch.arange(T * top_k, device=dev).expand(se.shape)
    first = torch.ones_like(se, dtype=torch.bool)
    first[..., 1:] = torch.logical_not(se[..., 1:] == se[..., :-1])
    seg_start = torch.cummax(torch.where(first, idx, 0), dim=-1).values
    rank = idx - seg_start
    if offsets is not None:
        rank = rank + torch.gather(offsets(flat_e), -1, se)
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)
    return dict(gidx=gidx, gates=gates, stt=stt, sg=sg, rank=rank,
                keep=keep, slot=slot)


def moe_dispatch(xf, r, E: int, C: int, dtype):
    """The capacity buffers of routed tokens: ``xf`` (..., T, d), ``r``
    from ``moe_route`` -> (..., E, C, d) in ``dtype``, each kept pair's
    token in its slot, empty slots zero (JAX's ``.at[slot].set(...,
    mode="drop")``). Every pair is written into a buffer with one extra
    row, the overflow slot ``E * C``, which is then cut off: no
    data-dependent shape (a fake tensor of the dry run has no data)."""
    lead, d = xf.shape[:-2], xf.shape[-1]
    rows = torch.gather(xf.to(dtype), -2, r["stt"][..., None].expand(
        r["stt"].shape + (d,)))
    buf = torch.zeros(lead + (E * C + 1, d), dtype=dtype, device=xf.device)
    buf.scatter_(-2, r["slot"][..., None].expand(rows.shape), rows)
    return buf[..., :E * C, :].reshape(lead + (E, C, d))


def moe_experts(buf, w1, w3, w2, dtype):
    """Every expert's SwiGLU FFN on its slots: buf (..., E, C, d), w1 / w3
    (..., E, d, f), w2 (..., E, f, d) -> (..., E, C, d)."""
    h = silu(torch.einsum("...ecd,...edf->...ecf", buf, w1.to(dtype))) * \
        torch.einsum("...ecd,...edf->...ecf", buf, w3.to(dtype))
    return torch.einsum("...ecf,...efd->...ecd", h, w2.to(dtype))


def moe_combine(y, r, T: int, dtype):
    """Each token's gated sum of its kept pairs' expert outputs: y (...,
    E * C, d), ``r`` from ``moe_route`` -> (..., T, d) (a scatter-add:
    on CUDA not order-stable, so a tolerance, not bit-exact)."""
    n_slots, d = y.shape[-2:]
    slot = r["slot"].clamp(0, n_slots - 1)[..., None]
    gathered = torch.gather(y, -2, slot.expand(slot.shape[:-1] + (d,)))
    contrib = torch.where(r["keep"][..., None],
                          gathered * r["sg"][..., None].to(dtype), 0)
    out = torch.zeros(y.shape[:-2] + (T, d), dtype=dtype, device=y.device)
    return out.scatter_add_(-2, r["stt"][..., None].expand(contrib.shape),
                            contrib)


def moe_ffn(x, router_w, w1, w3, w2, *, top_k: int, capacity_factor: float,
            dtype):
    """x: (B, S, d); router_w: (d, E); w1/w3: (E, d, f); w2: (E, f, d).

    Sort-based capacity dispatch (``moe_route``): tokens pick top-k
    experts; each expert serves at most C tokens, the overflow is dropped
    (JAX's ``mode="drop"`` scatter, ``moe_dispatch``). Every expert's FFN
    runs on its C slots (einsums over all E experts: every expert weight
    is read), the outputs are gathered back, scaled by the gates and
    scatter-added per token (``moe_combine``). Returns (y, the
    load-balance loss)."""
    B, S, d = x.shape
    E = router_w.shape[1]
    T = B * S
    xf = x.reshape(T, d)
    logits = mm(up32(xf), up32(router_w))
    C = moe_capacity(T, top_k, E, capacity_factor)
    r = moe_route(logits, top_k, C)
    y = moe_experts(moe_dispatch(xf, r, E, C, dtype), w1, w3, w2, dtype)
    out = moe_combine(y.reshape(E * C, d), r, T, dtype)
    aux = _load_balance_loss(logits, r["gidx"], E)
    return out.reshape(B, S, d), aux


def _load_balance_loss(logits, gidx, E):
    """E x sum(mean router prob x share of picks) per token group:
    logits (..., T, E), gidx (..., T, k) -> (...)."""
    probs = torch.softmax(logits, dim=-1)
    pe = probs.mean(dim=-2)
    flat = gidx.reshape(gidx.shape[:-2] + (-1,))
    hits = torch.zeros(pe.shape, dtype=pe.dtype, device=logits.device)
    hits.scatter_add_(-1, flat, torch.ones(flat.shape, dtype=pe.dtype,
                                           device=logits.device))
    fe = hits / torch.clamp_min(hits.sum(dim=-1, keepdim=True), 1.0)
    return E * torch.sum(pe * fe, dim=-1)
