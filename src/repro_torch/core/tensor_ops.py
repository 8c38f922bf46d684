"""Tensor helpers that give JAX's indexing semantics without a host sync.

The JAX package relies on three behaviours that PyTorch does not share:

* ``x.at[idx].set(v, mode="drop")`` silently drops out-of-range (sentinel)
  targets, where ``index_put_`` raises on the CPU and device-asserts on
  CUDA. ``scatter_set_`` / ``scatter_add_`` take an explicit ``ok`` mask
  instead and redirect every masked-off row onto a harmless write (a copy
  of the first valid row, or a zero add), so no boolean indexing — and no
  device->host sync — is needed;
* ``jnp.nonzero(size=, fill_value=)`` has a static shape;
  ``nonzero_static`` reproduces it with a cumsum and a scatter;
* ``jnp.lexsort`` has no torch counterpart: ``lexsort`` chains stable
  sorts from the least-significant key.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["I32", "I64", "scatter_set_", "scatter_add_", "nonzero_static",
           "lexsort", "cdiv", "shift_prev", "shift_next"]

I32 = torch.int32
I64 = torch.int64

# scatters of at least this many rows (full-pool rebuilds, snapshots) drop
# their masked-off rows with one host sync instead of redirecting them:
# millions of redirected rows would all store to one address
SYNC_ROWS = 1 << 20


def _prep(t: torch.Tensor, idx, val, ok: torch.Tensor):
    idx = idx if isinstance(idx, tuple) else (idx,)
    ok = ok.reshape(-1)
    m = ok.numel()
    idx = tuple(i.reshape(-1).to(I64) for i in idx)
    for d, i in enumerate(idx):     # out-of-range targets drop, as in JAX
        ok = ok & (i >= 0) & (i < t.shape[d])
    rest = tuple(t.shape[len(idx):])
    if not isinstance(val, torch.Tensor):   # fill on the device, no copy
        val = torch.full((), val, dtype=t.dtype, device=t.device)
    val = val.to(t.dtype)
    if val.dim() == 0:
        val = val.expand((m,) + rest)
    else:
        val = val.reshape((m,) + rest)
    return idx, val, ok, m, rest


def scatter_set_(t: torch.Tensor, idx, val, ok: torch.Tensor) -> torch.Tensor:
    """In place: ``t[idx[r]] = val[r]`` for every row ``r`` with ``ok[r]``
    (``idx`` is one index tensor or a tuple of them; ``val`` a scalar or one
    value, or one trailing slice, per row). Rows with ``ok`` false, or
    with an index out of range, are dropped, like JAX's ``mode="drop"``.
    Duplicate valid targets must carry equal values, as in JAX."""
    idx, val, ok, m, rest = _prep(t, idx, val, ok)
    if m == 0:
        return t
    if m >= SYNC_ROWS:
        sel = ok.nonzero().squeeze(1)
        t.index_put_(tuple(i[sel] for i in idx), val[sel])
        return t
    # first valid row (0 if none); index_select keeps it on the device
    # (indexing with a 0-dim tensor would fetch it to the host)
    j = torch.argmax(ok.to(I32)).reshape(1)
    any_ok = ok.index_select(0, j)
    fidx = tuple(torch.where(any_ok, i.index_select(0, j), 0) for i in idx)
    bshape = (1,) + (1,) * len(rest)
    fval = torch.where(any_ok.view(bshape), val.index_select(0, j),
                       t[(0,) * len(idx)])
    okb = ok.view((m,) + (1,) * len(rest))
    t.index_put_(tuple(torch.where(ok, i, f) for i, f in zip(idx, fidx)),
                 torch.where(okb, val, fval))
    return t


def scatter_add_(t: torch.Tensor, idx, val, ok: torch.Tensor) -> torch.Tensor:
    """In place: ``t[idx] += val`` element-wise (one index per dimension of
    the contiguous ``t``) for rows with ``ok[r]`` and an index in range.
    The rest add zero at spread-out positions, so they neither change
    ``t`` nor pile onto one address; integer adds are exact in any
    order."""
    idx, val, ok, m, rest = _prep(t, idx, val, ok)
    if m == 0:
        return t
    if rest or not t.is_contiguous():
        raise ValueError("scatter_add_ needs one index per dimension of a "
                         "contiguous tensor")
    lin = torch.zeros_like(idx[0])
    for d, i in enumerate(idx):
        lin = lin * t.shape[d] + torch.where(ok, i, 0)
    spread = torch.arange(m, dtype=I64, device=t.device) % t.numel()
    t.view(-1).index_add_(0, torch.where(ok, lin, spread),
                          torch.where(ok, val, torch.zeros_like(val)))
    return t


def nonzero_static(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]`` as int64: the
    first ``size`` True positions of the 1-D ``mask``, padded with
    ``fill``. Static shape, no host sync."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(I64), 0) - 1
    tgt = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=I64, device=mask.device)
    out.scatter_(0, tgt, torch.arange(n, dtype=I64, device=mask.device))
    return out[:size]


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the LAST key is primary; stable."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def cdiv(a, b):
    return (a + b - 1) // b


def shift_prev(x: torch.Tensor, fill) -> torch.Tensor:
    """``concatenate([[fill], x[:-1]])`` along the last axis."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def shift_next(x: torch.Tensor, fill) -> torch.Tensor:
    """``concatenate([x[1:], [fill]])`` along the last axis."""
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x[..., 1:], pad], dim=-1)
