"""Open-addressing hash vertex index (the multi-level-vector family's ID
translation layer — paper §2.2, Fig. 8d/e context); port of
``repro.baselines.hash_index`` on tensors of an explicit device.

Linear probing over a power-of-two table; batched inserts claim slots
over bounded probe rounds (conflicting claimants within a round are
resolved by a deterministic scatter and retried next round — the batched
analogue of CAS retry loops).

The key words are uint32 in the JAX package; here each is an int64
masked to 32 bits (``EMPTY`` = 0xFFFFFFFF), and ``_mix`` multiplies in
16-bit halves so no product leaves int64. Where several batch elements
write one slot in one scatter, the LAST in batch order wins, as XLA's
scatter picks it; the winner is resolved first (``_set_last_``), for
the two key words together, so a slot never holds a torn key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core.keys import pack_keys
from ..core.tensor_ops import I32, I64

__all__ = ["EMPTY", "HashState", "HashIndex"]

EMPTY = 0xFFFFFFFF
_M32 = 0xFFFFFFFF


class HashState(NamedTuple):
    khi: torch.Tensor   # int64[cap], uint32 words
    klo: torch.Tensor   # int64[cap]
    val: torch.Tensor   # int32[cap]
    used: torch.Tensor  # int32 scalar
    overflow: torch.Tensor


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for uint32 words ``a`` and constant ``c``."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(hi: torch.Tensor, lo: torch.Tensor, cap: int) -> torch.Tensor:
    h = _mul32(hi ^ 0x9E3779B9, 0x85EBCA6B)
    h = _mul32(h ^ lo, 0xC2B2AE35)
    h = h ^ (h >> 13)
    return h & (cap - 1)


def _set_last_(pairs, idx: torch.Tensor, ok: torch.Tensor, cap: int):
    """``dst.at[where(ok, idx, cap)].set(src, mode="drop")`` for each
    ``(dst, src)`` of ``pairs``, with XLA's winner: of the ok rows aiming
    at one slot, the last in batch order. Only the ok rows take part (one
    host sync to find them), so the rows dropped in JAX pile onto no
    address; every ok row writes its slot's winning value, so duplicate
    targets carry equal values."""
    sel = ok.nonzero().squeeze(1)
    if not sel.numel():
        return
    tgt = idx[sel]
    win = torch.full((cap,), -1, dtype=I64, device=idx.device)
    win.scatter_reduce_(0, tgt, sel, reduce="amax")
    w = win[tgt]
    for dst, src in pairs:
        dst[tgt] = src[w]


def _hash_lookup(cap: int, rounds: int, st: HashState,
                 keys: torch.Tensor) -> torch.Tensor:
    B = keys.shape[0]
    hi, lo = keys[:, 0], keys[:, 1]
    h0 = _mix(hi, lo, cap)
    out = torch.full((B,), -1, dtype=I32, device=keys.device)
    done = torch.zeros((B,), dtype=torch.bool, device=keys.device)
    for r in range(rounds):
        slot = (h0 + r) & (cap - 1)
        k_hi, k_lo = st.khi[slot], st.klo[slot]
        is_hit = (k_hi == hi) & (k_lo == lo)
        is_empty = (k_hi == EMPTY) & (k_lo == EMPTY)
        out = torch.where(~done & is_hit, st.val[slot], out)
        done = done | is_hit | is_empty
    return out


def _hash_insert(cap: int, rounds: int, st: HashState, keys: torch.Tensor,
                 vals: torch.Tensor) -> HashState:
    """Insert (or update) ``keys`` -> ``vals`` over ``rounds`` probe
    rounds; updates the state's tables in place and returns the state with
    its new counters."""
    B = keys.shape[0]
    hi, lo = keys[:, 0], keys[:, 1]
    h0 = _mix(hi, lo, cap)
    placed = torch.zeros((B,), dtype=torch.bool, device=keys.device)
    khi, klo, val = st.khi, st.klo, st.val
    for r in range(rounds):
        slot = (h0 + r) & (cap - 1)
        k_hi, k_lo = khi[slot], klo[slot]
        is_hit = (k_hi == hi) & (k_lo == lo)        # key already present
        _set_last_([(val, vals)], slot, ~placed & is_hit, cap)
        placed = placed | is_hit
        is_empty = (k_hi == EMPTY) & (k_lo == EMPTY)
        want = ~placed & is_empty
        # deterministic claim: one batch element keeps each slot, the
        # others see a foreign key next round and probe on
        _set_last_([(khi, hi), (klo, lo)], slot, want, cap)  # both words
        won = want & (khi[slot] == hi) & (klo[slot] == lo)
        _set_last_([(val, vals)], slot, won, cap)
        placed = placed | won
    n_new = placed.to(I32).sum()       # upper bound incl. updates
    return HashState(khi, klo, val, st.used + n_new,
                     st.overflow + (~placed).to(I32).sum())


@dataclass
class HashIndex:
    """Open-addressing vertex index: ID -> int32 offset (-1 absent), on
    ``device`` (default the card; raises without one)."""

    n_max: int
    key_bits: int = 32
    rounds: int = 64
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        cap = 1
        while cap < self.n_max * 2:
            cap <<= 1
        self.cap = cap
        dev = self.device
        self.state = HashState(
            khi=torch.full((cap,), EMPTY, dtype=I64, device=dev),
            klo=torch.full((cap,), EMPTY, dtype=I64, device=dev),
            val=torch.full((cap,), -1, dtype=I32, device=dev),
            used=torch.zeros((), dtype=I32, device=dev),
            overflow=torch.zeros((), dtype=I32, device=dev),
        )

    def _keys(self, ids) -> torch.Tensor:
        return pack_keys(np.asarray(ids, np.uint64), self.key_bits,
                         self.device)

    def insert(self, ids, offsets):
        vals = torch.as_tensor(np.asarray(offsets, np.int32),
                               device=self.device)
        self.state = _hash_insert(self.cap, self.rounds, self.state,
                                  self._keys(ids), vals)

    def lookup(self, ids) -> np.ndarray:
        return _hash_lookup(self.cap, self.rounds, self.state,
                            self._keys(ids)).cpu().numpy()

    def memory_bytes(self) -> int:
        return self.cap * (4 + 4 + 4)
