"""ART: adaptive radix tree baseline (paper §2.1, Table 5, §4.7); port of
``repro.baselines.art`` on tensors of an explicit device.

Faithful-in-spirit port of unodb-style ART to flat arrays: 8 bits per
layer; every node starts *sparse* (16-slot key+child arrays, linear scan —
models Node4/16) and metamorphoses to *dense* (256-slot pointer array —
models Node48/256) when it overflows. This reproduces the two effects the
paper measures: (1) scan cost on lookups through sparse nodes, (2)
resize/migrate cost on inserts — versus SORT's fixed-structure gathers.

Node ids are stable; metamorphosis allocates a dense row and flips a
per-node mode bit (``dense_of`` indirection), so parents never need
re-pointing. The abandoned sparse row is accounted as freed.

Inserts are batched-sequential — the per-key structural modification of
pointer ARTs under a writer lock — through ``kernels.art.art_insert``: one
CUDA kernel launch for the whole batch on a card, the plain per-key loop
on the CPU; both update the state in place. Lookups are vectorised, one
pass per layer. The key words are int64 masked to 32 bits (uint32 in the
JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.keys import pack_keys
from ..core.tensor_ops import I32, I64
from ..kernels.art import SPARSE_CAP, art_insert

__all__ = ["SPARSE_CAP", "ArtState", "TorchART"]


class ArtState(NamedTuple):
    skeys: Tuple[torch.Tensor, ...]    # int32[cap_s, 16] radix bytes, -1 empty
    schild: Tuple[torch.Tensor, ...]   # int32[cap_s, 16] child node id / offset
    dense_of: Tuple[torch.Tensor, ...]  # int32[cap_s] dense row of node, -1 sparse
    dchild: Tuple[torch.Tensor, ...]   # int32[cap_d, 256]
    scount: torch.Tensor               # int32[l]
    dcount: torch.Tensor               # int32[l]
    overflow: torch.Tensor


@dataclass
class TorchART:
    """ART vertex index: ID -> int32 offset (-1 absent), on ``device``
    (default the card; raises without one)."""

    n_max: int
    key_bits: int = 32
    dense_frac: float = 0.25  # dense-row capacity as a fraction of n_max
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.layers = (self.key_bits + 7) // 8
        cap_s = self.n_max + 2
        cap_d = max(64, int(self.n_max * self.dense_frac))
        l, dev = self.layers, self.device

        def full(shape):
            return torch.full(shape, -1, dtype=I32, device=dev)
        scount = torch.zeros((l,), dtype=I32, device=dev)
        scount[0] = 1                                  # root = node 0
        self.state = ArtState(
            skeys=tuple(full((cap_s, SPARSE_CAP)) for _ in range(l)),
            schild=tuple(full((cap_s, SPARSE_CAP)) for _ in range(l)),
            dense_of=tuple(full((cap_s,)) for _ in range(l)),
            dchild=tuple(full((cap_d, 256)) for _ in range(l)),
            scount=scount,
            dcount=torch.zeros((l,), dtype=I32, device=dev),
            overflow=torch.zeros((), dtype=I32, device=dev),
        )

    def _bytes_of(self, keys: torch.Tensor) -> torch.Tensor:
        """(B, layers) int32 radix bytes, MSB-aligned to key_bits."""
        out = []
        for i in range(self.layers):
            shift = max(self.key_bits - 8 * (i + 1), 0)
            if shift >= 32:
                b = (keys[:, 0] >> (shift - 32)) & 255
            elif shift + 8 <= 32:
                b = (keys[:, 1] >> shift) & 255
            else:
                lo_bits = 32 - shift
                b = (((keys[:, 0] & ((1 << (shift + 8 - 32)) - 1))
                      << lo_bits) | (keys[:, 1] >> shift)) & 255
            out.append(b.to(I32))
        return torch.stack(out, dim=1)

    def _radix(self, ids) -> torch.Tensor:
        keys = pack_keys(np.asarray(ids, np.uint64), self.key_bits,
                         self.device)
        return self._bytes_of(keys).contiguous()

    def insert(self, ids, offsets):
        off = torch.as_tensor(np.asarray(offsets, np.int32),
                              device=self.device)
        self.state = art_insert(self.state, self._radix(ids), off)

    def lookup(self, ids) -> np.ndarray:
        return _art_lookup(self.layers, self.state,
                           self._radix(ids)).cpu().numpy()

    def memory_bytes(self) -> int:
        s = int(self.scount_total())
        d = int(self.state.dcount.sum())
        live_sparse = s - d  # metamorphosed sparse rows are freed
        # C-equivalent accounting: sparse = 16 key bytes + 16 ptrs (8B) = 144B
        # (unodb Node16); dense = 256 ptrs * 8B = 2 KiB (Node256)
        return live_sparse * (16 + 16 * 8) + d * 256 * 8

    def scount_total(self) -> torch.Tensor:
        return self.state.scount.sum()


def _art_lookup(layers: int, st: ArtState, radix: torch.Tensor
                ) -> torch.Tensor:
    """Vectorised descent, one pass per layer: int32 offsets, -1 absent."""
    B = radix.shape[0]
    dev = radix.device
    node = torch.zeros((B,), dtype=I64, device=dev)
    valid = torch.ones((B,), dtype=torch.bool, device=dev)
    slots = torch.arange(SPARSE_CAP, dtype=I64, device=dev)
    for i in range(layers):
        b = radix[:, i].to(I64)
        cap_s = st.skeys[i].shape[0]
        cap_d = st.dchild[i].shape[0]
        nc = node.clamp(0, cap_s - 1)
        drow = st.dense_of[i][nc]
        is_dense = drow >= 0
        dch = st.dchild[i][drow.to(I64).clamp(0, cap_d - 1), b]
        hit = st.skeys[i][nc] == b[:, None]
        # the first hit (jnp.argmax of a bool row), 0 when none
        pos = torch.where(hit, slots, SPARSE_CAP).amin(dim=1)
        sch = torch.where(pos < SPARSE_CAP,
                          st.schild[i][nc, pos.clamp_max(SPARSE_CAP - 1)],
                          -1)
        child = torch.where(is_dense, dch, sch)
        child = torch.where(valid, child, -1)
        valid = child >= 0
        node = child.clamp_min(0).to(I64)
    return torch.where(valid, node, -1).to(I32)

