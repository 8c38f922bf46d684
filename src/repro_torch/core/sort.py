"""SORT — Space-Optimized Radix Tree (port of ``repro.core.sort``).

Each layer is a flat int32 **node pool** of ``cap_nodes * 2^{a_i}`` slots;
a child pointer is the child's node id in the next layer's pool (-1 =
null) and the leaf layer stores vertex-table offsets. Inserts are
layer-synchronous and batched (sort + first-occurrence rank, then bump
allocation), exactly as in the JAX package, so pools match bit for bit.

``lookup`` — ``l`` dependent gathers per key, the hot path of every edge
batch and every read — runs through ``kernels.ops.sort_lookup``: the CUDA
kernel on a card, its plain PyTorch version on the CPU.

Mutators update the pools of the state they are given IN PLACE and return
the new state; callers that must keep the old state copy it first (the
``RadixGraph`` facade does so for pinned states).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from .. import resolve_device
from ..kernels import ops as kops
from .keys import extract_bits, layer_bit_offsets
from .sort_optimizer import SortConfig, node_probability
from .tensor_ops import I32, I64, scatter_set_, shift_prev

__all__ = ["SortSpec", "SortState", "make_sort", "lookup", "insert_mappings",
           "delete_keys", "materialized_slots"]


@dataclass(frozen=True)
class SortSpec:
    """Static structure of a SORT instance. ``lookup_impl`` selects the
    descent: ``'auto'``/``'pallas'`` the kernel wrapper (the CUDA kernel on
    a card, its plain version on the CPU), ``'ref'`` the plain version."""

    fanout_bits: Tuple[int, ...]
    key_bits: int
    node_caps: Tuple[int, ...]   # max nodes per layer (node_caps[0] == 1)
    lookup_impl: str = "auto"

    @property
    def layers(self) -> int:
        return len(self.fanout_bits)

    @property
    def bit_offsets(self) -> Tuple[int, ...]:
        return tuple(layer_bit_offsets(self.fanout_bits, self.key_bits))

    def pool_sizes(self) -> Tuple[int, ...]:
        return tuple(c << a for c, a in zip(self.node_caps, self.fanout_bits))

    @staticmethod
    def from_config(cfg: SortConfig, n_max: int,
                    capacity_factor: float | None = None,
                    lookup_impl: str = "auto") -> "SortSpec":
        """Pool capacities, derived as in the JAX package: each key creates
        at most one node per layer and layer i holds at most 2^{s_{i-1}}
        nodes; ``capacity_factor`` sizes by expected occupancy instead."""
        caps = [1]
        prefix = 0
        for i in range(1, cfg.layers):
            prefix += cfg.fanout_bits[i - 1]
            hard = 1 << min(prefix, 40)
            cap = min(n_max, hard)
            if capacity_factor is not None:
                suffix = sum(cfg.fanout_bits[i:])
                exp_nodes = min(n_max, 2 ** max(cfg.key_bits - suffix, 0)) * \
                    node_probability(cfg.key_bits, min(suffix, cfg.key_bits),
                                     n_max)
                cap = min(cap, max(64, int(exp_nodes * capacity_factor) + 64))
            caps.append(int(cap))
        return SortSpec(cfg.fanout_bits, cfg.key_bits, tuple(caps),
                        lookup_impl)


class SortState(NamedTuple):
    pools: Tuple[torch.Tensor, ...]  # int32 per layer
    counts: torch.Tensor             # int32[l] allocated nodes per layer
    overflow: torch.Tensor           # int32 scalar — node-pool exhaustion


def make_sort(spec: SortSpec, device="cuda") -> SortState:
    device = resolve_device(device)
    pools = tuple(torch.full((s,), -1, dtype=I32, device=device)
                  for s in spec.pool_sizes())
    counts = torch.zeros((spec.layers,), dtype=I32, device=device)
    counts[0] = 1
    return SortState(pools, counts, torch.zeros((), dtype=I32, device=device))


def _child_slots(spec: SortSpec, i: int, node: torch.Tensor,
                 keys: torch.Tensor) -> torch.Tensor:
    idx = extract_bits(keys, spec.bit_offsets[i], spec.fanout_bits[i])
    return node * (1 << spec.fanout_bits[i]) + idx


def _gather(pool: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    return pool[slot.clamp(0, pool.shape[0] - 1).to(I64)]


def lookup(spec: SortSpec, state: SortState, keys: torch.Tensor
           ) -> torch.Tensor:
    """Batched retrieval: (B, 2) keys -> int32 offsets (-1 = absent)."""
    return kops.sort_lookup(state.pools, keys, fanout_bits=spec.fanout_bits,
                            bit_offsets=spec.bit_offsets,
                            impl=spec.lookup_impl)


def insert_mappings(spec: SortSpec, state: SortState, keys: torch.Tensor,
                    offsets: torch.Tensor, mask: torch.Tensor) -> SortState:
    """Insert key -> offset mappings where ``mask`` is set (in place).

    Duplicate keys within the masked batch MUST carry identical offsets
    (the vertex table's intra-batch dedup ensures it). Existing mappings
    are overwritten (vertex re-insertion after deletion)."""
    B = keys.shape[0]
    dev = keys.device
    node = torch.zeros((B,), dtype=I32, device=dev)
    counts = state.counts.clone()
    pools = list(state.pools)
    overflow = state.overflow
    active = mask
    for i in range(spec.layers - 1):
        pool = pools[i]
        slot = _child_slots(spec, i, node, keys)
        child = _gather(pool, slot)
        missing = (child < 0) & active
        # dedup missing slots, allocate node ids at layer i+1
        SENT = pool.shape[0]
        s = torch.where(missing, slot, SENT)
        order = torch.argsort(s, stable=True)
        ss = s[order]
        first = (ss != shift_prev(ss, -1)) & (ss < SENT)
        ranks = torch.cumsum(first.to(I32), 0, dtype=I32) - 1
        n_new = first.to(I32).sum(dtype=I32)
        base = counts[i + 1]
        cap = spec.node_caps[i + 1]
        fits = base + n_new <= cap
        overflow = overflow + torch.where(fits, 0, 1).to(I32)
        new_id = torch.where(fits & first, base + ranks, -2).to(I32)
        scatter_set_(pool, ss, new_id, first & fits)
        counts[i + 1] = torch.where(fits, base + n_new, base)
        child = _gather(pool, slot)
        active = active & (child >= 0)
        node = child.clamp_min(0)
    i = spec.layers - 1
    slot = _child_slots(spec, i, node, keys)
    scatter_set_(pools[i], slot, offsets.to(I32), active)
    return SortState(tuple(pools), counts, overflow)


def delete_keys(spec: SortSpec, state: SortState, keys: torch.Tensor,
                mask: torch.Tensor):
    """Clear leaf slots for present keys (in place). Returns
    (state, offsets, found)."""
    B = keys.shape[0]
    node = torch.zeros((B,), dtype=I32, device=keys.device)
    valid = mask
    offsets = slot = None
    for i in range(spec.layers):
        slot = _child_slots(spec, i, node, keys)
        child = _gather(state.pools[i], slot)
        child = torch.where(valid, child, -1)
        valid = child >= 0
        if i < spec.layers - 1:
            node = child.clamp_min(0)
        else:
            offsets = child
    scatter_set_(state.pools[-1], slot, -1, valid)
    return state, offsets, valid


def materialized_slots(spec: SortSpec, state: SortState) -> torch.Tensor:
    """Pointer slots actually materialized (the paper's space metric):
    sum_i counts[i] * 2^{a_i}."""
    fans = torch.tensor([1 << a for a in spec.fanout_bits], dtype=I32,
                        device=state.counts.device)
    return (state.counts * fans).sum(dtype=I32)
