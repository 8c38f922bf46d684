"""Vertex table (paper §3.1, Fig. 3a) — port of ``repro.core.vertex_table``.

Struct-of-arrays rows: ID, Del_time, Deg, Size, Cap and ``start_block``
(the first block of the vertex's extent in the edge pool). Deleted offsets
go to a free ring. ``ids`` holds the [hi, lo] key words as int64 (uint32
in the JAX package). Mutators update the given table IN PLACE.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from . import sort as sort_mod
from .sort import SortSpec, SortState
from .tensor_ops import I32, lexsort, scatter_set_, shift_prev

__all__ = ["VertexTable", "make_vertex_table", "ensure_vertices",
           "delete_vertices", "num_active"]


class VertexTable(NamedTuple):
    ids: torch.Tensor          # int64[n_cap, 2] — the vertex ID (hi, lo)
    del_time: torch.Tensor     # int32[n_cap]: -1 unallocated, 0 active, t>0 deleted@t
    deg: torch.Tensor          # int32[n_cap] — live degree (as of last compaction)
    size: torch.Tensor         # int32[n_cap] — occupied entries in edge array
    cap: torch.Tensor          # int32[n_cap] — edge-array capacity (entries)
    start_block: torch.Tensor  # int32[n_cap] — extent start block, -1 = none
    num_rows: torch.Tensor     # int32 scalar — bump high-water mark
    free_q: torch.Tensor       # int32[n_cap] ring of reusable offsets
    free_head: torch.Tensor    # int32 scalar (monotonic)
    free_tail: torch.Tensor    # int32 scalar (monotonic)
    overflow: torch.Tensor     # int32 scalar — table-full events


def make_vertex_table(n_cap: int, device="cuda") -> VertexTable:
    device = resolve_device(device)

    def z():
        return torch.zeros((), dtype=I32, device=device)
    return VertexTable(
        ids=torch.zeros((n_cap, 2), dtype=torch.int64, device=device),
        del_time=torch.full((n_cap,), -1, dtype=I32, device=device),
        deg=torch.zeros((n_cap,), dtype=I32, device=device),
        size=torch.zeros((n_cap,), dtype=I32, device=device),
        cap=torch.zeros((n_cap,), dtype=I32, device=device),
        start_block=torch.full((n_cap,), -1, dtype=I32, device=device),
        num_rows=z(), free_q=torch.zeros((n_cap,), dtype=I32, device=device),
        free_head=z(), free_tail=z(), overflow=z(),
    )


def num_active(vt: VertexTable) -> torch.Tensor:
    return (vt.del_time == 0).to(I32).sum(dtype=I32)


def ensure_vertices(spec: SortSpec, st: SortState, vt: VertexTable,
                    keys: torch.Tensor, mask: torch.Tensor):
    """Locate-or-insert a batch of vertex IDs.

    Returns (sort_state, vertex_table, offsets[B], created[B]). Duplicate
    IDs within the batch resolve to one shared new offset. Offsets are -1
    only on table overflow (also counted in ``vt.overflow``)."""
    B = keys.shape[0]
    n_cap = vt.del_time.shape[0]
    dev = keys.device
    off = sort_mod.lookup(spec, st, keys)
    missing = (off < 0) & mask

    # intra-batch dedup of missing keys (lexicographic sort)
    SENT = 0xFFFFFFFF
    k_hi = torch.where(missing, keys[:, 0], SENT)
    k_lo = torch.where(missing, keys[:, 1], SENT)
    order = lexsort((k_lo, k_hi))
    sh, sl = k_hi[order], k_lo[order]
    m_sorted = missing[order]
    first = ((sh != shift_prev(sh, SENT)) | (sl != shift_prev(sl, SENT))) \
        & m_sorted
    group = torch.cumsum(first.to(I32), 0, dtype=I32) - 1
    n_new = first.to(I32).sum(dtype=I32)

    # allocate offsets for group representatives
    avail = vt.free_tail - vt.free_head
    j = torch.arange(B, dtype=I32, device=dev)
    from_queue = j < avail
    q_idx = torch.remainder(vt.free_head + j, n_cap)
    reused = vt.free_q[q_idx.to(torch.int64)]
    bumped = vt.num_rows + (j - torch.minimum(avail, n_new))
    alloc = torch.where(from_queue, reused, bumped)
    fits = alloc < n_cap
    alloc = torch.where(fits, alloc, -1)
    n_over = ((j < n_new) & ~fits).to(I32).sum(dtype=I32)

    off_sorted = torch.where(m_sorted,
                             alloc[group.clamp(0, B - 1).to(torch.int64)], -1)
    new_off = torch.zeros((B,), dtype=I32, device=dev)
    new_off[order] = off_sorted.to(I32)          # order is a permutation
    offsets = torch.where(missing, new_off, off)
    created = missing & (offsets >= 0)

    # allocator cursors
    used_from_q = torch.minimum(avail, n_new)
    bump_used = torch.clamp_min(n_new - avail, 0) - n_over
    vt = vt._replace(
        free_head=vt.free_head + used_from_q,
        num_rows=vt.num_rows + torch.clamp_min(bump_used, 0),
        overflow=vt.overflow + n_over,
    )

    # initialize new rows (dup groups share one offset and identical values)
    scatter_set_(vt.ids, offsets, keys, created)
    scatter_set_(vt.del_time, offsets, 0, created)
    scatter_set_(vt.deg, offsets, 0, created)
    scatter_set_(vt.size, offsets, 0, created)
    scatter_set_(vt.cap, offsets, 0, created)
    scatter_set_(vt.start_block, offsets, -1, created)
    st = sort_mod.insert_mappings(spec, st, keys, offsets, created)
    return st, vt, offsets, created


def delete_vertices(spec: SortSpec, st: SortState, vt: VertexTable,
                    keys: torch.Tensor, mask: torch.Tensor, ts: torch.Tensor):
    """Mark vertices deleted at timestamp ``ts``; the SORT leaf slot is
    cleared, and the row is recycled into the free ring only at the next
    defrag (stale edge references are filtered by ``del_time`` until
    then). Returns (st, vt, offsets, found)."""
    n_cap = vt.del_time.shape[0]
    st, offsets, found = sort_mod.delete_keys(spec, st, keys, mask)
    row_ok = found & (vt.del_time[offsets.clamp(0, n_cap - 1).to(
        torch.int64)] == 0)
    scatter_set_(vt.del_time, offsets, ts.to(I32).expand(offsets.shape),
                 row_ok)
    return st, vt, offsets, row_ok
