"""Snapshot-log edge storage (paper §3.3) — port of ``repro.core.edgepool``.

Per-vertex edge arrays are contiguous block **extents** inside one global
pool: append is a scatter at ``start_block*BS + size + rank``, entries
[0, deg) are the snapshot and [deg, size) the log, compaction (Alg. 2)
runs batched over up to ``k_max`` overflowing vertices, and larger events
fall through to a global **defragmentation** (a rebuild that doubles as
the allocator's garbage collector). Every entry carries a timestamp, so
reads at ``read_ts`` give MVCC snapshots.

The port follows the JAX module step by step so every field matches bit
for bit. Two things differ in form:

* state is updated IN PLACE (the ``RadixGraph`` facade copies a pinned
  state first, the rule JAX applies to buffer donation);
* each ``lax.cond`` becomes a host branch on a value fetched from the
  device: the defrag-vs-fast-path choice once per batch, and the
  streaming rebuild's segment populations once per rebuild. ``SYNCS``
  counts them (``SYNCS["host_syncs"]``) together with the rebuild path
  taken (``defrag_stream`` / ``defrag_dense``, and ``defrag_wide`` for a
  streaming rebuild that ran its wide tier).

Where JAX's ``defrag`` falls back to its dense rebuild (an extent wider
than ``dmax``, a size segment past its static budget), the port keeps
streaming: an open-ended wide tier and extra chunks, through the same
``defrag_rows`` kernel. The answer is the same (JAX's own stream == dense
parity), and only ``defrag_impl='dense'`` runs the dense reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple

import torch

from .. import resolve_device
from ..kernels import ops as kops
from .tensor_ops import (I32, I64, cdiv, lexsort, nonzero_static,
                         scatter_add_, scatter_set_, shift_next, shift_prev)
from .vertex_table import VertexTable

__all__ = ["EdgePool", "PoolSpec", "make_edge_pool", "apply_edge_updates",
           "get_neighbors", "live_edges", "defrag", "SYNCS", "DEFRAG_WIDE"]

INT_MAX = 0x7FFFFFFF

# host round trips the eager port pays where JAX branches on device
SYNCS: Dict[str, int] = {"host_syncs": 0, "defrag_stream": 0,
                         "defrag_dense": 0, "defrag_wide": 0}
# the wide tier of the last rebuild that ran one (SYNCS["defrag_wide"])
DEFRAG_WIDE: Dict[str, int] = {"width": 0, "rows": 0}

# the most bytes of gathered (dst, w, ts) entries, 12 bytes each, one
# streaming-rebuild chunk holds: (K, W) chunks of a segment stay under it
# (down to one row), so one enormous extent cannot take the card's memory
CHUNK_BYTES = 256 << 20


def _fetch(*ts: torch.Tensor):
    """One device->host round trip for a few small tensors (counted): their
    elements as one flat list of ints."""
    SYNCS["host_syncs"] += 1
    return torch.cat([t.to(I64).reshape(-1) for t in ts]).tolist()


@dataclass(frozen=True)
class PoolSpec:
    """Static pool configuration; fields and values as in the JAX package.

    ``append_impl``: ``'auto'``/``'pallas'`` the fused path (kernel
    wrapper: the CUDA append kernel on a card, its plain version on the
    CPU), ``'plain'`` the fused path forced to the plain version, ``'ref'``
    the windowed-probe scatter path. ``compact_impl``: ``'auto'``/
    ``'pallas'`` the row-compactor wrappers, ``'ref'`` their plain
    versions. ``defrag_impl``: ``'auto'``/``'stream'`` or ``'dense'``."""

    n_blocks: int
    block_size: int = 16
    k_max: int = 256
    dmax: int = 4096
    probe_width: int = 256
    k_big: int = 16
    append_impl: str = "auto"
    compact_impl: str = "auto"
    defrag_impl: str = "auto"
    policy: str = "snaplog"   # 'snaplog' | 'grow' | 'sorted'
    buf_blocks: int = 1

    @property
    def capacity_entries(self) -> int:
        return self.n_blocks * self.block_size


class EdgePool(NamedTuple):
    dst: torch.Tensor          # int32[n_blocks, BS] destination offsets; -1 empty
    weight: torch.Tensor       # float32[n_blocks, BS]; 0.0 = NULL tombstone
    ts: torch.Tensor           # int32[n_blocks, BS]
    owner: torch.Tensor        # int32[n_blocks] owning vertex offset, -1 free
    next_block: torch.Tensor   # int32 scalar bump allocator
    garbage: torch.Tensor      # int32 scalar — stale entries since last defrag
    clock: torch.Tensor        # int32 scalar — global timestamp
    overflow: torch.Tensor     # int32 scalar — pool-exhaustion events
    live_m: torch.Tensor       # int32 scalar — live edges
    live_dirty: torch.Tensor   # int32 scalar — 1 when live_m needs a recount
    defrags: torch.Tensor      # int32 scalar — global rebuilds so far
    tiles_scanned: torch.Tensor  # int32 scalar — touched append tiles


def make_edge_pool(spec: PoolSpec, device="cuda") -> EdgePool:
    device = resolve_device(device)
    nb, bs = spec.n_blocks, spec.block_size

    def z(v=0):
        return torch.full((), v, dtype=I32, device=device)
    return EdgePool(
        dst=torch.full((nb, bs), -1, dtype=I32, device=device),
        weight=torch.zeros((nb, bs), dtype=torch.float32, device=device),
        ts=torch.zeros((nb, bs), dtype=I32, device=device),
        owner=torch.full((nb,), -1, dtype=I32, device=device),
        next_block=z(), garbage=z(), clock=z(1), overflow=z(),
        live_m=z(), live_dirty=z(), defrags=z(), tiles_scanned=z(),
    )


def _ar(n: int, dev, dtype=I32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=dev)


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.to(I32).sum(dtype=I32)


def _cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(x.to(I32), dim, dtype=I32)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t[idx.to(I64)]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _group_by(u: torch.Tensor, valid: torch.Tensor):
    """Stable-sort ops by target vertex. Returns the sorted view."""
    B = u.shape[0]
    dev = u.device
    key = torch.where(valid, u, INT_MAX)
    order = torch.argsort(key, stable=True)
    su = key[order]
    first = (su != shift_prev(su, -1)) & (su < INT_MAX)
    gid = _cumsum(first) - 1
    idx = _ar(B, dev)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = idx - start
    gstart = nonzero_static(first, B, B).to(I32)
    gu = _take(su, gstart.clamp(0, B - 1))
    nxt = shift_next(gstart, B)
    ng = _sum(first)
    garange = _ar(B, dev)
    gvalid = garange < ng
    nvalid = _sum(valid)
    gend = torch.where(garange + 1 < ng, nxt, nvalid)
    gcount = torch.where(gvalid, gend - gstart, 0)
    return dict(order=order, su=su, gid=gid, rank=rank, gstart=gstart, gu=gu,
                gcount=gcount, gvalid=gvalid, ng=ng)


def _gather_vertex_entries(spec: PoolSpec, pool: EdgePool, vt: VertexTable,
                           u: torch.Tensor, width: int):
    """Gather up to ``width`` occupied entries of each vertex in ``u``:
    (dst, w, ts) of shape (K, width) plus the sizes."""
    bs = spec.block_size
    uc = u.clamp(0, vt.size.shape[0] - 1)
    start = _take(vt.start_block, uc)
    size = torch.where(u >= 0, _take(vt.size, uc), 0)
    e = _ar(width, u.device)[None, :]
    blk = start[:, None] + e // bs
    lane = (e % bs).expand_as(blk)
    ok = (e < size[:, None]) & (start[:, None] >= 0)
    # JAX clamps out-of-range gathers (an extent laid out past the pool
    # end by a rebuild that did not fit); torch raises, so clip here
    blk = torch.where(ok, blk, 0).clamp_max(pool.dst.shape[0] - 1)
    bi, li = blk.to(I64), lane.to(I64)
    d = torch.where(ok, pool.dst[bi, li], -1)
    w = torch.where(ok, pool.weight[bi, li], 0.0)
    t = torch.where(ok, pool.ts[bi, li], 0)
    return d, w, t, size


def _scatter_entries(pool: EdgePool, tgt_block, lane, valid, d, w, t):
    for arr, val in ((pool.dst, d), (pool.weight, w), (pool.ts, t)):
        scatter_set_(arr, (tgt_block, lane), val, valid)
    return pool


def _scatter_block_rows(pool: EdgePool, tgt_rows, ok, d_rows, w_rows,
                        t_rows):
    """Write whole (bs,)-entry block rows where ``ok``."""
    for arr, val in ((pool.dst, d_rows), (pool.weight, w_rows),
                     (pool.ts, t_rows)):
        scatter_set_(arr, tgt_rows, val, ok)
    return pool


# --------------------------------------------------------------------------
# first-touch extent allocation (fast path, whole batch)
# --------------------------------------------------------------------------

def _alloc_extents(spec: PoolSpec, pool: EdgePool, vt: VertexTable,
                   ku: torch.Tensor, kmask: torch.Tensor,
                   kincoming: torch.Tensor):
    """Assign fresh extents to vertices with NO edge array yet: one cumsum
    lays the whole batch out, one block-row scatter initializes it."""
    bs = spec.block_size
    K = ku.shape[0]
    dev = ku.device
    nb = pool.dst.shape[0]
    base_log = spec.buf_blocks if spec.policy == "sorted" else 1

    new_blocks = torch.where(kmask,
                             torch.clamp_min(cdiv(kincoming, bs), base_log), 0)
    total = _sum(new_blocks)
    ends = _cumsum(new_blocks)
    base = pool.next_block + ends - new_blocks

    R_total = K * (base_log + 1) + cdiv(K, bs)
    fits = (pool.next_block + total <= nb) & (total <= R_total)
    kmask = kmask & fits
    r = _ar(R_total, dev)
    krow = torch.searchsorted(ends, r, right=True).to(I32)
    krc = krow.clamp(0, K - 1)
    valid_r = (r < total) & fits
    tgt_rows = pool.next_block + r
    _scatter_block_rows(pool, tgt_rows, valid_r, -1, 0.0, 0)
    scatter_set_(pool.owner, tgt_rows, _take(ku, krc), valid_r)

    scatter_set_(vt.cap, ku, new_blocks * bs, kmask)
    scatter_set_(vt.start_block, ku, torch.where(new_blocks > 0, base, -1),
                 kmask)
    pool = pool._replace(
        next_block=pool.next_block + torch.where(fits, total, 0),
        overflow=pool.overflow + torch.where(fits, 0, 1).to(I32))
    return pool, vt


# --------------------------------------------------------------------------
# per-vertex compaction (fast path) — paper Alg. 2 batched over k vertices
# --------------------------------------------------------------------------

def _fold_words(n_cap: int) -> int:
    return (n_cap + 31) // 32


def _compact_vertices(spec: PoolSpec, pool: EdgePool, vt: VertexTable,
                      ku: torch.Tensor, kmask: torch.Tensor,
                      kincoming: torch.Tensor, width: int, fold: bool):
    """Compact + grow the edge arrays of vertices ``ku`` (masked), each
    with at most ``width`` occupied entries. Returns
    (pool, vt, fold_ku, fold_bitmap); the fold bitmap holds uint32 bit
    patterns in int64 words."""
    bs = spec.block_size
    K = ku.shape[0]
    dev = ku.device
    n_cap = vt.size.shape[0]
    nb = pool.dst.shape[0]

    d0, w0, t0, size0 = _gather_vertex_entries(
        spec, pool, vt, torch.where(kmask, ku, -1), width)
    if spec.policy == "grow":
        cd, cw, ct, cnt = d0, w0, t0, size0
    else:
        cd, cw, ct, cnt = kops.compact_rows(d0, w0, t0, size0,
                                            impl=spec.compact_impl)
        if spec.policy == "sorted":
            D = cd.shape[1]
            pos = _ar(D, dev)[None, :]
            skey = torch.where(pos < cnt[:, None], cd, INT_MAX)
            o = torch.argsort(skey, dim=-1, stable=True)
            cd, cw, ct = cd.gather(-1, o), cw.gather(-1, o), ct.gather(-1, o)
    cnt = torch.where(kmask, cnt, 0)

    snap_blocks = cdiv(cnt, bs)
    if spec.policy == "sorted":
        log_blocks = torch.full_like(snap_blocks, spec.buf_blocks)
    else:
        log_blocks = torch.clamp_min(
            torch.maximum(snap_blocks, cdiv(kincoming, bs)), 1)
    log_blocks = torch.maximum(log_blocks, cdiv(kincoming, bs))
    new_blocks = torch.where(kmask, snap_blocks + log_blocks, 0)

    base = pool.next_block + _cumsum(new_blocks) - new_blocks
    total = _sum(new_blocks)
    fits = pool.next_block + total <= nb
    kmask = kmask & fits

    # per-vertex liveness bitmap over dst offsets (fold for the live
    # probe); after dedup each dst appears once per row, so the bits of a
    # word are distinct and scatter-add equals scatter-OR
    Ww = _fold_words(n_cap)
    fold_bitmap = torch.zeros((K, Ww), dtype=I64, device=dev)
    if fold and spec.policy != "grow":
        ee = _ar(width, dev)[None, :]
        entry_ok = kmask[:, None] & (ee < cnt[:, None]) & (cd >= 0)
        cdc = cd.clamp(0, n_cap - 1).to(I64)
        krow = _ar(K, dev, I64)[:, None].expand(K, width)
        bit = torch.ones((), dtype=I64, device=dev) << (cdc & 31)
        scatter_add_(fold_bitmap, (krow, cdc >> 5), bit, entry_ok)
        fold_ku = torch.where(kmask, ku, -1)
    else:
        fold_ku = torch.full((K,), -1, dtype=I32, device=dev)

    # new extents as whole block rows: content rows carry the compacted
    # prefix padded with empties, then pure-empty log rows
    R1 = cdiv(width, bs)
    padw = R1 * bs - width
    if padw:
        cd = torch.nn.functional.pad(cd, (0, padw), value=-1)
        cw = torch.nn.functional.pad(cw, (0, padw))
        ct = torch.nn.functional.pad(ct, (0, padw))
    e = _ar(R1 * bs, dev)[None, :]
    fillm = e < cnt[:, None]
    rowi = _ar(R1, dev)[None, :]
    row_ok = kmask[:, None] & (rowi < new_blocks[:, None])
    _scatter_block_rows(
        pool, base[:, None] + rowi, row_ok,
        torch.where(fillm, cd, -1).reshape(K * R1, bs),
        torch.where(fillm, cw, 0.0).reshape(K * R1, bs),
        torch.where(fillm, ct, 0).reshape(K * R1, bs))

    MB = R1 + max(cdiv(spec.dmax, bs), spec.buf_blocks) + 1
    rowi2 = torch.arange(R1, MB, dtype=I32, device=dev)[None, :]
    row_ok2 = kmask[:, None] & (rowi2 < new_blocks[:, None])
    _scatter_block_rows(pool, base[:, None] + rowi2, row_ok2, -1, 0.0, 0)
    cap_entries = new_blocks * bs

    # ownership: new extents -> u ; old extents -> -1 (garbage)
    b = _ar(MB, dev)[None, :]
    scatter_set_(pool.owner, base[:, None] + b, ku[:, None].expand(K, MB),
                 kmask[:, None] & (b < new_blocks[:, None]))
    uc = ku.clamp(0, n_cap - 1)
    old_start = torch.where(kmask, _take(vt.start_block, uc), -1)
    old_blocks = torch.where(kmask & (old_start >= 0),
                             cdiv(_take(vt.cap, uc), bs), 0)
    scatter_set_(pool.owner, old_start[:, None] + b, -1,
                 kmask[:, None] & (b < old_blocks[:, None]))

    garbage = pool.garbage + _sum(torch.where(kmask, _take(vt.size, uc), 0)
                                  - cnt)
    pool = pool._replace(
        next_block=pool.next_block + torch.where(fits, total, 0),
        garbage=garbage,
        overflow=pool.overflow + torch.where(fits, 0, 1).to(I32))

    scatter_set_(vt.deg, ku, cnt, kmask)
    scatter_set_(vt.size, ku, cnt, kmask)
    scatter_set_(vt.cap, ku, cap_entries, kmask)
    scatter_set_(vt.start_block, ku, torch.where(new_blocks > 0, base, -1),
                 kmask)
    return pool, vt, fold_ku, fold_bitmap


# --------------------------------------------------------------------------
# global defragmentation — streaming block-row rebuild, GC, vertex-offset
# recycling (dense entry-scatter rebuild kept as the bit-exact reference)
# --------------------------------------------------------------------------

def _rebuild_layout(spec: PoolSpec, vt: VertexTable, d_cnt: torch.Tensor,
                    incoming: torch.Tensor):
    """New extent layout: each live vertex with content (or pending
    ``incoming`` ops) gets ``snapB + max(snapB, incomingB, 1)`` blocks,
    laid out in vertex-row order."""
    bs = spec.block_size
    snapB = cdiv(d_cnt, bs)
    has_any = (d_cnt > 0) | (incoming > 0)
    active_row = vt.del_time == 0
    if spec.policy == "sorted":
        base_logB = torch.full_like(snapB, spec.buf_blocks)
    else:
        base_logB = torch.clamp_min(snapB, 1)
    logB = torch.where(active_row & has_any,
                       torch.maximum(base_logB, cdiv(incoming, bs)), 0)
    blocks = torch.where(active_row, snapB + logB, 0)
    bstart = _cumsum(blocks) - blocks
    return blocks, bstart, _sum(blocks), active_row


def _rebuild_finalize(spec: PoolSpec, pool: EdgePool, vt: VertexTable,
                      new_dst, new_w, new_t, d_cnt, blocks, bstart,
                      total_blocks, live_cnt, active_row):
    """Shared rebuild tail: block ownership by interval mapping, deleted
    rows recycled into the free ring, vertex table and pool bookkeeping;
    ``live_m`` becomes exact here."""
    bs = spec.block_size
    nb = pool.dst.shape[0]
    n_cap = vt.size.shape[0]
    dev = pool.dst.device

    bidx = _ar(nb, dev)
    vown = torch.searchsorted(bstart + blocks, bidx, right=True).to(I32)
    vownc = vown.clamp(0, n_cap - 1)
    inside = (bidx < total_blocks) & (bidx >= _take(bstart, vownc)) & \
        (_take(blocks, vownc) > 0)
    new_owner = torch.where(inside, vownc, -1)

    deleted = vt.del_time > 0
    del_idx = nonzero_static(deleted, n_cap, n_cap).to(I32)
    n_del = _sum(deleted)
    r = _ar(n_cap, dev)
    q_pos = torch.remainder(vt.free_tail + r, n_cap)
    free_q = vt.free_q
    scatter_set_(free_q, q_pos, del_idx, r < n_del)
    del_time = torch.where(deleted, -1, vt.del_time).to(I32)

    vt = vt._replace(
        deg=torch.where(active_row, d_cnt, 0),
        size=torch.where(active_row, d_cnt, 0),
        cap=torch.where(active_row, blocks * bs, 0),
        start_block=torch.where(active_row & (blocks > 0), bstart, -1),
        free_q=free_q,
        free_tail=vt.free_tail + n_del,
        del_time=del_time,
    )
    pool = pool._replace(dst=new_dst, weight=new_w, ts=new_t,
                         owner=new_owner, next_block=total_blocks,
                         garbage=torch.zeros_like(pool.garbage),
                         live_m=live_cnt.to(I32),
                         live_dirty=torch.zeros_like(pool.live_dirty),
                         defrags=pool.defrags + 1)
    return pool, vt


def _defrag_dense(spec: PoolSpec, pool: EdgePool, vt: VertexTable,
                  incoming: torch.Tensor):
    """Dense rebuild reference: flatten every pool lane, one full-pool
    3-key lexsort, entry-level scatters."""
    SYNCS["defrag_dense"] += 1
    bs = spec.block_size
    nb = pool.dst.shape[0]
    n_cap = vt.size.shape[0]
    N = nb * bs
    dev = pool.dst.device

    own = pool.owner.repeat_interleave(bs)
    d = pool.dst.reshape(-1)
    w = pool.weight.reshape(-1)
    t = pool.ts.reshape(-1)
    e = _ar(N, dev)
    blk_index, lane = e // bs, e % bs
    ownc = own.clamp(0, n_cap - 1)
    start = _take(vt.start_block, ownc)
    pos_in_extent = (blk_index - start) * bs + lane
    occupied = (own >= 0) & (pos_in_extent >= 0) & \
        (pos_in_extent < _take(vt.size, ownc))
    src_alive = _take(vt.del_time, ownc) == 0
    dst_alive = (d >= 0) & (_take(vt.del_time, d.clamp(0, n_cap - 1)) == 0)
    valid = occupied & src_alive & dst_alive & (d >= 0)
    del own, start, pos_in_extent, occupied, src_alive, dst_alive, ownc

    # last-writer-wins on (owner, dst) by ts
    so = torch.where(valid, pool.owner.repeat_interleave(bs), INT_MAX)
    sd = torch.where(valid, d, INT_MAX)
    stv = torch.where(valid, t, 0)
    order = lexsort((stv, sd, so))
    so, sd, sw, stv = so[order], sd[order], w[order], stv[order]
    del order
    sval = so < INT_MAX
    is_last = ((so != shift_next(so, -2)) | (sd != shift_next(sd, -2))) & \
        sval
    live_cnt = _sum(is_last & (sw != 0))
    keep = sval if spec.policy == "grow" else (is_last & (sw != 0))

    d_cnt = torch.zeros((n_cap,), dtype=I32, device=dev)
    scatter_add_(d_cnt, so, 1, keep)
    blocks, bstart, total_blocks, active_row = _rebuild_layout(
        spec, vt, d_cnt, incoming)

    # rank of each kept entry within its owner (segmented cumsum)
    keep_i = keep.to(I32)
    csum = _cumsum(keep_i)
    owner_change = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                              so[1:] != so[:-1]])
    seg_base = torch.cummax(torch.where(owner_change, csum - keep_i, 0),
                            0).values
    rank = csum - 1 - seg_base
    entry_pos = _take(bstart, so.clamp(0, n_cap - 1)) * bs + rank

    new_dst = torch.full((nb, bs), -1, dtype=I32, device=dev)
    new_w = torch.zeros((nb, bs), dtype=torch.float32, device=dev)
    new_t = torch.zeros((nb, bs), dtype=I32, device=dev)
    for arr, val in ((new_dst, sd), (new_w, sw), (new_t, stv)):
        scatter_set_(arr.view(-1), entry_pos, val, keep)
    return _rebuild_finalize(spec, pool, vt, new_dst, new_w, new_t, d_cnt,
                             blocks, bstart, total_blocks, live_cnt,
                             active_row)


def _defrag_tiers(spec: PoolSpec, n_cap: int):
    """Static (width, budget) size segments of the streaming rebuild."""
    bs = spec.block_size
    top = max(cdiv(spec.dmax, bs) * bs, bs)
    tiers = []
    w, j = bs, 0
    while True:
        w = min(w, top)
        tiers.append((w, min(n_cap, max(64, 4 * spec.k_big,
                                        n_cap >> (3 * j)))))
        if w >= top:
            break
        w, j = w * 8, j + 1
    return tiers


def _defrag_chunks(width: int, budget: int):
    """Geometric (start, rows) chunk schedule of one size segment, each
    chunk's (rows, width) gather under ``CHUNK_BYTES``."""
    most = max(1, CHUNK_BYTES // (12 * max(width, 1)))
    c = min(max(32, min(budget, 65536 // max(width, 1))), most)
    chunks, lo = [], 0
    while lo < budget:
        c = min(c, budget - lo)
        chunks.append((lo, c))
        lo += c
        c = min(2 * c, most)
    return chunks


def _defrag_stream(spec: PoolSpec, pool: EdgePool, vt: VertexTable,
                   incoming: torch.Tensor, tiers, tier_masks, pops):
    """Block-row streaming rebuild: per size segment, gather each live
    vertex's extent once, run the ``defrag_rows`` row compactor and write
    the new extents as whole block rows into a fresh pool image. Chunks
    past the segment's population (``pops``, fetched on the host) are
    skipped, as JAX's ``lax.cond`` skips them."""
    SYNCS["defrag_stream"] += 1
    bs = spec.block_size
    nb = pool.dst.shape[0]
    n_cap = vt.size.shape[0]
    dev = pool.dst.device
    keep_all = spec.policy == "grow"
    dead_dst = vt.del_time != 0

    d_cnt = torch.zeros((n_cap,), dtype=I32, device=dev)
    live_cnt = torch.zeros((), dtype=I32, device=dev)
    parts = []
    for (W, Bj), mask, pop in zip(tiers, tier_masks, pops):
        kidx = nonzero_static(mask, Bj, n_cap).to(I32)
        for lo, C in _defrag_chunks(W, Bj):
            if pop <= lo:
                continue
            kidx_c = kidx[lo:lo + C]
            kmask = kidx_c < n_cap
            ku = torch.where(kmask, kidx_c, -1)
            d0, w0, t0, ksz = _gather_vertex_entries(spec, pool, vt, ku, W)
            # edges to deleted vertices drop like the dense rebuild
            dead = _take(dead_dst, d0.clamp(0, n_cap - 1))
            dd = torch.where((d0 >= 0) & dead, -1, d0)
            cd, cw, ct, cnt, liv = kops.defrag_rows(
                dd, w0, t0, ksz, keep_all=keep_all, impl=spec.compact_impl)
            cnt = torch.where(kmask, cnt, 0)
            scatter_set_(d_cnt, ku, cnt, kmask)
            live_cnt = live_cnt + _sum(torch.where(kmask, liv, 0))
            parts.append((W, ku, cd, cw, ct, cnt))

    blocks, bstart, total_blocks, active_row = _rebuild_layout(
        spec, vt, d_cnt, incoming)

    img = pool._replace(dst=torch.full((nb, bs), -1, dtype=I32, device=dev),
                        weight=torch.zeros((nb, bs), dtype=torch.float32,
                                           device=dev),
                        ts=torch.zeros((nb, bs), dtype=I32, device=dev))
    for W, ku, cd, cw, ct, cnt in parts:
        R = W // bs
        K = ku.shape[0]
        base = _take(bstart, ku.clamp(0, n_cap - 1))
        rowi = _ar(R, dev)[None, :]
        row_ok = (ku >= 0)[:, None] & (rowi < cdiv(cnt, bs)[:, None])
        _scatter_block_rows(img, base[:, None] + rowi, row_ok,
                            cd.reshape(K * R, bs), cw.reshape(K * R, bs),
                            ct.reshape(K * R, bs))
    return _rebuild_finalize(spec, pool, vt, img.dst, img.weight, img.ts,
                             d_cnt, blocks, bstart, total_blocks, live_cnt,
                             active_row)


def defrag(spec: PoolSpec, pool: EdgePool, vt: VertexTable,
           incoming: torch.Tensor | None = None):
    """Rebuild the pool compactly in vertex order: last-writer-wins per
    (owner, dst), tombstones and edges from/to deleted vertices dropped,
    deleted rows recycled, each live vertex pre-sized for ``incoming``.

    The streaming rebuild handles every state: a size segment holding more
    rows than its static budget runs more chunks, and live extents wider
    than the top segment form a wide tier as wide as the widest of them
    (rounded up to the block size). ``defrag_impl='dense'`` runs the dense
    reference; both give identical states. One host sync fetches the
    segment populations and the widest extent."""
    n_cap = vt.size.shape[0]
    if incoming is None:
        incoming = torch.zeros((n_cap,), dtype=I32, device=vt.size.device)
    if spec.defrag_impl == "dense":
        return _defrag_dense(spec, pool, vt, incoming)
    tiers = _defrag_tiers(spec, n_cap)
    live_row = (vt.del_time == 0) & (vt.start_block >= 0)
    sz = torch.where(live_row, vt.size, 0)
    masks = []
    prev = 0
    for W, _ in tiers:
        masks.append(live_row & (sz > prev) & (sz <= W))
        prev = W
    wide = live_row & (sz > prev)
    *pops, n_wide, max_sz = _fetch(*[_sum(m) for m in masks], _sum(wide),
                                   sz.max())
    tiers = [(W, max(Bj, p)) for (W, Bj), p in zip(tiers, pops)]
    if n_wide:
        SYNCS["defrag_wide"] += 1
        width = cdiv(max_sz, spec.block_size) * spec.block_size
        DEFRAG_WIDE.update(width=width, rows=n_wide)
        tiers.append((width, n_wide))
        masks.append(wide)
        pops.append(n_wide)
    return _defrag_stream(spec, pool, vt, incoming, tiers, masks, pops)


# --------------------------------------------------------------------------
# batched edge updates (insert / update / delete): the paper's O(1) append
# --------------------------------------------------------------------------

def _tier(g, gsize, mask, k_budget: int, spec: PoolSpec, B: int):
    kidx = nonzero_static(mask, k_budget, B)
    kmask = kidx < B
    kc = kidx.clamp(0, B - 1)
    ku = torch.where(kmask, g["gu"][kc], -1)
    kinc = torch.where(kmask, g["gcount"][kc], 0)
    truncated = _sum(mask) > k_budget
    worst = _sum(torch.where(
        kmask, cdiv(torch.clamp_max(gsize[kc], spec.dmax), spec.block_size)
        * 2 + cdiv(kinc, spec.block_size) + 2, 0))
    return ku, kmask, kinc, truncated, worst


def apply_edge_updates(spec: PoolSpec, pool: EdgePool, vt: VertexTable,
                       u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                       mask: torch.Tensor):
    """Apply a batch of edge operations given vertex OFFSETS (in place).

    ``w == 0`` is a deletion (the paper's NULL weight log). Ops are
    timestamped ``clock + batch_index``. Returns (pool, vt, dropped):
    ``dropped`` counts masked ops that could not be applied (pool
    exhaustion)."""
    B = u.shape[0]
    bs = spec.block_size
    nb = pool.dst.shape[0]
    n_cap = vt.size.shape[0]
    dev = u.device
    valid = mask & (u >= 0) & (v >= 0)
    ts = pool.clock + _ar(B, dev)

    g = _group_by(u, valid)
    guc = g["gu"].clamp(0, n_cap - 1)
    gsize = torch.where(g["gvalid"], _take(vt.size, guc), 0)
    gcap = torch.where(g["gvalid"], _take(vt.cap, guc), 0)
    govf = g["gvalid"] & (gsize + g["gcount"] > gcap)

    # fast-path eligibility: the whole current array fits the compaction
    # buffer (a vertex whose per-batch incoming exceeds dmax defrags)
    small_ok = govf & (gcap <= spec.dmax) & (gsize <= spec.dmax) & \
        (g["gcount"] <= spec.dmax)
    jumbo = _sum(govf) != _sum(small_ok)

    # tiers: first-touch allocation, in-window compaction (k_max), and
    # full-width compaction of the rare big vertex (k_big, with fold)
    tier_a = small_ok & (gsize == 0) & (gcap == 0)
    rest = small_ok & ~tier_a
    dS = min(spec.probe_width, spec.dmax)
    two_tier = dS < spec.dmax
    tier_l = rest & (gsize > dS) if two_tier else torch.zeros_like(rest)
    tier_s = rest & ~tier_l

    kuA = torch.where(tier_a, g["gu"], -1)
    kincA = torch.where(tier_a, g["gcount"], 0)
    base_log = spec.buf_blocks if spec.policy == "sorted" else 1
    worstA = _sum(torch.where(tier_a,
                              torch.clamp_min(cdiv(kincA, bs), base_log), 0))
    kuS, kmS, kincS, truncS, worstS = _tier(g, gsize, tier_s, spec.k_max,
                                            spec, B)
    kuL, kmL, kincL, truncL, worstL = _tier(g, gsize, tier_l, spec.k_big,
                                            spec, B)
    pool_tight = pool.next_block + worstA + worstS + worstL > nb
    half_garbage = pool.garbage > (nb * bs) // 2
    do_defrag = jumbo | truncS | truncL | pool_tight | half_garbage

    incoming_vec = torch.zeros((n_cap,), dtype=I32, device=dev)
    scatter_add_(incoming_vec, g["gu"], g["gcount"], g["gvalid"])

    KF = spec.k_big
    fold_ku = torch.full((KF,), -1, dtype=I32, device=dev)
    fold_bitmap = torch.zeros((KF, _fold_words(n_cap)), dtype=I64,
                              device=dev)
    if _fetch(do_defrag)[0]:
        # defrag resynchronizes live_m exactly but rebuilds EVERY vertex,
        # so there is no per-vertex fold to hand the probe
        pool, vt = defrag(spec, pool, vt, incoming_vec)
    else:
        pool, vt = _alloc_extents(spec, pool, vt, kuA, tier_a, kincA)
        pool, vt, _, _ = _compact_vertices(spec, pool, vt, kuS, kmS, kincS,
                                           dS, fold=False)
        if two_tier:
            pool, vt, fold_ku, fold_bitmap = _compact_vertices(
                spec, pool, vt, kuL, kmL, kincL, spec.dmax, fold=True)

    # ---- append every op at size + rank (log append, O(1) per op) ----
    order = g["order"]
    su = g["su"]
    suc = su.clamp(0, n_cap - 1)
    real = su < INT_MAX
    slot = torch.where(real, _take(vt.size, suc), 0) + g["rank"]
    cap_now = torch.where(real, _take(vt.cap, suc), 0)
    start = _take(vt.start_block, suc)
    op_ok = real & (slot < cap_now) & (start >= 0)
    dropped = _sum(real & ~op_ok)

    # ---- incremental live-edge accounting, probed BEFORE the appends:
    # delta = sum over pairs of applied(last op) * [(w_last != 0) - was_live]
    op_ok_orig = torch.zeros((B,), dtype=torch.bool, device=dev)
    op_ok_orig[order] = op_ok                      # order is a permutation
    pu = torch.where(valid, u, INT_MAX)
    pv = torch.where(valid, v, INT_MAX)
    porder = lexsort((ts, pv, pu))   # (u, v, ts): last-per-pair = max ts
    u2, v2, w2 = pu[porder], pv[porder], w[porder]
    ok2 = op_ok_orig[porder]
    pair_last = ((u2 != shift_next(u2, -2)) | (v2 != shift_next(v2, -2))) \
        & (u2 < INT_MAX)

    u2c = u2.clamp(0, n_cap - 1)
    v2c = v2.clamp(0, n_cap - 1).to(I64)
    k_of = torch.full((n_cap,), -1, dtype=I32, device=dev)
    scatter_set_(k_of, fold_ku, _ar(KF, dev), fold_ku >= 0)
    krow = torch.where(pair_last, _take(k_of, u2c), -1)
    fold_hit = krow >= 0
    fw = fold_bitmap[krow.clamp(0, KF - 1).to(I64), v2c >> 5]
    fold_live = ((fw >> (v2c & 31)) & 1) == 1

    sv, sw_, sts = v[order], w[order], ts[order]
    tgt_blk = torch.where(op_ok, start + slot // bs, nb)

    probe_u = torch.where(pair_last & ~fold_hit, u2, -1)
    p_start = torch.where(probe_u >= 0, _take(vt.start_block, u2c), -1)
    p_sz = torch.where(probe_u >= 0, _take(vt.size, u2c), 0)
    p_v = torch.where(probe_u >= 0, v2, -1)

    # ---- touched-tile bound, recorded in ``tiles_scanned`` exactly as in
    # the JAX package (the CUDA kernel itself needs no tile list)
    T = kops.append_tile_rows(nb)
    n_tiles = nb // T
    p_rows = cdiv(p_sz, bs)
    has_p = (p_start >= 0) & (p_rows > 0)
    t_first = p_start // T
    t_end = (p_start + p_rows - 1) // T + 1
    diff = torch.zeros((n_tiles + 1,), dtype=I32, device=dev)
    scatter_add_(diff, t_first, 1, has_p)
    scatter_add_(diff, t_end, -1, has_p & (t_end <= n_tiles))
    touched = _cumsum(diff[:n_tiles]) > 0
    wmark = torch.zeros((n_tiles,), dtype=torch.bool, device=dev)
    scatter_set_(wmark, tgt_blk // T, True, op_ok)
    touched = touched | wmark
    n_touched = _sum(touched)

    lane = slot % bs
    if spec.append_impl == "ref":
        Wp = min(spec.probe_width, spec.dmax)
        d_e, w_e, t_e, _ = _gather_vertex_entries(spec, pool, vt, probe_u,
                                                  Wp)
        t_match = torch.where(d_e == v2[:, None], t_e, 0)
        newest = torch.argmax(t_match, dim=1)
        win_was_live = (t_match.max(dim=1).values > 0) & \
            (w_e.gather(1, newest[:, None])[:, 0] != 0)
        probe_blind = torch.any((probe_u >= 0) & (p_sz > Wp))
        _scatter_entries(pool, tgt_blk, lane, op_ok, sv, sw_, sts)
    else:
        # fused append: slot scatter + full-extent last-writer probe,
        # exact liveness (never blind), in place on the pool
        impl = "plain" if spec.append_impl == "plain" else "auto"
        win_was_live = kops.append_edges(
            pool.dst, pool.weight, pool.ts, tgt_blk, lane, op_ok, sv, sw_,
            sts, p_start, p_sz, p_v, impl=impl)
        probe_blind = torch.zeros((), dtype=torch.bool, device=dev)

    was_live = torch.where(fold_hit, fold_live, win_was_live)
    delta = _sum(torch.where(pair_last & ok2, (w2 != 0).to(I32) -
                             was_live.to(I32), 0))

    # size += written count per group
    wrote = op_ok.to(I32)
    wrote_per_group = torch.zeros((B,), dtype=I32, device=dev)
    scatter_add_(wrote_per_group, g["gid"], wrote, real)
    scatter_add_(vt.size, g["gu"], wrote_per_group, g["gvalid"])

    pool = pool._replace(
        clock=pool.clock + B,
        garbage=pool.garbage + _sum(wrote) // 4,
        overflow=pool.overflow + (dropped > 0).to(I32),
        live_m=pool.live_m + delta,
        live_dirty=torch.maximum(pool.live_dirty,
                                 ((dropped > 0) | probe_blind).to(I32)),
        tiles_scanned=pool.tiles_scanned + n_touched)
    return pool, vt, dropped


# --------------------------------------------------------------------------
# reads
# --------------------------------------------------------------------------

def get_neighbors(spec: PoolSpec, pool: EdgePool, vt: VertexTable,
                  u: torch.Tensor, read_ts=None, width: int | None = None):
    """MVCC get-neighbors for a batch of vertex offsets. Returns
    (dst, weight, ts, count) with rows front-packed in reverse-scan order.
    ``read_ts`` is a host int (or None)."""
    width = spec.dmax if width is None else width
    n_cap = vt.size.shape[0]
    d, w, t, size = _gather_vertex_entries(spec, pool, vt, u, width)
    dt = _take(vt.del_time, d.clamp(0, n_cap - 1))
    if read_ts is None:
        dead = (d >= 0) & (dt != 0)
    else:
        rts = int(read_ts)
        dead = (d >= 0) & (((dt > 0) & (dt <= rts)) | (dt == -1))
    d = torch.where(dead, -1, d)
    return kops.compact_rows(d, w, t, size, read_ts=read_ts,
                             impl=spec.compact_impl)


def live_edges(spec: PoolSpec, pool: EdgePool, vt: VertexTable,
               read_ts=None):
    """Flat snapshot of live edges: (owner, dst, weight, ts, keep_mask),
    sorted by (owner, dst)."""
    bs = spec.block_size
    nb = pool.dst.shape[0]
    n_cap = vt.size.shape[0]
    N = nb * bs
    dev = pool.dst.device
    own = pool.owner.repeat_interleave(bs)
    d = pool.dst.reshape(-1)
    w = pool.weight.reshape(-1)
    t = pool.ts.reshape(-1)
    e = _ar(N, dev)
    ownc = own.clamp(0, n_cap - 1)
    pos = (e // bs - _take(vt.start_block, ownc)) * bs + e % bs
    del e
    occupied = (own >= 0) & (pos >= 0) & (pos < _take(vt.size, ownc))
    del pos
    alive = _take(vt.del_time, ownc) == 0
    del ownc
    dst_ok = (d >= 0) & (_take(vt.del_time, d.clamp(0, n_cap - 1)) == 0)
    valid = occupied & alive & dst_ok
    del occupied, alive, dst_ok
    if read_ts is not None:
        valid = valid & (t <= int(read_ts))
    so = torch.where(valid, own, INT_MAX)
    del own
    sd = torch.where(valid, d, INT_MAX)
    stv = torch.where(valid, t, 0)
    order = lexsort((stv, sd, so))
    so, sd, sw, stv = so[order], sd[order], w[order], stv[order]
    del order
    is_last = ((so != shift_next(so, -2)) | (sd != shift_next(sd, -2))) & \
        (so < INT_MAX)
    keep = is_last & (sw != 0)
    return so, sd, sw, stv, keep
