"""RadixGraph — the paper's full structure behind an ID-level API (port of
``repro.core.radixgraph``).

The ``step_*`` functions are plain functions of (static specs, GraphState,
batched tensors). They update the state's tensors IN PLACE and return the
new state. The host facade ``RadixGraph`` owns the live state and keeps
JAX's MVCC guarantees: wherever the JAX package would not donate the state
(``donate_apply=False``, or a state pinned by an epoch capture or an MVCC
checkpoint), the facade copies the state before mutating it, so every
retained version stays readable and unchanged.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from . import edgepool as ep
from . import sort as sort_mod
from . import vertex_table as vt_mod
from .keys import pack_keys
from .sort import SortSpec, SortState
from .sort_optimizer import SortConfig, optimize_sort
from .tensor_ops import I32, scatter_add_, scatter_set_
from .vertex_table import VertexTable

__all__ = ["RadixGraph", "GraphState", "GraphSnapshot", "step_add_vertices",
           "step_delete_vertices", "step_update_edges",
           "step_update_edges_pipelined", "step_lookup",
           "step_degree_counts", "step_neighbors", "step_snapshot",
           "interleave_undirected", "clone_state"]


def interleave_undirected(src, dst, w):
    """Undirected edge-op doubling: interleave the two directions so the
    mixed-op stream order is preserved (op i lands at timestamps 2i,
    2i+1)."""
    s2 = np.empty(2 * len(src), np.uint64)
    d2 = np.empty_like(s2)
    w2 = np.empty(2 * len(src), np.float32)
    s2[0::2], s2[1::2] = src, dst
    d2[0::2], d2[1::2] = dst, src
    w2[0::2], w2[1::2] = w, w
    return s2, d2, w2


class GraphState(NamedTuple):
    sort: SortState
    vt: VertexTable
    pool: ep.EdgePool


class GraphSnapshot(NamedTuple):
    """CSR view of the live graph (analytics input). Padded to m_cap."""

    indptr: torch.Tensor   # int32[n_cap + 1]
    dst: torch.Tensor      # int32[m_cap] destination offsets
    weight: torch.Tensor   # float32[m_cap]
    n_rows: torch.Tensor   # int32 — vertex-table high-water mark
    m: torch.Tensor        # int32 — live edge count
    active: torch.Tensor   # bool[n_cap] — row is a live vertex
    ids: torch.Tensor      # int64[n_cap, 2] — row -> vertex ID (a copy)


def clone_state(state: GraphState) -> GraphState:
    """A deep copy: the new state shares no tensor with ``state``."""
    s, vt, pool = state
    return GraphState(
        SortState(tuple(p.clone() for p in s.pools), s.counts.clone(),
                  s.overflow.clone()),
        VertexTable(*(t.clone() for t in vt)),
        ep.EdgePool(*(t.clone() for t in pool)))


# --------------------------------------------------------------------------
# per-shard state transitions
# --------------------------------------------------------------------------

def step_add_vertices(sspec: SortSpec, pspec: ep.PoolSpec, state: GraphState,
                      keys, mask):
    """Locate-or-insert vertices. Returns (state, offsets, created)."""
    st, vt, off, created = vt_mod.ensure_vertices(sspec, state.sort, state.vt,
                                                  keys, mask)
    return GraphState(st, vt, state.pool), off, created


def step_delete_vertices(sspec: SortSpec, pspec: ep.PoolSpec,
                         state: GraphState, keys, mask):
    """Mark vertices deleted at the current clock. Returns
    (state, offsets, found)."""
    ts = state.pool.clock
    st, vt, off, found = vt_mod.delete_vertices(sspec, state.sort, state.vt,
                                                keys, mask, ts)
    # a vertex delete hides every incident edge at read time; in-degrees
    # are not tracked, so the live counter goes stale until a recount
    any_del = (found.to(I32).sum(dtype=I32) > 0).to(I32)
    pool = state.pool._replace(
        clock=state.pool.clock + 1,
        live_dirty=torch.maximum(state.pool.live_dirty, any_del))
    return GraphState(st, vt, pool), off, found


def step_update_edges(sspec: SortSpec, pspec: ep.PoolSpec, state: GraphState,
                      src_keys, dst_keys, w, mask):
    """Apply a batch of edge ops by vertex KEY (``w == 0`` deletes).
    Returns (state, dropped): ops refused at vertex-table or pool
    capacity."""
    B = src_keys.shape[0]
    keys = torch.cat([src_keys, dst_keys], 0)
    m2 = torch.cat([mask, mask])
    st, vt, off, _ = vt_mod.ensure_vertices(sspec, state.sort, state.vt,
                                            keys, m2)
    u, v = off[:B], off[B:]
    vtx_dropped = (mask & ((u < 0) | (v < 0))).to(I32).sum(dtype=I32)
    pool, vt, dropped = ep.apply_edge_updates(pspec, state.pool, vt, u, v, w,
                                              mask)
    return GraphState(st, vt, pool), dropped + vtx_dropped


def step_update_edges_pipelined(sspec: SortSpec, pspec: ep.PoolSpec,
                                state: GraphState, src_keys, dst_keys, w,
                                mask):
    """Apply a STACKED (K, B, ...) super-batch: a loop of
    ``step_update_edges`` (JAX runs it as one ``lax.scan``). Returns
    (state, summed drops)."""
    drops = []
    for k in range(src_keys.shape[0]):
        state, d = step_update_edges(sspec, pspec, state, src_keys[k],
                                     dst_keys[k], w[k], mask[k])
        drops.append(d)
    return state, torch.stack(drops).sum(dtype=I32)


def step_lookup(sspec: SortSpec, pspec: ep.PoolSpec, state: GraphState, keys):
    """Key -> vertex-table offset (-1 absent)."""
    return sort_mod.lookup(sspec, state.sort, keys)


def step_degree_counts(sspec: SortSpec, pspec: ep.PoolSpec, state: GraphState,
                       keys, read_ts=None):
    """Live out-degree per query key; 0 for absent vertices."""
    off = sort_mod.lookup(sspec, state.sort, keys)
    return ep.get_neighbors(pspec, state.pool, state.vt, off,
                            read_ts=read_ts)[3]


def step_neighbors(sspec: SortSpec, pspec: ep.PoolSpec, state: GraphState,
                   keys, width: int, read_ts=None):
    """Key->offset lookup + MVCC get-neighbors. Returns (dst_offsets,
    weights, ts, counts) with rows front-packed."""
    off = sort_mod.lookup(sspec, state.sort, keys)
    return ep.get_neighbors(pspec, state.pool, state.vt, off,
                            read_ts=read_ts, width=width)


def step_snapshot(sspec: SortSpec, pspec: ep.PoolSpec, m_cap: int,
                  state: GraphState, read_ts=None):
    """CSR ``GraphSnapshot`` of the live (or ``read_ts``-versioned) graph.
    The snapshot owns its tensors (``ids`` is copied), so later in-place
    applies never change it."""
    vt = state.vt
    n_cap = vt.size.shape[0]
    dev = vt.size.device
    so, sd, sw, stv, keep = ep.live_edges(pspec, state.pool, vt,
                                          read_ts=read_ts)
    m = keep.to(I32).sum(dtype=I32)
    counts = torch.zeros((n_cap,), dtype=I32, device=dev)
    scatter_add_(counts, so, 1, keep)
    indptr = torch.cat([torch.zeros((1,), dtype=I32, device=dev),
                        torch.cumsum(counts, 0, dtype=I32)])
    kpos = torch.cumsum(keep.to(I32), 0, dtype=I32) - 1
    ok = keep & (kpos < m_cap)
    dst = torch.full((m_cap,), -1, dtype=I32, device=dev)
    wgt = torch.zeros((m_cap,), dtype=torch.float32, device=dev)
    scatter_set_(dst, kpos, sd, ok)
    scatter_set_(wgt, kpos, sw, ok)
    return GraphSnapshot(indptr=indptr, dst=dst, weight=wgt,
                         n_rows=vt.num_rows.clone(), m=m,
                         active=vt.del_time == 0, ids=vt.ids.clone())


def _defrag(sspec: SortSpec, pspec: ep.PoolSpec, state: GraphState,
            incoming=None):
    pool, vt = ep.defrag(pspec, state.pool, state.vt, incoming)
    return GraphState(state.sort, vt, pool)


# --------------------------------------------------------------------------


@dataclass
class RadixGraph:
    """Dynamic graph store. ``n_max`` vertices / ``pool_blocks`` blocks are
    hard capacities; overflow is counted, never UB. Fields as in the JAX
    package, plus ``device`` (default ``'cuda'``; raises without a card)
    and ``lookup_impl`` (the SORT descent: ``'auto'`` kernel wrapper,
    ``'ref'`` plain version). Impl values: see ``edgepool.PoolSpec``."""

    n_max: int
    key_bits: int = 32
    expected_n: Optional[int] = None
    layers: Optional[int] = None
    pool_blocks: Optional[int] = None
    block_size: int = 16
    k_max: int = 256
    dmax: int = 4096
    batch: int = 4096
    undirected: bool = False
    probe_width: int = 256
    k_big: int = 16
    append_impl: str = "auto"
    compact_impl: str = "auto"
    defrag_impl: str = "auto"
    capacity_factor: Optional[float] = None
    policy: str = "snaplog"
    buf_blocks: int = 1
    sort_config: Optional[SortConfig] = None
    pipeline_depth: int = 8
    donate_apply: bool = True   # mutate in place when the state is unpinned
    fuse_scan: bool = False
    device: str = "cuda"
    lookup_impl: str = "auto"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        n = self.expected_n or self.n_max
        l = self.layers or max(2, round(math.log2(max(2, self.key_bits))))
        self.config: SortConfig = self.sort_config or optimize_sort(
            n, self.key_bits, l)
        self.sort_spec = SortSpec.from_config(self.config, self.n_max,
                                              self.capacity_factor,
                                              self.lookup_impl)
        nb = self.pool_blocks or max(64, (8 * self.n_max) // self.block_size)
        self.pool_spec = ep.PoolSpec(n_blocks=nb, block_size=self.block_size,
                                     k_max=self.k_max, dmax=self.dmax,
                                     probe_width=self.probe_width,
                                     k_big=self.k_big,
                                     append_impl=self.append_impl,
                                     compact_impl=self.compact_impl,
                                     defrag_impl=self.defrag_impl,
                                     policy=self.policy,
                                     buf_blocks=self.buf_blocks)
        dev = self.device
        self.state = GraphState(
            sort=sort_mod.make_sort(self.sort_spec, dev),
            vt=vt_mod.make_vertex_table(self.n_max, dev),
            pool=ep.make_edge_pool(self.pool_spec, dev),
        )
        self._versions: list = []   # (label, version_ts, state)
        self.dropped_ops: int = 0
        self._snap_cache: dict = {}
        self._epoch: int = 0
        self.snapshot_hits: int = 0
        self.snapshot_misses: int = 0
        self.defrag_ms: float = 0.0
        self.defrag_host_ms: float = 0.0
        self.defrag_sync_ms: float = 0.0
        self.defrag_batches: int = 0
        self._seen_defrags: int = 0
        # a pinned state is held outside the facade (epoch capture, MVCC
        # version): the next mutation copies it first instead of updating
        # it in place
        self._pinned: Optional[GraphState] = None
        self.state_copies: int = 0
        self.pipe_flushes: int = 0
        self.pipe_super_batches: int = 0
        self.pipe_stage_ms: float = 0.0
        self.pipe_sync_ms: float = 0.0

    # ---- batching helpers ----
    def _pad(self, arr, fill, dtype):
        a = np.asarray(arr)
        B = self.batch
        n = a.shape[0]
        nb = ((n + B - 1) // B) * B if n else B
        out = np.full((nb,) + a.shape[1:], fill, dtype=dtype)
        if n:
            out[:n] = a
        mask = np.zeros((nb,), bool)
        mask[:n] = True
        return out, mask

    def _key_batches(self, ids):
        ids = np.asarray(ids, np.uint64)
        padded, mask = self._pad(ids, 0, np.uint64)
        keys = pack_keys(padded, self.key_bits, self.device)
        m = torch.from_numpy(mask).to(self.device)
        for i in range(0, padded.shape[0], self.batch):
            yield keys[i:i + self.batch], m[i:i + self.batch]

    def _invalidate(self):
        """Every mutating op seals a new epoch: cached CSR snapshots of the
        previous epoch are dropped."""
        self._epoch += 1
        self._snap_cache.clear()

    def _writable(self) -> GraphState:
        """The live state, copied first when it must not change in place."""
        if not self.donate_apply or self.state is self._pinned:
            self.state = clone_state(self.state)
            self.state_copies += 1
        return self.state

    # ---- public API ----
    def add_vertices(self, ids):
        self._invalidate()
        offs = []
        for keys, mask in self._key_batches(ids):
            self.state, off, _ = step_add_vertices(
                self.sort_spec, self.pool_spec, self._writable(), keys, mask)
            offs.append(off.cpu().numpy())
        n = len(np.asarray(ids))
        return np.concatenate(offs)[:n] if offs else np.zeros(0, np.int32)

    def delete_vertices(self, ids):
        self._invalidate()
        for keys, mask in self._key_batches(ids):
            self.state, _, _ = step_delete_vertices(
                self.sort_spec, self.pool_spec, self._writable(), keys, mask)

    def lookup(self, ids):
        out = []
        n = len(np.asarray(ids))
        for keys, _ in self._key_batches(ids):
            out.append(step_lookup(self.sort_spec, self.pool_spec,
                                   self.state, keys).cpu().numpy())
        return np.concatenate(out)[:n] if out else np.zeros(0, np.int32)

    def _edge_super_batches(self, src, dst, w):
        """Super-batches of depth <= ``pipeline_depth``: k flat (B, ...)
        batch tuples, or ONE stacked (k, B, ...) tuple when ``fuse_scan``.
        The whole flush is packed and copied to the device at once."""
        src = np.asarray(src, np.uint64)
        dst = np.asarray(dst, np.uint64)
        w = np.asarray(w, np.float32)
        if self.undirected:
            src, dst, w = interleave_undirected(src, dst, w)
        ps, mask = self._pad(src, 0, np.uint64)
        pd, _ = self._pad(dst, 0, np.uint64)
        pw, _ = self._pad(w, 0, np.float32)
        B = self.batch
        NB = ps.shape[0] // B
        K = max(1, int(self.pipeline_depth))
        dev = self.device
        sk = pack_keys(ps, self.key_bits, dev)
        dk = pack_keys(pd, self.key_bits, dev)
        tw = torch.from_numpy(pw).to(dev)
        tm = torch.from_numpy(mask).to(dev)
        i = 0
        while i < NB:
            k = min(K, NB - i)
            lo, hi = i * B, (i + k) * B
            if k > 1 and self.fuse_scan:
                yield k, (sk[lo:hi].reshape(k, B, 2),
                          dk[lo:hi].reshape(k, B, 2),
                          tw[lo:hi].reshape(k, B), tm[lo:hi].reshape(k, B))
            else:
                yield k, [(sk[a:a + B], dk[a:a + B], tw[a:a + B],
                           tm[a:a + B]) for a in range(lo, hi, B)]
            i += k

    def _note_spike(self, t0: float, t1: Optional[float] = None):
        """Attribute the finished op's wall time to the spike accounting
        when it paid a global rebuild."""
        d = int(self.state.pool.defrags)
        if d != self._seen_defrags:
            now = time.perf_counter()
            self.defrag_ms += (now - t0) * 1000.0
            self.defrag_host_ms += ((t1 if t1 is not None else now) - t0) \
                * 1000.0
            if t1 is not None:
                self.defrag_sync_ms += (now - t1) * 1000.0
            self.defrag_batches += d - self._seen_defrags
            self._seen_defrags = d

    def pin_live_state(self):
        """Exempt the CURRENT state from in-place updates: an external
        handle (epoch capture, MVCC checkpoint) may retain it."""
        self._pinned = self.state

    def _apply_edge_batches(self, src, dst, w):
        self._invalidate()
        t0 = time.perf_counter()
        drops = []
        for k, xs in self._edge_super_batches(src, dst, w):
            if isinstance(xs, list):
                for x in xs:
                    self.state, d = step_update_edges(
                        self.sort_spec, self.pool_spec, self._writable(), *x)
                    drops.append(d)
            else:
                self.state, d = step_update_edges_pipelined(
                    self.sort_spec, self.pool_spec, self._writable(), *xs)
                drops.append(d)
            self.pipe_super_batches += 1
        self.pipe_stage_ms += (time.perf_counter() - t0) * 1000.0
        t1 = time.perf_counter()
        # ONE drop-count fetch per flush
        if drops:
            self.dropped_ops += int(torch.stack(drops).sum())
        self.pipe_sync_ms += (time.perf_counter() - t1) * 1000.0
        self.pipe_flushes += 1
        self._note_spike(t0, t1)

    def add_edges(self, src, dst, weight=None):
        w = np.ones(len(np.asarray(src)), np.float32) if weight is None \
            else np.asarray(weight, np.float32)
        if not np.all(w != 0):
            raise ValueError("weight 0 is the NULL tombstone; use "
                             "delete_edges")
        self._apply_edge_batches(src, dst, w)

    update_edges = add_edges

    def delete_edges(self, src, dst):
        self._apply_edge_batches(src, dst,
                                 np.zeros(len(np.asarray(src)), np.float32))

    def apply_ops(self, src, dst, weight):
        """Order-preserving mixed stream: weight==0 deletes, else
        insert/update."""
        self._apply_edge_batches(src, dst, np.asarray(weight, np.float32))

    def neighbor_batches(self, state: GraphState, ids, width: int,
                         read_ts=None):
        """(dst_offsets, weights, counts) as numpy for ``ids``, one padded
        key batch at a time."""
        ds, ws, cs = [], [], []
        for keys, _ in self._key_batches(ids):
            bd, bw, _, bcnt = step_neighbors(self.sort_spec, self.pool_spec,
                                             state, keys, width, read_ts)
            ds.append(bd)
            ws.append(bw)
            cs.append(bcnt)
        n = len(np.asarray(ids))
        return torch.cat(ds)[:n], torch.cat(ws)[:n], torch.cat(cs)[:n]

    @staticmethod
    def rows_as_ids(state: GraphState, d, w, cnt):
        """Front-packed neighbor rows -> [(neighbor IDs uint64, weights)],
        gathering the IDs of the valid entries only, on the device."""
        sel = d >= 0
        offs = d[sel].to(torch.int64)
        kk = state.vt.ids[offs].cpu().numpy().astype(np.uint64)
        gids = (kk[:, 0] << np.uint64(32)) | kk[:, 1]
        wv = w[sel].cpu().numpy()
        cnt = cnt.cpu().numpy()
        ends = np.cumsum(cnt)
        return [(gids[e - c:e], wv[e - c:e]) for c, e in zip(cnt, ends)]

    def neighbors(self, ids, width=None, read_ts=None, as_ids=True):
        """Get-neighbors for a batch of vertex IDs (paper: O(d) each)."""
        width = width or self.pool_spec.dmax
        d, w, cnt = self.neighbor_batches(self.state, ids, width, read_ts)
        if as_ids:
            return self.rows_as_ids(self.state, d, w, cnt)
        d, w, cnt = d.cpu().numpy(), w.cpu().numpy(), cnt.cpu().numpy()
        return [(d[i, :cnt[i]], w[i, :cnt[i]]) for i in range(d.shape[0])]

    def snapshot(self, read_ts=None, m_cap=None) -> GraphSnapshot:
        """Epoch-cached CSR view of the live state."""
        m_cap = m_cap or self.pool_spec.capacity_entries
        key = (None if read_ts is None else int(read_ts), m_cap)
        hit = self._snap_cache.get(key)
        if hit is not None and hit[0] is self.state:
            self.snapshot_hits += 1
            return hit[1]
        self.snapshot_misses += 1
        snap = step_snapshot(self.sort_spec, self.pool_spec, m_cap,
                             self.state, read_ts)
        self._snap_cache[key] = (self.state, snap)
        return snap

    def snapshot_at(self, ts: int, m_cap=None) -> GraphSnapshot:
        """Historical CSR snapshot at operation timestamp ``ts``, answered
        by the EARLIEST retained version whose version_ts >= ts (or the
        live state)."""
        if ts >= self.current_ts:
            return self.snapshot(m_cap=m_cap)
        cands = [v for v in self._versions if v[1] >= ts]
        state = min(cands, key=lambda v: v[1])[2] if cands else self.state
        if state is self.state:
            return self.snapshot(read_ts=ts, m_cap=m_cap)
        m_cap = m_cap or self.pool_spec.capacity_entries
        return step_snapshot(self.sort_spec, self.pool_spec, m_cap, state, ts)

    @property
    def current_ts(self) -> int:
        return int(self.state.pool.clock) - 1

    def checkpoint_version(self, label: Optional[int] = None):
        """Retain the current state as an MVCC version; returns its ts."""
        ts = self.current_ts
        self.pin_live_state()
        self._versions.append((label if label is not None else ts, ts,
                               self.state))
        return ts

    def retain_version(self, state: GraphState, label: int):
        """Retain an ARBITRARY captured state as an MVCC version."""
        ts = int(state.pool.clock) - 1
        if state is self.state:
            self.pin_live_state()
        self._versions.append((label, ts, state))
        return ts

    def release_version(self, label: int) -> int:
        kept = [v for v in self._versions if v[0] != label]
        released = len(self._versions) - len(kept)
        self._versions = kept
        return released

    @property
    def retained_versions(self) -> list:
        return [(lbl, ts) for lbl, ts, _ in self._versions]

    def defrag(self, pending_src=None):
        """Explicit global rebuild; ``pending_src`` pre-sizes extents for
        the source IDs of a batch about to be applied."""
        self._invalidate()
        incoming = None
        if pending_src is not None:
            offs = torch.from_numpy(self.lookup(
                np.asarray(pending_src, np.uint64))).to(self.device)
            incoming = torch.zeros((self.n_max,), dtype=I32,
                                   device=self.device)
            scatter_add_(incoming, offs, 1, offs >= 0)
        t0 = time.perf_counter()
        self.state = _defrag(self.sort_spec, self.pool_spec,
                             self._writable(), incoming)
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._note_spike(t0, t1)

    # ---- introspection ----
    @property
    def num_vertices(self) -> int:
        return int(vt_mod.num_active(self.state.vt))

    @property
    def num_edges(self) -> int:
        """Live edge count from the incrementally maintained counter; a
        dirty counter is recounted from the (cached) snapshot and written
        back."""
        pool = self.state.pool
        if int(pool.live_dirty):
            snap = self.snapshot()
            m = int(snap.m)
            self.state = GraphState(self.state.sort, self.state.vt,
                                    pool._replace(
                                        live_m=torch.full_like(pool.live_m,
                                                               m),
                                        live_dirty=torch.zeros_like(
                                            pool.live_dirty)))
            m_cap = self.pool_spec.capacity_entries
            self._snap_cache[(None, m_cap)] = (self.state, snap)
            # the patched state shares tensors with the pre-patch one,
            # which callers may hold
            self.pin_live_state()
            return m
        return int(pool.live_m)

    @property
    def num_defrags(self) -> int:
        return int(self.state.pool.defrags)

    @property
    def tiles_scanned(self) -> int:
        return int(self.state.pool.tiles_scanned)

    def memory_bytes(self, materialized=True) -> int:
        """Paper-comparable memory: SORT slots (4B), vertex rows (32B),
        occupied edge blocks (12B/entry)."""
        if materialized:
            sort_b = int(sort_mod.materialized_slots(self.sort_spec,
                                                     self.state.sort)) * 4
            vrows = int(self.state.vt.num_rows) * 32
            blocks = int((self.state.pool.owner >= 0).sum())
            return sort_b + vrows + blocks * self.pool_spec.block_size * 12
        sort_b = sum(self.sort_spec.pool_sizes()) * 4
        vrows = self.n_max * 32
        return sort_b + vrows + self.pool_spec.capacity_entries * 12

    @property
    def overflowed(self) -> bool:
        return bool(int(self.state.sort.overflow) or
                    int(self.state.vt.overflow) or
                    int(self.state.pool.overflow))
