"""``GraphStore`` front door of the port: ``LocalStore`` over the eager
single-shard ``RadixGraph`` and ``ShardedStore`` over the sharded engine
``repro_torch.dist.graph_engine`` (port of ``repro.api.store``; the sharded
backend's ingest, reads and analytics).

Epochs: ``capture()`` returns an O(1) handle to the current state and pins
it, so the next apply copies instead of updating it in place; every read
and analytics call accepts ``at=handle`` to answer against that version.
Analytics run on the store's device; ``analytics_advance`` moves a cached
result across epochs over the epoch delta (on the host, or through a
sharded warm program).

Durability hooks (``durable_state``, ``load_durable_state``, ``checkpoint``,
``restore``) serve ``repro_torch.storage``, whose checkpoints share their
on-disk format with the JAX package's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from .. import resolve_device
from ..convert import state_from_numpy
from ..core import edgepool as ep
from ..core import epoch_delta as ed
from ..core import radixgraph as rg
from ..core import vertex_table as vt_mod
from ..core.keys import pack_keys, unpack_keys
from ..core.radixgraph import RadixGraph, clone_state, interleave_undirected
from ..core.sort import SortSpec
from ..core.sort_optimizer import optimize_sort
from ..core.status import Reason
from ..dist import graph_engine as ge
from .ir import (AnalyticsOp, AnalyticsResult, ApplyResult, OpBatch, ReadOp,
                 UnsupportedOpError)
from .registry import AnalyticsSpec, analytics_spec

__all__ = ["GraphStore", "Epoch", "LocalStore", "ShardedStore", "make_store",
           "register_backend", "available_backends"]

_M32 = 0xFFFFFFFF       # the absent-key sentinel word of a padded batch


@dataclasses.dataclass(frozen=True)
class Epoch:
    """Immutable capture of a store's state. Holding an Epoch IS retaining
    the MVCC version; ``cache`` rides the handle (the CSR snapshot)."""

    state: Any
    seq: int
    cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)


@runtime_checkable
class GraphStore(Protocol):
    backend: str
    n_shards: int

    def apply(self, batch: OpBatch) -> ApplyResult: ...
    def read(self, op: ReadOp, at: Optional[Epoch] = None) -> Any: ...
    def analytics(self, op: AnalyticsOp,
                  at: Optional[Epoch] = None) -> Any: ...
    def capture(self) -> Epoch: ...
    def clock(self, at: Optional[Epoch] = None) -> int: ...


def _stale_gen(prev_handle: Optional[Epoch], at: Optional[Epoch],
               gen: int) -> bool:
    """True when either epoch handle predates the store's last
    ``restore()`` — ``capture`` stamps handles with the restore
    generation, so a warm chain can never silently span a restore."""
    return any(ep is not None and ep.cache.get("gen", 0) != gen
               for ep in (prev_handle, at))


class _CheckpointHooks:
    """``checkpoint`` / ``restore`` of a store with ``durable_state`` and
    ``load_durable_state``: both forward to ``repro_torch.storage``."""

    def checkpoint(self, directory, **kw):
        """Write an epoch-consistent checkpoint of the live state (full or
        incremental — see ``repro_torch.storage.checkpoint``)."""
        from ..storage.checkpoint import save_graph_checkpoint
        return save_graph_checkpoint(directory, self, **kw)

    def restore(self, directory, ckpt_id: Optional[int] = None):
        """Restore the live state from the latest (or given) valid
        checkpoint chain under ``directory``."""
        from ..storage.checkpoint import restore_graph_checkpoint
        return restore_graph_checkpoint(directory, self, ckpt_id)


class LocalStore(_CheckpointHooks):
    """Single-shard backend: the eager ``RadixGraph`` behind the IR.

    Constructor kwargs are ``RadixGraph``'s (``device`` included, default
    ``'cuda'``) plus ``m_cap``, the CSR pad of snapshots and analytics
    (analytics cost scales with it, so callers pass a tight bound), and
    ``max_delta_frac``, the largest delta (changed pairs over live edges)
    an advance takes before it recomputes. The graph stays reachable as
    ``.graph``."""

    backend = "local"
    supported_ops = frozenset(("edges", "add_vertices", "delete_vertices"))

    def __init__(self, m_cap: Optional[int] = None,
                 max_delta_frac: float = 0.1, **graph_kwargs):
        self.graph = RadixGraph(**graph_kwargs)
        self.n_shards = 1
        self.m_cap = m_cap or self.graph.pool_spec.capacity_entries
        self.max_delta_frac = max_delta_frac
        self._seq = 0
        # bumped by every restore(): epoch handles captured before it are
        # no longer delta-safe
        self._restore_gen = 0
        self.stats = dict(ops_applied=0, ops_dropped=0, defrags=0,
                          defrag_ms=0.0, defrag_host_ms=0.0,
                          defrag_sync_ms=0.0, tiles_scanned=0,
                          flushes=0, super_batches=0,
                          host_stage_ms=0.0, device_sync_ms=0.0)

    # ---- mutation ----
    def apply(self, batch: OpBatch) -> ApplyResult:
        if len(batch) == 0:
            return ApplyResult(0, 0)
        self._seq += 1
        g = self.graph
        if batch.kind == "edges":
            d0 = g.dropped_ops
            g.apply_ops(batch.src, batch.dst, batch.weight)
            res = ApplyResult(len(batch), g.dropped_ops - d0)
        else:
            o0 = int(g.state.vt.overflow)
            if batch.kind == "add_vertices":
                g.add_vertices(batch.ids)
            else:
                g.delete_vertices(batch.ids)
            res = ApplyResult(len(batch), int(g.state.vt.overflow) - o0)
        self.stats["ops_applied"] += res.applied
        self.stats["ops_dropped"] += res.dropped
        self.stats["defrags"] = g.num_defrags
        self.stats["defrag_ms"] = round(g.defrag_ms, 3)
        self.stats["defrag_host_ms"] = round(g.defrag_host_ms, 3)
        self.stats["defrag_sync_ms"] = round(g.defrag_sync_ms, 3)
        self.stats["tiles_scanned"] = g.tiles_scanned
        self.stats["flushes"] = g.pipe_flushes
        self.stats["super_batches"] = g.pipe_super_batches
        self.stats["host_stage_ms"] = round(g.pipe_stage_ms, 3)
        self.stats["device_sync_ms"] = round(g.pipe_sync_ms, 3)
        return res

    # ---- epochs ----
    def capture(self) -> Epoch:
        self.graph.pin_live_state()
        return Epoch(self.graph.state, self._seq,
                     cache={"gen": self._restore_gen})

    def clock(self, at: Optional[Epoch] = None) -> int:
        state = at.state if at is not None else self.graph.state
        return int(state.pool.clock) - 1

    def _state(self, at: Optional[Epoch]):
        return at.state if at is not None else self.graph.state

    # ---- reads ----
    def _per_key(self, state, ids, fn):
        out = [fn(state, keys).cpu().numpy()
               for keys, _ in self.graph._key_batches(ids)]
        n = len(np.asarray(ids))
        return (np.concatenate(out)[:n] if out
                else np.zeros((0,), np.int32))

    def _snap(self, at: Optional[Epoch]):
        if at is None:
            return self.graph.snapshot(m_cap=self.m_cap)
        snap = at.cache.get("snap")
        if snap is None:
            g = self.graph
            snap = at.cache["snap"] = rg.step_snapshot(
                g.sort_spec, g.pool_spec, self.m_cap, at.state)
        return snap

    def read(self, op: ReadOp, at: Optional[Epoch] = None):
        g = self.graph
        state = self._state(at)
        if op.kind == "lookup":
            off = self._per_key(state, op.ids, lambda s, k: rg.step_lookup(
                g.sort_spec, g.pool_spec, s, k))
            return off >= 0
        if op.kind == "degree":
            return self._per_key(state, op.ids,
                                 lambda s, k: rg.step_degree_counts(
                                     g.sort_spec, g.pool_spec, s, k))
        if op.kind == "neighbors":
            width = op.width or g.pool_spec.dmax
            d, w, cnt = g.neighbor_batches(state, op.ids, width)
            return g.rows_as_ids(state, d, w, cnt)
        if op.kind == "num_vertices":
            if at is None:
                return g.num_vertices
            return int(vt_mod.num_active(at.state.vt))
        if op.kind == "num_edges":
            if at is None:
                return g.num_edges
            return int(self._snap(at).m)
        if op.kind == "snapshot":
            return self._snap(at)
        raise ValueError(op.kind)

    # ---- analytics ----
    def _resolve_dyn(self, spec: AnalyticsSpec, state, params: dict):
        """Pop dyn params and resolve IDs -> row offsets. Returns
        ``(dyn, dyn_rows, absent_source)``; ``dyn_rows`` carries the host
        ints the advance phases take."""
        g = self.graph
        look = lambda s, k: rg.step_lookup(  # noqa: E731
            g.sort_spec, g.pool_spec, s, k)
        dev = g.device
        dyn, dyn_rows, absent_source = [], [], False
        for pname, kind in spec.dyn:
            v = params.pop(pname)
            if kind == "id":
                off = self._per_key(state, np.asarray([v], np.uint64),
                                    look)[0]
                if off < 0:
                    absent_source = True
                dyn_rows.append(max(int(off), 0))
                dyn.append(max(int(off), 0))
            else:
                off = self._per_key(state, np.asarray(v, np.uint64), look)
                if spec.result == "per_query":
                    dyn.append((torch.from_numpy(np.clip(off, 0, None)).to(
                        dev), off))
                else:
                    # per-vertex source sets (BC): absent sources
                    # contribute nothing — drop them, like the mesh loop
                    dyn.append(torch.from_numpy(off[off >= 0]).to(dev))
        return dyn, dyn_rows, absent_source

    def _per_vertex_value(self, raw: np.ndarray, snap) -> dict:
        """``{vertex ID: value}`` over every live row, built on the host
        (one dict entry per live vertex, as in the JAX package)."""
        active = snap.active.cpu().numpy()
        vids = unpack_keys(snap.ids)
        return dict(zip(vids[active].tolist(), raw[active].tolist()))

    def analytics(self, op: AnalyticsOp, at: Optional[Epoch] = None):
        return self.analytics_result(op, at).value

    def analytics_result(self, op: AnalyticsOp, at: Optional[Epoch] = None,
                         _reason: str = "") -> AnalyticsResult:
        """From-scratch run on the store's device, answered as an
        ``AnalyticsResult`` whose ``raw`` per-row values seed a later
        ``analytics_advance``."""
        spec = analytics_spec(op.name)
        state = self._state(at)
        snap = self._snap(at)
        params = dict(op.params)
        dyn, _rows, absent_source = self._resolve_dyn(spec, state, params)
        n_cap = snap.indptr.shape[0] - 1
        iters = 0
        if absent_source:
            vals = np.full((n_cap,), spec.absent)
        else:
            args = [a[0] if isinstance(a, tuple) else a for a in dyn]
            vals = spec.single(snap, *args, **params)
            if isinstance(vals, tuple):      # convergence entries: (v, it)
                vals, iters = vals[0], int(vals[1])
            vals = vals.cpu().numpy()
        seq = at.seq if at is not None else self._seq
        if spec.result == "scalar":
            v = np.asarray(vals).item()
            return AnalyticsResult(v, seq, "scratch", iters, _reason, v, at)
        if spec.result == "per_query":
            out = np.asarray(vals).copy()
            for a in dyn:
                if isinstance(a, tuple):
                    out[np.asarray(a[1]) < 0] = 0   # absent queries -> 0
            return AnalyticsResult(out, seq, "scratch", iters, _reason,
                                   None, at)
        if spec.canonical_single is not None:
            vals = spec.canonical_single(vals, snap)
        raw = np.asarray(vals)
        return AnalyticsResult(self._per_vertex_value(raw, snap), seq,
                               "scratch", iters, _reason, raw, at)

    def _csr(self, at: Epoch) -> ed.HostCsr:
        h = at.cache.get("hcsr")
        if h is None:
            h = at.cache["hcsr"] = ed.host_csr(self._snap(at))
        return h

    def _delta(self, prev: Epoch, cur: Epoch):
        key = ("delta", prev.seq)
        hit = cur.cache.get(key)
        if hit is None:     # shared across every analytic chained E->E'
            hit = cur.cache[key] = ed.extract_delta(
                prev.state, cur.state, self._csr(prev), self._csr(cur))
        return hit

    def analytics_advance(self, op: AnalyticsOp, prev: AnalyticsResult,
                          at: Optional[Epoch]) -> AnalyticsResult:
        """Advance ``prev`` to epoch ``at`` over the delta, falling back
        to ``analytics_result`` (with the reason recorded) whenever the
        window or the algorithm refuses — callers always get the exact
        answer, ``mode`` just says how it was produced."""
        spec = analytics_spec(op.name)
        if at is None or prev is None:
            return self.analytics_result(op, at, _reason=Reason.NO_WARM)
        if _stale_gen(prev.handle, at, self._restore_gen):
            return self.analytics_result(op, at,
                                         _reason=Reason.RESTORE_BOUNDARY)
        if prev.epoch == at.seq:
            return prev
        if (spec.advance is None or spec.result == "per_query"
                or prev.handle is None or prev.raw is None):
            return self.analytics_result(op, at, _reason=Reason.NO_WARM)
        delta, reason = self._delta(prev.handle, at)
        if delta is None:
            return self.analytics_result(op, at, _reason=reason)
        if delta.n_changed > self.max_delta_frac * max(delta.m_cur, 1):
            return self.analytics_result(op, at,
                                         _reason=Reason.DELTA_TOO_LARGE)
        snap = self._snap(at)
        params = dict(op.params)
        _dyn, rows, absent = self._resolve_dyn(spec, at.state, params)
        if absent:
            return self.analytics_result(op, at,
                                         _reason=Reason.ABSENT_SOURCE)
        out = spec.advance(prev.raw, delta, self._csr(prev.handle),
                           self._csr(at), tuple(rows), params)
        if out is None:
            return self.analytics_result(op, at,
                                         _reason=Reason.ADVANCE_REFUSED)
        raw, iters = out
        if spec.result == "scalar":
            return AnalyticsResult(int(raw), at.seq, "incremental",
                                   int(iters), "", int(raw), at)
        raw = np.asarray(raw)
        return AnalyticsResult(self._per_vertex_value(raw, snap), at.seq,
                               "incremental", int(iters), "", raw, at)

    # ---- epoch retention (MVCC pins) ----
    def pin_epoch(self, at: Epoch):
        self.graph.retain_version(at.state, -(1 + at.seq))

    def release_epoch(self, at: Epoch):
        self.graph.release_version(-(1 + at.seq))

    @property
    def retained_epochs(self) -> int:
        return sum(1 for lab, _, _ in self.graph._versions if lab < 0)

    # ---- durability hooks (repro_torch.storage) ----
    def durable_state(self):
        """The live state plus the HOST counters a restored process needs
        for deterministic resume (capture seq, drop accounting, the defrag
        watermark the spike attribution uses). The state is the live one:
        it stays valid until the next apply."""
        return self.graph.state, dict(
            seq=self._seq, dropped_ops=self.graph.dropped_ops,
            seen_defrags=self.graph._seen_defrags,
            ops_applied=self.stats["ops_applied"],
            ops_dropped=self.stats["ops_dropped"])

    def load_durable_state(self, state, meta: dict):
        """Install a state (a ``GraphState`` of tensors, or of numpy
        arrays in the JAX package's dtypes, as a checkpoint holds) as the
        live image, on the store's device. The store pins it, so the next
        apply copies it instead of updating it in place. Epoch handles
        captured BEFORE this call are lineage-divergent: ``capture`` tags
        handles with a restore generation and ``analytics_advance``
        refuses cross-generation windows (``Reason.RESTORE_BOUNDARY``)."""
        g = self.graph
        g.state = state_from_numpy(state, g.device)
        g._invalidate()
        g.pin_live_state()
        g.dropped_ops = int(meta.get("dropped_ops", 0))
        g._seen_defrags = int(meta.get("seen_defrags",
                                       int(g.state.pool.defrags)))
        self._seq = int(meta.get("seq", 0))
        self.stats["ops_applied"] = int(meta.get("ops_applied", 0))
        self.stats["ops_dropped"] = int(meta.get("ops_dropped", 0))
        self._restore_gen += 1



class ShardedStore(_CheckpointHooks):
    """Sharded backend: vertex-space sharding over ``dist.graph_engine``,
    every shard on one device, stacked on a leading shard axis.

    Constructor kwargs are the JAX package's (``axis`` only names the
    shard axis, so one kwargs dict builds both packages) plus ``device``
    (default ``'cuda'``), resolved here: without the card it names, the
    constructor raises, although the state is allocated lazily. There is no
    mesh, and no fused program: ``fuse_scan`` is accepted and changes
    nothing (each batch is one call of the routed apply either way), while
    ``pipeline_depth`` still groups a flush's batches into super-batches.
    Engine closures are built on first use and cached per static spec
    (``_fn``). The write path keeps the live state vertex-SYNCED
    (incremental registration, skipped for flushes that create no
    vertices), so a captured epoch is analytics-ready.

    Epochs: the engine updates the state in place, so ``capture()`` pins the
    live state and the next apply copies it first (``state_copies``), as
    does every apply with ``donate_steady_state=False``; a captured state
    never changes. Durability hooks (``durable_state``,
    ``load_durable_state``, ``checkpoint``, ``restore``) serve
    ``repro_torch.storage`` as ``LocalStore``'s do: a checkpoint keeps the
    shard axis of every leaf, in the JAX package's format, and a restored
    state is pinned like a captured one. Vertex batches raise
    ``UnsupportedOpError``; an
    analytics op whose registry entry has no sharded program
    (``make_dist=None``: ``triangle_count``) raises
    ``NotImplementedError``."""

    backend = "sharded"
    supported_ops = frozenset(("edges",))   # vertex CRUD: LocalStore only

    def __init__(self, n_shards: int = 1, *, n_per_shard: int = 8192,
                 expected_n: int = 4096, key_bits: int = 32,
                 pool_blocks: int = 16384, block_size: int = 16,
                 k_max: int = 128, dmax: int = 2048,
                 batch: int = 1024, query_batch: int = 256,
                 m_cap: Optional[int] = None, axis: str = "data",
                 undirected: bool = False, pack: bool = True,
                 capacity_factor: float = 1.0,
                 route_budget: Optional[int] = None,
                 frontier_budget: Optional[int] = None,
                 sync_incremental: bool = True,
                 sync_budget: Optional[int] = None,
                 sort_capacity_factor: Optional[float] = None,
                 pipeline_depth: int = 8,
                 donate_steady_state: bool = True,
                 fuse_scan: bool = False,
                 max_delta_frac: float = 0.1,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        assert batch % n_shards == 0 and query_batch % n_shards == 0, \
            "batch sizes must be divisible by the shard count"
        self.n_shards = n_shards
        self.n_per_shard = n_per_shard
        self.key_bits = key_bits
        self.batch = batch
        self.query_batch = query_batch
        self.axis = axis
        self.undirected = undirected
        self.pack = pack
        self.capacity_factor = capacity_factor
        self.route_budget = route_budget
        self.frontier_budget = frontier_budget
        self.sync_incremental = sync_incremental
        self.pipeline_depth = pipeline_depth
        self.donate_steady_state = donate_steady_state
        self.fuse_scan = fuse_scan
        cfg = optimize_sort(expected_n, key_bits, 5)
        self.sspec = SortSpec.from_config(cfg, n_per_shard,
                                          sort_capacity_factor)
        self.pspec = ep.PoolSpec(n_blocks=pool_blocks,
                                 block_size=block_size,
                                 k_max=k_max, dmax=dmax)
        self.m_cap = m_cap or self.pspec.capacity_entries
        if sync_budget is None:
            # one write step creates at most 2 * batch rows globally
            sync_budget = min(n_per_shard, 2 * batch // n_shards + 64)
        self.sync_budget = sync_budget
        self._live_state = None        # allocated on first use
        self._fns: Dict[Any, Callable] = {}
        self._synced_rows = np.zeros((n_shards,), np.int32)
        self._seq = 0
        self._snap_cache = None        # (state-ref, per-shard snapshots)
        self._host_cache = None        # (state-ref, host id/row view)
        self._full_sync_cache = None   # (state-ref, synced-state) pair
        self._seen_defrags = 0
        self._pinned = None            # a captured state: copied, not updated
        self.state_copies = 0
        self._restore_gen = 0          # see LocalStore._restore_gen
        self.max_delta_frac = max_delta_frac
        self._retained: Dict[int, Epoch] = {}   # pinned epoch chain
        self.stats = dict(ops_applied=0, ops_dropped=0,
                          sync_runs=0, sync_skips=0, defrags=0,
                          defrag_ms=0.0, defrag_host_ms=0.0,
                          defrag_sync_ms=0.0, tiles_scanned=0,
                          flushes=0, super_batches=0,
                          host_stage_ms=0.0, device_sync_ms=0.0)

    @property
    def state(self):
        """The live shard-stacked state, allocated on first use."""
        if self._live_state is None:
            self._live_state = ge.make_sharded_state(
                self.sspec, self.pspec, self.n_shards, self.n_per_shard,
                self.device)
        return self._live_state

    @state.setter
    def state(self, value):
        self._live_state = value

    def _fn(self, key, build) -> Callable:
        f = self._fns.get(key)
        if f is None:
            f = self._fns[key] = build()
        return f

    def apply_program(self) -> Callable:
        """The routed apply of one (B, ...) batch."""
        return self._fn("apply", lambda: ge.make_apply_edges(
            self.sspec, self.pspec, self.n_shards, pack=self.pack,
            capacity_factor=self.capacity_factor,
            route_budget=self.route_budget))

    def analytics_program(self, name: str, **static) -> Callable:
        """The registered sharded program of ``name``: raises where the
        registry has none (``make_dist=None``), as the JAX store does."""
        spec = analytics_spec(name)
        if spec.make_dist is None:
            raise NotImplementedError(
                f"analytics op {name!r} has no mesh combine loop "
                f"registered (repro_torch.api.registry) — run it on a "
                f"LocalStore, or register a distributed form")
        key = ("alg", name, tuple(sorted(static.items())))
        return self._fn(key, lambda: spec.make_dist(
            self.sspec, self.pspec, self.n_shards, self.m_cap,
            self.frontier_budget, **static))

    # ---- mutation ----
    def _keys(self, ids) -> torch.Tensor:
        return pack_keys(np.asarray(ids, np.uint64), self.key_bits,
                         self.device)

    def _writable(self):
        """The live state, copied first when a capture holds it (or when
        the store never updates in place)."""
        if not self.donate_steady_state or self.state is self._pinned:
            self.state = clone_state(self.state)
            self.state_copies += 1
        return self.state

    def apply(self, batch: OpBatch) -> ApplyResult:
        if batch.kind not in self.supported_ops:
            raise UnsupportedOpError(
                batch.kind, self.backend,
                "sharded vertex-only mutation batches are not routed yet: "
                "vertices materialize from edge endpoints (plus the owner "
                "registration sync); use LocalStore for vertex CRUD")
        if len(batch) == 0:
            return ApplyResult(0, 0)
        src, dst, w = batch.src, batch.dst, batch.weight
        if self.undirected:
            src, dst, w = interleave_undirected(src, dst, w)
        B = self.batch
        N = len(src)
        NB = (N + B - 1) // B
        K = max(1, int(self.pipeline_depth))
        dev = self.device
        t0 = time.perf_counter()
        # stage the whole flush once; the ragged tail ships at its true
        # depth (padding whole batches would advance the clocks)
        ps = np.zeros((NB * B,), np.uint64)
        pd = np.zeros((NB * B,), np.uint64)
        pw = np.zeros((NB * B,), np.float32)
        mask = np.zeros((NB * B,), bool)
        ps[:N], pd[:N], pw[:N], mask[:N] = src, dst, w, True
        sk, dk = self._keys(ps), self._keys(pd)
        tw = torch.from_numpy(pw).to(dev)
        tm = torch.from_numpy(mask).to(dev)
        self._writable()
        fn = self.apply_program()
        drops = []
        for lo in range(0, NB * B, K * B):
            for a in range(lo, min(lo + K * B, NB * B), B):
                self.state, d = fn(self.state, sk[a:a + B], dk[a:a + B],
                                   tw[a:a + B], tm[a:a + B])
                drops.append(d)
            self.stats["super_batches"] += 1
        self.stats["host_stage_ms"] = round(
            self.stats["host_stage_ms"] +
            (time.perf_counter() - t0) * 1000.0, 3)
        # ONE host fetch per flush: drops, rebuilds, touched tiles and
        # each shard's row count (for the sync)
        t1 = time.perf_counter()
        pool = self.state.pool
        dropped, dsum, tiles, *rows = ep._fetch(
            torch.stack(drops).sum(), pool.defrags.sum(),
            pool.tiles_scanned.sum(), self.state.vt.num_rows)
        if dsum != self._seen_defrags:            # some shard rebuilt
            now = time.perf_counter()
            self.stats["defrag_ms"] = round(
                self.stats["defrag_ms"] + (now - t0) * 1000.0, 3)
            self.stats["defrag_host_ms"] = round(
                self.stats["defrag_host_ms"] + (t1 - t0) * 1000.0, 3)
            self.stats["defrag_sync_ms"] = round(
                self.stats["defrag_sync_ms"] + (now - t1) * 1000.0, 3)
            self._seen_defrags = dsum
        self.stats["device_sync_ms"] = round(
            self.stats["device_sync_ms"] +
            (time.perf_counter() - t1) * 1000.0, 3)
        self.stats["flushes"] += 1
        self._seq += 1
        self._snap_cache = self._host_cache = self._full_sync_cache = None
        # raw submitted ops (undirected doubling is an internal detail)
        self.stats["ops_applied"] += len(batch)
        self.stats["ops_dropped"] += dropped
        self.stats["defrags"] = self._seen_defrags
        self.stats["tiles_scanned"] = tiles
        if self.sync_incremental:
            self._maybe_sync_live(np.asarray(rows, np.int32))
        return ApplyResult(len(batch), dropped)

    def _maybe_sync_live(self, rows: np.ndarray):
        """Incremental vertex sync after a flush that left each shard with
        ``rows`` rows: only rows created since the last sync are
        registered at their owner shards; a flush that created no vertex
        skips it."""
        if np.array_equal(rows, self._synced_rows):
            self.stats["sync_skips"] += 1
            return
        fn = self._fn(("sync_inc",), lambda: ge.make_sync_vertices(
            self.sspec, self.pspec, self.n_shards, budget=self.sync_budget,
            incremental=True))
        # the host row counts bound the scan to the rows created since
        self.state = fn(self.state, self._synced_rows.tolist(),
                        rows.tolist())
        self._synced_rows = np.asarray(ep._fetch(self.state.vt.num_rows),
                                       np.int32)
        self.stats["sync_runs"] += 1

    # ---- epochs ----
    def capture(self) -> Epoch:
        self._pinned = self.state
        return Epoch(self.state, self._seq,
                     cache={"gen": self._restore_gen})

    def clock(self, at: Optional[Epoch] = None) -> int:
        state = at.state if at is not None else self.state
        return int(state.pool.clock[0]) - 1

    # ---- durability hooks (repro_torch.storage) ----
    def durable_state(self):
        """The live shard-stacked state plus the host counters a restored
        process resumes ingest with: capture seq, the defrag watermark,
        the incremental-sync watermark (one row count a shard) and the op
        accounting. The state is the live one: it stays valid until the
        next apply."""
        return self.state, dict(
            seq=self._seq, seen_defrags=self._seen_defrags,
            synced_rows=np.asarray(self._synced_rows).tolist(),
            ops_applied=self.stats["ops_applied"],
            ops_dropped=self.stats["ops_dropped"])

    def load_durable_state(self, state, meta: dict):
        """Install a shard-stacked state (of tensors, or of numpy arrays in
        the JAX package's dtypes, as a checkpoint holds) as the live image
        on the store's device, and resume the host counters from ``meta``.
        The store pins it, so the next apply copies it; epoch handles
        captured before this call are refused by ``analytics_advance``
        (``Reason.RESTORE_BOUNDARY``)."""
        self._live_state = state_from_numpy(state, self.device)
        self._pinned = self._live_state
        self._snap_cache = self._host_cache = self._full_sync_cache = None
        if "synced_rows" in meta:
            self._synced_rows = np.asarray(meta["synced_rows"], np.int32)
        else:
            self._synced_rows = np.asarray(
                ep._fetch(self.state.vt.num_rows), np.int32)
        self._seq = int(meta.get("seq", 0))
        self._seen_defrags = int(meta["seen_defrags"]) \
            if "seen_defrags" in meta \
            else ep._fetch(self.state.pool.defrags.sum())[0]
        self.stats["ops_applied"] = int(meta.get("ops_applied", 0))
        self.stats["ops_dropped"] = int(meta.get("ops_dropped", 0))
        self.stats["defrags"] = self._seen_defrags
        self._restore_gen += 1

    def _state(self, at: Optional[Epoch]):
        return at.state if at is not None else self.state

    def _synced(self, state):
        """A vertex-synced view of ``state`` (identity when the write path
        keeps the live state registered as it goes); a full sync runs on a
        copy, so ``state`` itself never changes."""
        if self.sync_incremental:
            return state
        if self._full_sync_cache is not None and \
                self._full_sync_cache[0] is state:
            return self._full_sync_cache[1]
        fn = self._fn(("sync",), lambda: ge.make_sync_vertices(
            self.sspec, self.pspec, self.n_shards))
        synced = fn(clone_state(state))
        self.state_copies += 1
        self.stats["sync_runs"] += 1
        self._full_sync_cache = (state, synced)
        return synced

    # ---- reads ----
    def _snapshots(self, state):
        if self._snap_cache is not None and self._snap_cache[0] is state:
            return self._snap_cache[1]
        fn = self._fn(("snapshot",), lambda: ge.make_snapshot(
            self.sspec, self.pspec, self.n_shards, self.m_cap))
        snaps = fn(state)
        self._snap_cache = (state, snaps)
        return snaps

    def _host_view(self, state):
        """Host-side ID/row tables of a state for lookup, neighbors and
        num_vertices: one device pull per state, then each shard's live
        rows sorted by vertex ID (a search per query)."""
        if self._host_cache is not None and self._host_cache[0] is state:
            return self._host_cache[1]
        vid = unpack_keys(state.vt.ids)
        live = (state.vt.del_time == 0).cpu().numpy()
        owner = ge.shard_of_keys(state.vt.ids, self.n_shards).cpu().numpy()
        row_vid, row_of = [], []
        for s in range(self.n_shards):
            rows = np.nonzero(live[s])[0]
            order = np.argsort(vid[s][rows], kind="stable")
            row_vid.append(vid[s][rows][order])
            row_of.append(rows[order])
        view = dict(vid=vid, live=live, owner=owner, row_vid=row_vid,
                    row_of=row_of, present=np.unique(vid[live]))
        self._host_cache = (state, view)
        return view

    def _degrees(self, state, ids) -> np.ndarray:
        fn = self._fn(("degree",), lambda: ge.make_khop_counts(
            self.sspec, self.pspec, self.n_shards))
        Q = self.query_batch
        keys = self._keys(ids)
        n = keys.shape[0]
        buf = torch.zeros((-(-n // Q) * Q, 2), dtype=keys.dtype,
                          device=self.device)
        buf[:n] = keys          # zero keys pad the tail; sliced off below
        out = [fn(state, buf[lo:lo + Q]) for lo in range(0, n, Q)]
        return torch.cat(out).cpu().numpy()[:n] if out \
            else np.zeros((0,), np.int32)

    @staticmethod
    def _search(sorted_ids: np.ndarray, ids: np.ndarray):
        """(hit, pos): whether each of ``ids`` is in ``sorted_ids``, and
        where."""
        if not len(sorted_ids):
            return np.zeros(ids.shape, bool), np.zeros(ids.shape, np.int64)
        pos = np.minimum(np.searchsorted(sorted_ids, ids),
                         len(sorted_ids) - 1)
        return sorted_ids[pos] == ids, pos

    def _neighbors(self, state, ids):
        """Edges live in the SOURCE's hash-owner shard: read that shard's
        CSR row of each ID, gathering only those rows off the device."""
        view = self._host_view(state)
        snaps = self._snapshots(state)
        ids = np.asarray(ids, np.uint64)
        shard = ge.shard_of_keys(pack_keys(ids, self.key_bits, "cpu"),
                                 self.n_shards).numpy()
        row = np.full(ids.shape, -1, np.int64)
        for s in range(self.n_shards):
            sel = np.nonzero(shard == s)[0]
            hit, pos = self._search(view["row_vid"][s], ids[sel])
            row[sel[hit]] = view["row_of"][s][pos[hit]]
        found = np.nonzero(row >= 0)[0]
        dev = snaps.indptr.device
        fs = torch.from_numpy(shard[found].astype(np.int64)).to(dev)
        fr = torch.from_numpy(row[found]).to(dev)
        lo = snaps.indptr[fs, fr].to(torch.int64)
        cnt = snaps.indptr[fs, fr + 1].to(torch.int64) - lo
        # entry e of the answer: shard fs[q], CSR slot lo[q] + its rank
        start = torch.cumsum(cnt, 0) - cnt
        sh = torch.repeat_interleave(fs, cnt)
        slot = torch.repeat_interleave(lo - start, cnt) + torch.arange(
            sh.shape[0], device=dev)
        dst = snaps.dst[sh, slot].cpu().numpy()
        wgt = snaps.weight[sh, slot].cpu().numpy()
        nid = view["vid"][sh.cpu().numpy(), dst]
        counts = np.zeros(ids.shape, np.int64)
        counts[found] = cnt.cpu().numpy()
        ends = np.cumsum(counts)
        return [(nid[e - c:e], wgt[e - c:e]) for c, e in zip(counts, ends)]

    def read(self, op: ReadOp, at: Optional[Epoch] = None):
        state = self._state(at)
        if op.kind == "degree":
            return self._degrees(state, op.ids)
        if op.kind == "lookup":
            present = self._host_view(self._synced(state))["present"]
            return self._search(present, np.asarray(op.ids, np.uint64))[0]
        if op.kind == "neighbors":
            return self._neighbors(state, op.ids)
        if op.kind == "num_vertices":
            view = self._host_view(self._synced(state))
            mine = view["live"] & (view["owner"] ==
                                   np.arange(self.n_shards)[:, None])
            return int(np.sum(mine))
        if op.kind == "num_edges":
            return int(self._snapshots(state).m.sum())
        if op.kind == "snapshot":
            return self._snapshots(state)
        raise ValueError(op.kind)

    # ---- analytics ----
    def analytics(self, op: AnalyticsOp, at: Optional[Epoch] = None):
        return self.analytics_result(op, at).value

    def _resolve_dyn(self, spec: AnalyticsSpec, params: dict):
        """Pop dyn params and resolve IDs -> keys on the store's device.
        Returns ``(dyn, query_ids)``."""
        dyn, query_ids = [], None
        for pname, kind in spec.dyn:
            v = params.pop(pname)
            if kind == "id":
                dyn.append(self._keys(np.asarray([v], np.uint64))[0])
            elif spec.result == "per_query":
                query_ids = np.asarray(v, np.uint64)
            else:
                # replicated source sets (BC): padded to the next power of
                # two with absent-key sentinels (hash to nothing, row -1,
                # contribute zero), as the JAX store pads them
                ids = np.asarray(v, np.uint64)
                S = max(len(ids), 1)
                buf = torch.full((1 << (S - 1).bit_length(), 2), _M32,
                                 dtype=torch.int64, device=self.device)
                buf[:len(ids)] = self._keys(ids)
                dyn.append(buf)
        return dyn, query_ids

    def analytics_result(self, op: AnalyticsOp, at: Optional[Epoch] = None,
                         _reason: str = "") -> AnalyticsResult:
        """From-scratch sharded run as an ``AnalyticsResult``; ``raw``
        keeps the per-shard ``(n_shards, n_cap)`` values (scalar results:
        the per-shard partials) a later ``analytics_advance`` seeds
        from."""
        spec = analytics_spec(op.name)
        if op.name == "wcc" and self.key_bits > 32:
            raise NotImplementedError(
                "distributed WCC labels are single uint32 words (min "
                "vertex ID): key_bits > 32 needs a two-word label loop")
        params = dict(op.params)
        dyn, query_ids = self._resolve_dyn(spec, params)
        fn = self.analytics_program(op.name, **params)
        state = self._synced(self._state(at))
        seq = at.seq if at is not None else self._seq
        if query_ids is not None:
            # queries ride the shard partition in fixed ``query_batch``
            # chunks; sentinel-padded tails answer 0 and are sliced off
            Q = self.query_batch
            q = len(query_ids)
            keys = self._keys(query_ids)
            out = np.zeros((q,), np.int32)
            for lo in range(0, q, Q):
                n_c = min(Q, q - lo)
                buf = torch.full((Q, 2), _M32, dtype=torch.int64,
                                 device=self.device)
                buf[:n_c] = keys[lo:lo + n_c]
                out[lo:lo + n_c] = fn(state, buf, *dyn).cpu().numpy()[:n_c]
            return AnalyticsResult(out, seq, "scratch", 0, _reason,
                                   None, at)
        vals = fn(state, *dyn)
        iters = 0
        if isinstance(vals, tuple):         # convergence entries: (v, it)
            vals, it = vals
            iters = int(it.max())
        raw = vals.cpu().numpy()
        if spec.result == "scalar":
            return AnalyticsResult(int(raw.sum()), seq, "scratch", iters,
                                   _reason, raw, at)
        value = ge.collect_owner_values(state, raw, self.n_shards)
        return AnalyticsResult(value, seq, "scratch", iters, _reason,
                               raw, at)

    def warm_program(self, name: str, **static) -> Callable:
        """The warm-advance sharded program (``make_dist_warm``): ``f(state,
        *dyn, prev_raw) -> (values, iters)``, cached in the slot
        ``analytics_advance`` uses. Raises for algorithms with no warm
        form (or whose knobs disable it: fixed-iteration PageRank)."""
        spec = analytics_spec(name)
        if spec.make_dist_warm is None:
            raise NotImplementedError(
                f"analytics op {name!r} has no warm sharded program "
                f"registered (repro_torch.api.registry)")
        f = self._warm_fn(spec, static)
        if f is None:
            raise NotImplementedError(
                f"analytics op {name!r} refuses a warm program for "
                f"{static!r} (path-dependent without a tolerance)")
        return f

    def _warm_fn(self, spec: AnalyticsSpec, static: dict):
        """The cached ``make_dist_warm`` program, or None where the
        registry refuses one for these knobs."""
        key = ("algw", spec.name, tuple(sorted(static.items())))
        if key not in self._fns:
            f = spec.make_dist_warm(self.sspec, self.pspec, self.n_shards,
                                    self.m_cap, self.frontier_budget,
                                    **static)
            if f is None:
                return None
            self._fns[key] = f
        return self._fns[key]

    def _csrs(self, at: Epoch):
        """Per-shard host CSR views of an epoch, cached on the handle."""
        h = at.cache.get("hcsr")
        if h is None:
            snaps = self._snapshots(at.state)
            h = at.cache["hcsr"] = [
                ed.host_csr(ge.shard_view(snaps, s))
                for s in range(self.n_shards)]
        return h

    def _delta(self, prev: Epoch, cur: Epoch):
        key = ("delta", prev.seq)
        hit = cur.cache.get(key)
        if hit is None:     # shared across every analytic chained E->E'
            hit = cur.cache[key] = ed.extract_delta_sharded(
                prev.state, cur.state, self._csrs(prev), self._csrs(cur))
        return hit

    def analytics_advance(self, op: AnalyticsOp, prev: AnalyticsResult,
                          at: Optional[Epoch]) -> AnalyticsResult:
        """Advance ``prev`` to epoch ``at``: the warm sharded program where
        the registry has one (``make_dist_warm``), per-shard host advances
        otherwise (degree / num_edges: shard-local, since edges live in
        their source's owner shard); any refusal falls back to scratch
        with the reason."""
        spec = analytics_spec(op.name)
        if at is None or prev is None:
            return self.analytics_result(op, at, _reason=Reason.NO_WARM)
        if _stale_gen(prev.handle, at, self._restore_gen):
            return self.analytics_result(op, at,
                                         _reason=Reason.RESTORE_BOUNDARY)
        if prev.epoch == at.seq:
            return prev
        if (spec.result == "per_query" or prev.handle is None
                or prev.raw is None or not self.sync_incremental
                or (spec.make_dist_warm is None and spec.advance is None)):
            return self.analytics_result(op, at, _reason=Reason.NO_WARM)
        deltas, reason = self._delta(prev.handle, at)
        if deltas is None:
            return self.analytics_result(op, at, _reason=reason)
        flags = ed.merged_flags(deltas)
        if flags["n_changed"] > self.max_delta_frac * \
                max(flags["m_cur"], 1):
            return self.analytics_result(op, at,
                                         _reason=Reason.DELTA_TOO_LARGE)
        if spec.warm_guard is not None:
            why = spec.warm_guard(flags)
            if why:
                return self.analytics_result(op, at, _reason=why)
        params = dict(op.params)
        dyn, _q = self._resolve_dyn(spec, params)
        if spec.make_dist_warm is not None:
            fn = self._warm_fn(spec, params)
            if fn is None:                  # e.g. fixed-iteration PageRank
                return self.analytics_result(
                    op, at, _reason=Reason.NO_WARM_PROGRAM)
            vals, it = fn(at.state, *dyn,
                          torch.from_numpy(prev.raw).to(self.device))
            iters = int(it.max())
            raw = vals.cpu().numpy()
        else:
            pcsrs, ccsrs = self._csrs(prev.handle), self._csrs(at)
            raws, iters = [], 0
            for s in range(self.n_shards):
                o = spec.advance(prev.raw[s], deltas[s], pcsrs[s],
                                 ccsrs[s], (), params)
                if o is None:
                    return self.analytics_result(
                        op, at, _reason=Reason.ADVANCE_REFUSED)
                r, its = o
                raws.append(r)
                iters = max(iters, int(its))
            raw = np.asarray(raws) if spec.result == "scalar" \
                else np.stack(raws)
        if spec.result == "scalar":
            return AnalyticsResult(int(np.asarray(raw).sum()), at.seq,
                                   "incremental", iters, "", raw, at)
        value = ge.collect_owner_values(at.state, raw, self.n_shards)
        return AnalyticsResult(value, at.seq, "incremental", iters, "",
                               raw, at)

    # ---- epoch retention (warm-chain pins) ----
    def pin_epoch(self, at: Epoch):
        self._retained[at.seq] = at

    def release_epoch(self, at: Epoch):
        self._retained.pop(at.seq, None)

    @property
    def retained_epochs(self) -> int:
        return len(self._retained)


# ---- backend registry ----

_BACKENDS: Dict[str, Callable[..., GraphStore]] = {}


def register_backend(name: str, factory: Callable[..., GraphStore]):
    """Register a GraphStore backend under ``name`` (see ``make_store``)."""
    _BACKENDS[name] = factory
    return factory


def available_backends():
    return sorted(_BACKENDS)


def make_store(backend: str, **kwargs) -> GraphStore:
    """Construct a registered backend: ``make_store('local', n_max=...,
    device='cuda')`` or ``make_store('sharded', n_shards=...,
    device='cuda')``."""
    if backend not in _BACKENDS:
        raise KeyError(f"unknown GraphStore backend {backend!r}; "
                       f"registered: {available_backends()}")
    return _BACKENDS[backend](**kwargs)


register_backend("local", LocalStore)
register_backend("sharded", ShardedStore)
