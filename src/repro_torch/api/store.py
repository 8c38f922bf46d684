"""``GraphStore`` front door of the port: ``LocalStore`` over the eager
single-shard ``RadixGraph`` (port of the ``LocalStore`` half of
``repro.api.store``).

Epochs: ``capture()`` returns an O(1) handle to the current state and pins
it, so the next apply copies instead of updating it in place; every read
and analytics call accepts ``at=handle`` to answer against that version.
Analytics run on the store's device; ``analytics_advance`` moves a cached
result across epochs over the epoch delta on the host.

Durability hooks (``durable_state``, ``load_durable_state``, ``checkpoint``,
``restore``) serve ``repro_torch.storage``, whose checkpoints share their
on-disk format with the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..convert import state_from_numpy
from ..core import epoch_delta as ed
from ..core import radixgraph as rg
from ..core import vertex_table as vt_mod
from ..core.keys import unpack_keys
from ..core.radixgraph import RadixGraph
from ..core.status import Reason
from .ir import AnalyticsOp, AnalyticsResult, ApplyResult, OpBatch, ReadOp
from .registry import AnalyticsSpec, analytics_spec

__all__ = ["GraphStore", "Epoch", "LocalStore", "make_store",
           "register_backend", "available_backends"]


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


class LocalStore:
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
    device='cuda')``."""
    if backend not in _BACKENDS:
        raise KeyError(f"unknown GraphStore backend {backend!r}; "
                       f"registered: {available_backends()}")
    return _BACKENDS[backend](**kwargs)


register_backend("local", LocalStore)
