"""``GraphStore`` front door of the port: ``LocalStore`` over the eager
single-shard ``RadixGraph`` (port of the ``LocalStore`` half of
``repro.api.store``).

Epochs: ``capture()`` returns an O(1) handle to the current state and pins
it, so the next apply copies instead of updating it in place; every read
accepts ``at=handle`` to answer against that version.

Analytics, incremental analytics and durability are later slices of the
port: those methods raise ``UnsupportedOpError`` naming the slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Protocol, runtime_checkable

import numpy as np

from ..core import radixgraph as rg
from ..core import vertex_table as vt_mod
from ..core.radixgraph import RadixGraph
from .ir import ApplyResult, OpBatch, ReadOp, UnsupportedOpError

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
    def capture(self) -> Epoch: ...
    def clock(self, at: Optional[Epoch] = None) -> int: ...


def _later_slice(what: str, slice_name: str):
    raise UnsupportedOpError(what, "local",
                             f"arrives with the port's {slice_name} slice")


class LocalStore:
    """Single-shard backend: the eager ``RadixGraph`` behind the IR.

    Constructor kwargs are ``RadixGraph``'s (``device`` included, default
    ``'cuda'``) plus ``m_cap``, the CSR pad of snapshots. The graph stays
    reachable as ``.graph``."""

    backend = "local"
    supported_ops = frozenset(("edges", "add_vertices", "delete_vertices"))

    def __init__(self, m_cap: Optional[int] = None, **graph_kwargs):
        self.graph = RadixGraph(**graph_kwargs)
        self.n_shards = 1
        self.m_cap = m_cap or self.graph.pool_spec.capacity_entries
        self._seq = 0
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
        return Epoch(self.graph.state, self._seq)

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

    # ---- epoch retention (MVCC pins) ----
    def pin_epoch(self, at: Epoch):
        self.graph.retain_version(at.state, -(1 + at.seq))

    def release_epoch(self, at: Epoch):
        self.graph.release_version(-(1 + at.seq))

    @property
    def retained_epochs(self) -> int:
        return sum(1 for lab, _, _ in self.graph._versions if lab < 0)

    # ---- later slices of the port ----
    def analytics(self, op, at: Optional[Epoch] = None):
        _later_slice("analytics", "analytics")

    def analytics_result(self, op, at: Optional[Epoch] = None):
        _later_slice("analytics", "analytics")

    def analytics_advance(self, op, prev, at: Optional[Epoch]):
        _later_slice("analytics_advance", "analytics")

    def durable_state(self):
        _later_slice("durable_state", "durability")

    def load_durable_state(self, state, meta: dict):
        _later_slice("load_durable_state", "durability")

    def checkpoint(self, directory, **kw):
        _later_slice("checkpoint", "durability")

    def restore(self, directory, ckpt_id: Optional[int] = None):
        _later_slice("restore", "durability")


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
