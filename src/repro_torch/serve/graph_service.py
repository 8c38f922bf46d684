"""Concurrent graph query/update service over a ``repro_torch.api.
GraphStore`` (port of ``repro.serve.graph_service``).

The serving analogue of the paper's Fig. 11 mixed workload, mirroring the
continuous-batching shape of ``serve.engine`` — but storage-agnostic: the
service takes ANY GraphStore (the single-shard ``LocalStore`` of the port,
or a future backend) and only schedules. Requests enter
admission queues, the writer ingests fixed-size micro-batches through
``store.apply`` (the store pads to its static batch, so the jit cache
stays warm), and every read is pinned to the latest SEALED epoch — an O(1)
``store.capture()`` handle onto the immutable functional state. A heavy
analytics query can never observe a half-applied batch, and the writer
never waits for readers (RapidStore-style decoupling).

Scheduling per ``step()``:

1. **write phase** — up to ``write_batch`` queued edge ops ship as one
   ``OpBatch``; the sharded store's write path keeps the live state
   vertex-synced incrementally, so sealed epochs are analytics-ready;
2. **read phase** — up to ``query_batch`` queued queries are answered
   against the sealed epoch: degree queries ride ``ReadOp`` batches, any
   REGISTERED analytics (BFS / PageRank / WCC / SSSP / BC / k-hop) runs
   through ``store.analytics`` and is memoized per epoch;
3. **seal phase** — every ``seal_every`` steps the live state is published
   as the new read epoch (``store.capture()``).

Sealed epochs CHAIN: instead of discarding the analytics memo at each
seal, warm results (``AnalyticsResult`` with backend-private per-row
values) are advanced over the epoch delta by the store's incremental
engine (``analytics_advance``), falling back to scratch — with the reason
recorded — whenever the window refuses. Warm states live in an LRU
bounded by ``max_warm_states``; each pins its epoch via the store's
refcounted ``pin_epoch``/``release_epoch`` so MVCC retention plateaus
instead of growing with the write stream.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from ..api import AnalyticsOp, GraphStore, OpBatch, ReadOp
from ..api.registry import analytics_spec

__all__ = ["GraphQueryService", "Query", "drive_mixed_workload"]


def drive_mixed_workload(svc: "GraphQueryService", src, dst, w, query_ids):
    """The Fig. 11 measurement protocol, shared by benchmarks and dryruns:
    prime the jit caches with one tiny step, enqueue the stream, then drain
    it with a 1:1 interleave of write micro-batches and degree reads.
    Returns (elapsed_seconds, reads_answered)."""
    svc.submit_update(src[:1], dst[:1], w[:1])
    svc.submit_query("degree", ids=query_ids)
    svc.step()
    svc.submit_update(src, dst, w)
    reads = 0
    t0 = time.perf_counter()
    while svc.pending_writes:
        svc.submit_query("degree", ids=query_ids)
        svc.step()
        reads += len(query_ids)
    return time.perf_counter() - t0, reads


@dataclasses.dataclass
class Query:
    ticket: int
    kind: str                    # 'degree' | any registered analytics name
    ids: Optional[np.ndarray] = None     # degree: queried vertex IDs
    params: Optional[dict] = None        # analytics parameters


class GraphQueryService:
    """Micro-batching reader/writer front-end over a GraphStore."""

    def __init__(self, store: GraphStore, *, write_batch: Optional[int] = None,
                 query_batch: Optional[int] = None, seal_every: int = 1,
                 max_pending: int = 65536, bfs_iters: int = 32,
                 pr_iters: int = 20, damping: float = 0.85,
                 pipeline_depth: int = 1, incremental: bool = True,
                 max_warm_states: int = 8, durable_ack: bool = True):
        self.store = store
        # durable mode: when the store is WAL-backed (repro.storage.
        # DurableStore), every write phase ends on a group-commit sync, so
        # a write is on disk before any read of the same step can observe
        # it — the service never acks state a crash could lose
        self.durable_ack = durable_ack and \
            getattr(store, "wal", None) is not None
        self.n_shards = store.n_shards
        self.write_batch = write_batch or getattr(
            store, "batch", None) or store.graph.batch
        self.query_batch = query_batch or getattr(store, "query_batch", 256)
        # micro-batches drained per write phase: one store.apply flush ships
        # up to pipeline_depth device batches back-to-back (donated
        # steady-state dispatches, a single host sync per flush) — depth 1
        # preserves the classic one-batch-per-step scheduling
        self.pipeline_depth = max(1, pipeline_depth)
        self.seal_every = seal_every
        self.max_pending = max_pending
        self.bfs_iters = bfs_iters
        self.pr_iters = pr_iters
        self.damping = damping
        # epoch-chained analytics: warm results advance across seals
        # instead of recomputing; bounded LRU + refcounted epoch pins
        self.incremental = incremental
        self.max_warm_states = max_warm_states
        self._warm = collections.OrderedDict()  # cache_key -> AnalyticsResult
        self._pins: Dict[int, list] = {}        # epoch seq -> [handle, refs]

        # sealed read epoch (immutable capture, O(1) to publish)
        self.epoch = 0
        self._sealed = store.capture()
        self._retain(self._sealed)
        self._analytics_cache: Dict = {}    # op.cache_key() -> result
        self._epoch_sync_counted = False

        self._writes = collections.deque()  # (src, dst, w) id chunks
        self._vertex_ops = collections.deque()  # (kind, ids) CRUD batches
        self.pending_writes = 0
        self._reads = collections.deque()
        self._next_ticket = 0
        self.results: Dict[int, object] = {}
        self._stats = dict(steps=0, queries_answered=0, epochs_sealed=0,
                           sync_reused=0, write_flushes=0,
                           inflight_write_batches=0, analytics_scratch=0,
                           analytics_incremental=0, warm_evictions=0,
                           vertex_ops=0, writes_rejected=0,
                           durable_syncs=0)

    @property
    def stats(self) -> dict:
        """Service counters merged with the store's — op accounting
        (ops_applied/ops_dropped, sync_runs/skips) lives on the store and
        is never shadowed here (keys are disjoint by construction).
        Admission observability for the serving tier: ``queued_write_ops``
        (ops admitted but not yet shipped) vs ``inflight_write_batches``
        (device batches the LAST flush dispatched), plus the store's own
        ``flushes``/``super_batches`` pipeline counters."""
        return {**getattr(self.store, "stats", {}), **self._stats,
                "queued_write_ops": self.pending_writes,
                "warm_states": len(self._warm),
                "retained_epochs": getattr(self.store, "retained_epochs",
                                           0)}

    # ---- admission ----
    def submit_update(self, src, dst, weight=None) -> bool:
        """Enqueue edge ops (weight 0 = delete). False = backpressure."""
        src = np.asarray(src, np.uint64)
        dst = np.asarray(dst, np.uint64)
        w = np.ones(len(src), np.float32) if weight is None \
            else np.asarray(weight, np.float32)
        if self.pending_writes + len(src) > self.max_pending:
            return False
        self._writes.append((src, dst, w))
        self.pending_writes += len(src)
        return True

    def _submit_vertex_op(self, kind: str, ids) -> bool:
        """Admission for vertex CRUD: backends that cannot route the op
        REJECT it here (``writes_rejected``) instead of crashing the
        write loop mid-step — the ShardedStore raises a typed
        ``UnsupportedOpError`` for vertex-only batches, and admission is
        where that surfaces."""
        supported = getattr(self.store, "supported_ops", None)
        if supported is not None and kind not in supported:
            self._stats["writes_rejected"] += 1
            return False
        self._vertex_ops.append((kind, np.asarray(ids, np.uint64)))
        return True

    def submit_add_vertices(self, ids) -> bool:
        """Enqueue a vertex-create batch. False = rejected (unsupported
        backend). Vertex batches flush at the START of the next write
        phase, before that phase's edge coalescing."""
        return self._submit_vertex_op("add_vertices", ids)

    def submit_delete_vertices(self, ids) -> bool:
        """Enqueue a vertex-delete batch (see ``submit_add_vertices``)."""
        return self._submit_vertex_op("delete_vertices", ids)

    def _build_op(self, q: Query) -> AnalyticsOp:
        params = dict(q.params or {})
        if q.kind == "bfs":
            params.setdefault("max_iters", self.bfs_iters)
        elif q.kind == "pagerank":
            params.setdefault("iters", self.pr_iters)
            params.setdefault("damping", self.damping)
        return AnalyticsOp(q.kind, params)

    def submit_query(self, kind: str, ids=None, **params) -> Optional[int]:
        """Enqueue a read: ``'degree'`` (needs ``ids``) or any analytics
        name in the registry (``source=``/``sources=``/knobs as kwargs).
        Returns a ticket (see ``results``) or None on backpressure."""
        # reject malformed queries at admission, not mid-step
        if kind == "degree":
            assert ids is not None, "degree query needs ids"
        else:
            spec = analytics_spec(kind)       # raises on unknown kinds
            for pname, _ in spec.dyn:
                assert pname in params, f"{kind} query needs {pname}="
        if len(self._reads) >= self.max_pending:
            return None
        t = self._next_ticket
        self._next_ticket += 1
        self._reads.append(Query(
            ticket=t, kind=kind,
            ids=None if ids is None else np.asarray(ids, np.uint64),
            params=params or None))
        return t

    # ---- epochs ----
    def _retain(self, ep):
        """Refcounted epoch pin: the first reference registers the epoch
        in the store's MVCC retention (``pin_epoch``); equal-seq captures
        (seals with no writes between) share one pin."""
        if ep is None:
            return
        slot = self._pins.get(ep.seq)
        if slot is None:
            self._pins[ep.seq] = [ep, 1]
            pin = getattr(self.store, "pin_epoch", None)
            if pin is not None:
                pin(ep)
        else:
            slot[1] += 1

    def _release(self, ep):
        if ep is None:
            return
        slot = self._pins.get(ep.seq)
        if slot is None:
            return
        slot[1] -= 1
        if slot[1] == 0:
            del self._pins[ep.seq]
            rel = getattr(self.store, "release_epoch", None)
            if rel is not None:
                rel(slot[0])

    def seal_epoch(self) -> int:
        """Publish the live state as the read epoch. O(1): functional
        states are immutable, so sealing is a capture, not a copy. The
        per-epoch value memo resets; WARM analytics states survive the
        seal and advance over the delta on their next query."""
        prev = self._sealed
        self._sealed = self.store.capture()
        self._retain(self._sealed)
        self._release(prev)
        self._analytics_cache = {}
        self._epoch_sync_counted = False
        self.epoch += 1
        self._stats["epochs_sealed"] += 1
        return self.epoch

    @property
    def epoch_lag(self) -> int:
        """Operations ingested since the read epoch was sealed (staleness
        bound a reader observes)."""
        return self.store.clock() - self.store.clock(at=self._sealed)

    # ---- scheduling ----
    def _write_phase(self):
        wrote = False
        while self._vertex_ops:
            kind, ids = self._vertex_ops.popleft()
            try:
                self.store.apply(OpBatch(kind=kind, ids=ids))
                self._stats["vertex_ops"] += 1
                wrote = True
            except NotImplementedError:      # raced past admission
                self._stats["writes_rejected"] += 1
        if not self._writes:
            if wrote:
                self._durable_sync()
            return
        B = self.write_batch * self.pipeline_depth
        parts, need = [], B
        while self._writes and need > 0:
            s, d, w = self._writes[0]
            if len(w) <= need:
                parts.append(self._writes.popleft())
                need -= len(w)
            else:
                parts.append((s[:need], d[:need], w[:need]))
                self._writes[0] = (s[need:], d[need:], w[need:])
                need = 0
        take = B - need
        self.pending_writes -= take
        self.store.apply(OpBatch.edges(
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts])))
        self._stats["write_flushes"] += 1
        self._stats["inflight_write_batches"] = \
            (take + self.write_batch - 1) // self.write_batch
        self._durable_sync()

    def _durable_sync(self):
        """End-of-write-phase group-commit boundary in durable mode: the
        WAL records of this phase's applies are fsynced before any read
        (or caller ack) can observe their effects."""
        if self.durable_ack:
            self.store.sync()
            self._stats["durable_syncs"] += 1

    def _remember(self, key, res):
        """Install ``res`` as the warm chain entry for ``key`` (LRU,
        epoch-pinned); evictions release their pins so retention
        plateaus at ``max_warm_states`` + the sealed epoch."""
        old = self._warm.pop(key, None)
        if old is not None:
            self._release(old.handle)
        if res.raw is None or res.handle is None:
            return                      # nothing advanceable to keep
        self._warm[key] = res
        self._retain(res.handle)
        while len(self._warm) > self.max_warm_states:
            _, ev = self._warm.popitem(last=False)
            self._release(ev.handle)
            self._stats["warm_evictions"] += 1

    def _answer_analytics(self, q: Query):
        op = self._build_op(q)
        key = op.cache_key()
        if key in self._analytics_cache:
            return self._analytics_cache[key]
        if not self._epoch_sync_counted:
            # the sharded write path keeps the live state registered
            # incrementally, so the sealed capture is reused as the
            # analytics-ready state — no per-epoch sync recompute
            if getattr(self.store, "sync_incremental", False):
                self._stats["sync_reused"] += 1
            self._epoch_sync_counted = True
        if self.incremental and hasattr(self.store, "analytics_advance"):
            res = self.store.analytics_advance(op, self._warm.get(key),
                                               self._sealed)
        elif hasattr(self.store, "analytics_result"):
            res = self.store.analytics_result(op, at=self._sealed)
        else:           # minimal backend: plain value, no warm chain
            val = self.store.analytics(op, at=self._sealed)
            self._analytics_cache[key] = val
            return val
        mode = "analytics_incremental" if res.mode == "incremental" \
            else "analytics_scratch"
        self._stats[mode] += 1
        if self.incremental:
            self._remember(key, res)
        self._analytics_cache[key] = res.value
        return res.value

    def _read_phase(self):
        served = 0
        while self._reads:
            q = self._reads[0]
            # a cold analytics run fills the read budget; a memo hit on the
            # sealed epoch is nearly free and never deferred to a new epoch
            warm = q.kind != "degree" and \
                self._build_op(q).cache_key() in self._analytics_cache
            if served >= self.query_batch and not warm:
                break
            self._reads.popleft()
            if q.kind == "degree":
                self.results[q.ticket] = self.store.read(
                    ReadOp("degree", ids=q.ids), at=self._sealed)
                served += max(1, len(q.ids))
            else:
                self.results[q.ticket] = self._answer_analytics(q)
                served += 1 if warm else self.query_batch
            self._stats["queries_answered"] += 1

    def step(self):
        """One mixed read/write scheduling round (Fig. 11 concurrency):
        ingest a write micro-batch, answer reads against the sealed epoch,
        then seal if due."""
        self._write_phase()
        self._read_phase()
        self._stats["steps"] += 1
        if self.seal_every and self._stats["steps"] % self.seal_every == 0:
            self.seal_epoch()

    def claim(self, ticket: int):
        """Pop a finished query's answer — bounds result retention for a
        long-running service. KeyError if the ticket is unanswered."""
        return self.results.pop(ticket)

    def run(self, max_steps: int = 10_000):
        """Drive scheduling rounds until both queues drain (raises if
        ``max_steps`` is exhausted first — results are never silently
        partial), then seal so queries admitted next observe every write."""
        while (self._writes or self._vertex_ops or self._reads) \
                and max_steps > 0:
            self.step()
            max_steps -= 1
        if self._writes or self._vertex_ops or self._reads:
            raise RuntimeError(
                f"run(): queues not drained ({self.pending_writes} write "
                f"ops, {len(self._reads)} reads still pending)")
        self.seal_epoch()
        return self.results
