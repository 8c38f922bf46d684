"""The analytics registry: algorithm name -> how a backend runs it (port
of ``repro.api.registry``).

Each entry pairs the single-CSR implementation (``analytics.algorithms``,
also each shard's local phase) with the sharded combine factory of
``dist.graph_engine`` that stitches those phases over the shard axis, and
carries the incremental phases. A backend never dispatches on algorithm
names: ``LocalStore`` runs ``spec.single`` on its snapshot,
``ShardedStore`` builds (and caches) ``spec.make_dist`` — so adding an
algorithm, or a backend, is a registration, not a rewrite.

Result kinds:

* ``per_vertex`` — a value per live vertex; stores normalize to
  ``{vertex_id: value}`` so answers are backend-independent;
* ``per_query``  — an array aligned with the queried ID batch;
* ``scalar``     — one number for the whole graph.

``canonical_single`` post-processes the single-shard result into the
backend-independent form (e.g. WCC's row-offset labels become the
component's minimum vertex ID), so cross-backend parity is exact
equality, not heuristics.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import analytics as A
from ..analytics import incremental as inc
from ..core.keys import unpack_keys
from ..core.status import Reason
from ..dist import graph_engine as ge

__all__ = ["AnalyticsSpec", "ANALYTICS", "register_analytics",
           "analytics_spec", "available_analytics"]


@dataclasses.dataclass(frozen=True)
class AnalyticsSpec:
    """How one named algorithm runs on every backend.

    ``single(snap, *dyn, **static)`` answers on a single CSR snapshot, on
    the snapshot's device. ``make_dist(sspec, pspec, n_shards, m_cap,
    frontier_budget, **static)`` builds the sharded program (``None`` = no
    distributed form; the sharded backend raises with a pointer here).

    ``dyn`` lists (param_name, kind) resolved per backend before the call:
    ``'id'`` — one vertex ID -> row offset (single) / key (sharded);
    ``'ids'`` — an ID array -> offsets / keys. ``absent`` is the
    per-vertex fill when a required ``'id'`` param names a vertex the
    graph has never seen (the sharded programs yield it naturally).

    ``advance(prev_raw, delta, csr_prev, csr_cur, dyn, params)`` advances
    the previous epoch's RAW per-row values over one ``EpochDelta`` on
    host ``HostCsr`` views, returning ``(raw, iters)`` or ``None`` to
    force the scratch fallback. ``make_dist_warm(sspec, pspec, n_shards,
    m_cap, budget, **static)`` builds the sharded program seeded from the
    previous per-shard raw values (a trailing ``(n_shards, n_cap)``
    input), returning ``(vals, per_shard_iters)``.
    ``warm_guard(flags)`` (flags = ``epoch_delta.merged_flags``) returns
    a fallback reason when the delta breaks the warm program's
    monotonicity precondition.
    """

    name: str
    single: Callable
    make_dist: Optional[Callable]
    dyn: Tuple[Tuple[str, str], ...] = ()
    result: str = "per_vertex"
    absent: Optional[float] = None
    canonical_single: Optional[Callable] = None
    advance: Optional[Callable] = None
    make_dist_warm: Optional[Callable] = None
    warm_guard: Optional[Callable] = None


ANALYTICS: Dict[str, AnalyticsSpec] = {}


def register_analytics(spec: AnalyticsSpec) -> AnalyticsSpec:
    """Register (or override) an algorithm for every GraphStore backend."""
    ANALYTICS[spec.name] = spec
    return spec


def analytics_spec(name: str) -> AnalyticsSpec:
    if name not in ANALYTICS:
        raise KeyError(f"unknown analytics op {name!r}; registered: "
                       f"{sorted(ANALYTICS)} (register_analytics adds more)")
    return ANALYTICS[name]


def available_analytics(distributed: Optional[bool] = None):
    """Registered names; ``distributed=True`` filters to mesh-capable."""
    return sorted(n for n, s in ANALYTICS.items()
                  if distributed is None
                  or (s.make_dist is not None) == distributed)


def _wcc_canonical(vals: np.ndarray, snap) -> np.ndarray:
    """Row-offset component labels -> per-row minimum member vertex ID
    (uint64) — the canonical labeling the distributed loop propagates."""
    lab = np.asarray(vals)
    active = snap.active.cpu().numpy()
    vid = unpack_keys(snap.ids)
    out = np.zeros(lab.shape, np.uint64)
    live = active & (lab >= 0)
    labs = lab[live]
    if labs.size:
        order = np.argsort(labs, kind="stable")
        min_of = {}
        for l, v in zip(labs[order].tolist(), vid[live][order].tolist()):
            if l not in min_of or v < min_of[l]:
                min_of[l] = v
        out[live] = np.array([min_of[l] for l in labs.tolist()], np.uint64)
    return out


def _deletes_guard(flags):
    return Reason.DELETES if flags["has_deletes"] else None


register_analytics(AnalyticsSpec(
    name="bfs",
    single=lambda snap, source, max_iters=32:
        A.bfs(snap, source, max_iters=max_iters),
    make_dist=lambda sspec, pspec, n, m_cap, budget, max_iters=32:
        ge.make_bfs(sspec, pspec, n, m_cap, max_iters=max_iters,
                    frontier_budget=budget),
    advance=lambda prev, delta, cp, cc, dyn, params:
        inc.advance_bfs(prev, delta, cc, int(dyn[0]),
                        int(params.get("max_iters", 32))),
    make_dist_warm=lambda sspec, pspec, n, m_cap, budget, max_iters=32:
        ge.make_bfs_warm(sspec, pspec, n, m_cap, max_iters=max_iters,
                         frontier_budget=budget),
    warm_guard=_deletes_guard,
    dyn=(("source", "id"),), absent=-1))


def _pagerank_single(snap, iters=20, damping=0.85, tol=None):
    """``tol=None`` keeps the fixed-iteration reference; with a tolerance
    the loop runs to convergence (``iters`` becomes the cap, floored at
    100 so default calls actually converge) and returns ``(pr,
    iters_run)``."""
    if tol is None:
        return A.pagerank(snap, iters=iters, damping=damping)
    pr0 = torch.zeros((snap.active.shape[0],), dtype=torch.float32,
                      device=snap.active.device)
    return inc.pagerank_converge(snap, pr0, iters=max(int(iters), 100),
                                 damping=float(damping), tol=float(tol),
                                 uniform0=True)


def _pagerank_advance(prev, delta, cp, cc, dyn, params):
    tol = params.get("tol")
    if tol is None:
        return None     # fixed-iteration ranks are path-dependent: scratch
    return inc.advance_pagerank(prev, cc,
                                damping=float(params.get("damping", 0.85)),
                                tol=float(tol))


def _pagerank_dist(sspec, pspec, n, m_cap, budget, iters=20, damping=0.85,
                   tol=None, warm=False):
    """The sharded PageRank: ``iters`` iterations, or with ``tol`` to
    convergence under a cap of ``max(iters, 100)`` (as ``single``); the
    warm form exists only with a tolerance (fixed-iteration ranks are
    path-dependent), else ``None``."""
    if warm and tol is None:
        return None
    return ge.make_pagerank(
        sspec, pspec, n, m_cap,
        iters=iters if tol is None else max(int(iters), 100),
        damping=damping, frontier_budget=budget,
        tol=None if tol is None else float(tol), warm=warm)


register_analytics(AnalyticsSpec(
    name="pagerank",
    single=_pagerank_single,
    make_dist=_pagerank_dist,
    advance=_pagerank_advance,
    make_dist_warm=lambda *a, **kw: _pagerank_dist(*a, warm=True, **kw)))

register_analytics(AnalyticsSpec(
    name="wcc",
    single=lambda snap, max_iters=64: A.wcc(snap, max_iters=max_iters),
    make_dist=lambda sspec, pspec, n, m_cap, budget, max_iters=64:
        ge.make_wcc(sspec, pspec, n, m_cap, max_iters=max_iters,
                    frontier_budget=budget),
    advance=lambda prev, delta, cp, cc, dyn, params:
        inc.advance_wcc(prev, delta, cc),
    make_dist_warm=lambda sspec, pspec, n, m_cap, budget, max_iters=64:
        ge.make_wcc(sspec, pspec, n, m_cap, max_iters=max_iters,
                    frontier_budget=budget, warm=True),
    warm_guard=_deletes_guard,
    canonical_single=_wcc_canonical))

register_analytics(AnalyticsSpec(
    name="sssp",
    single=lambda snap, source, max_iters=64:
        A.sssp(snap, source, max_iters=max_iters),
    make_dist=lambda sspec, pspec, n, m_cap, budget, max_iters=64:
        ge.make_sssp(sspec, pspec, n, m_cap, max_iters=max_iters,
                     frontier_budget=budget),
    advance=lambda prev, delta, cp, cc, dyn, params:
        inc.advance_sssp(prev, delta, cc, int(dyn[0]),
                         int(params.get("max_iters", 64))),
    make_dist_warm=lambda sspec, pspec, n, m_cap, budget, max_iters=64:
        ge.make_sssp(sspec, pspec, n, m_cap, max_iters=max_iters,
                     frontier_budget=budget, warm=True),
    warm_guard=lambda f: (Reason.DELETES if f["has_deletes"] else
                          Reason.WEIGHT_INCREASE
                          if f["has_weight_increase"] else None),
    dyn=(("source", "id"),), absent=float(np.float32(A.INF))))

register_analytics(AnalyticsSpec(
    name="bc",
    single=lambda snap, sources, max_depth=32:
        A.bc(snap, sources, max_depth=max_depth),
    make_dist=lambda sspec, pspec, n, m_cap, budget, max_depth=32:
        ge.make_bc(sspec, pspec, n, m_cap, max_depth=max_depth,
                   frontier_budget=budget),
    dyn=(("sources", "ids"),)))

register_analytics(AnalyticsSpec(
    name="khop",
    single=lambda snap, sources, k=2: A.khop(snap, sources, k=k),
    make_dist=lambda sspec, pspec, n, m_cap, budget, k=2:
        ge.make_khop_counts(sspec, pspec, n, k=k, m_cap=m_cap,
                            frontier_budget=budget),
    dyn=(("sources", "ids"),), result="per_query"))

register_analytics(AnalyticsSpec(
    name="triangle_count",
    single=lambda snap: A.triangle_count(snap),
    make_dist=None,     # intersection needs remote adjacency; future entry
    result="scalar"))

register_analytics(AnalyticsSpec(
    name="degree_map",
    single=lambda snap: snap.indptr[1:] - snap.indptr[:-1],
    make_dist=lambda sspec, pspec, n, m_cap, budget:
        ge.make_degree_map(sspec, pspec, n, m_cap),
    advance=lambda prev, delta, cp, cc, dyn, params:
        inc.advance_degree(prev, delta, cp, cc)))

register_analytics(AnalyticsSpec(
    name="num_edges",
    single=lambda snap: snap.m,
    make_dist=lambda sspec, pspec, n, m_cap, budget:
        ge.make_num_edges(sspec, pspec, n, m_cap),
    advance=lambda prev, delta, cp, cc, dyn, params:
        inc.advance_num_edges(prev, delta),
    result="scalar"))
