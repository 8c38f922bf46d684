"""The analytics registry: algorithm name -> how a backend runs it (port
of ``repro.api.registry``).

Each entry carries the single-CSR implementation (``analytics.
algorithms``) and its incremental phase. A backend never dispatches on
algorithm names: ``LocalStore`` runs ``spec.single`` on its snapshot — so
adding an algorithm is a registration, not a rewrite. The mesh programs
(``make_dist`` / ``make_dist_warm``) come with the port's sharded slice;
until then every entry has ``None`` there.

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

__all__ = ["AnalyticsSpec", "ANALYTICS", "register_analytics",
           "analytics_spec", "available_analytics"]


@dataclasses.dataclass(frozen=True)
class AnalyticsSpec:
    """How one named algorithm runs on every backend.

    ``single(snap, *dyn, **static)`` answers on a single CSR snapshot, on
    the snapshot's device. ``make_dist`` builds the mesh program (``None``
    = no distributed form yet).

    ``dyn`` lists (param_name, kind) resolved per backend before the call:
    ``'id'`` — one vertex ID -> row offset; ``'ids'`` — an ID array ->
    offsets. ``absent`` is the per-vertex fill when a required ``'id'``
    param names a vertex the graph has never seen.

    ``advance(prev_raw, delta, csr_prev, csr_cur, dyn, params)`` advances
    the previous epoch's RAW per-row values over one ``EpochDelta`` on
    host ``HostCsr`` views, returning ``(raw, iters)`` or ``None`` to
    force the scratch fallback. ``make_dist_warm`` is the mesh form.
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
    make_dist=None,
    advance=lambda prev, delta, cp, cc, dyn, params:
        inc.advance_bfs(prev, delta, cc, int(dyn[0]),
                        int(params.get("max_iters", 32))),
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


register_analytics(AnalyticsSpec(
    name="pagerank",
    single=_pagerank_single,
    make_dist=None,
    advance=_pagerank_advance))

register_analytics(AnalyticsSpec(
    name="wcc",
    single=lambda snap, max_iters=64: A.wcc(snap, max_iters=max_iters),
    make_dist=None,
    advance=lambda prev, delta, cp, cc, dyn, params:
        inc.advance_wcc(prev, delta, cc),
    warm_guard=_deletes_guard,
    canonical_single=_wcc_canonical))

register_analytics(AnalyticsSpec(
    name="sssp",
    single=lambda snap, source, max_iters=64:
        A.sssp(snap, source, max_iters=max_iters),
    make_dist=None,
    advance=lambda prev, delta, cp, cc, dyn, params:
        inc.advance_sssp(prev, delta, cc, int(dyn[0]),
                         int(params.get("max_iters", 64))),
    warm_guard=lambda f: (Reason.DELETES if f["has_deletes"] else
                          Reason.WEIGHT_INCREASE
                          if f["has_weight_increase"] else None),
    dyn=(("source", "id"),), absent=float(np.float32(A.INF))))

register_analytics(AnalyticsSpec(
    name="bc",
    single=lambda snap, sources, max_depth=32:
        A.bc(snap, sources, max_depth=max_depth),
    make_dist=None,
    dyn=(("sources", "ids"),)))

register_analytics(AnalyticsSpec(
    name="khop",
    single=lambda snap, sources, k=2: A.khop(snap, sources, k=k),
    make_dist=None,
    dyn=(("sources", "ids"),), result="per_query"))

register_analytics(AnalyticsSpec(
    name="triangle_count",
    single=lambda snap: A.triangle_count(snap),
    make_dist=None,     # intersection needs remote adjacency; future entry
    result="scalar"))

register_analytics(AnalyticsSpec(
    name="degree_map",
    single=lambda snap: snap.indptr[1:] - snap.indptr[:-1],
    make_dist=None,
    advance=lambda prev, delta, cp, cc, dyn, params:
        inc.advance_degree(prev, delta, cp, cc)))

register_analytics(AnalyticsSpec(
    name="num_edges",
    single=lambda snap: snap.m,
    make_dist=None,
    advance=lambda prev, delta, cp, cc, dyn, params:
        inc.advance_num_edges(prev, delta),
    result="scalar"))
