"""Incremental (epoch-delta) analytics: advance a cached result from epoch
E to E' using only the ``EpochDelta`` between them (port of
``repro.analytics.incremental``).

Every advance is EXACT against its from-scratch counterpart — BFS / WCC /
SSSP / degree by construction (fixed points of monotone relaxations are
schedule-independent), PageRank within the convergence tolerance (the
fixed point of the damped affine map is unique, so a warm start changes
the path, not the destination). Each returns ``None`` whenever the delta
violates its monotonicity precondition (deletes for BFS/WCC, deletes or
weight increases for SSSP, push-budget blowout for PageRank); the store
then falls back to scratch, so callers never observe an approximate
answer.

Host-side advances work on ``HostCsr`` views (numpy), not device
programs: the whole point is that O(delta)-local work beats a full-graph
dispatch; they are copied from the JAX package unchanged. The device-side
entry (``pagerank_converge``) backs the tolerance-gated scratch path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.epoch_delta import EpochDelta, HostCsr
from . import algorithms as alg

__all__ = ["pagerank_converge", "advance_degree", "advance_num_edges",
           "advance_wcc", "advance_bfs", "advance_sssp", "advance_pagerank",
           "BFS_INF"]

BFS_INF = np.int64(1) << 30


# --------------------------------------------------------------------------
# device-side: tolerance-converged PageRank (scratch-with-tol + warm seed)
# --------------------------------------------------------------------------

def pagerank_converge(snap, pr0, iters: int = 200, damping: float = 0.85,
                      tol: float = 1e-7, uniform0: bool = False):
    """PageRank to convergence: iterate until ``max|Δpr| < tol`` (or the
    ``iters`` cap). ``uniform0=True`` ignores ``pr0`` and starts uniform
    (the scratch entry); otherwise ``pr0`` seeds the loop (warm start).
    Returns ``(pr, iterations_run)`` — the fixed point is unique, so both
    starts land within ``tol * damping / (1 - damping)`` of it. One host
    fetch of ``max|Δpr|`` per iteration; the test is done in float32, as
    the JAX loop does it."""
    deg, edges, active, n_act = alg._pagerank_setup(snap)
    pr = torch.where(active, torch.ones_like(n_act) / n_act, 0.0) \
        if uniform0 else torch.where(active, pr0, 0.0)
    step = alg._pagerank_step(snap, edges, active, deg, n_act, damping)
    tol32 = float(np.float32(tol))
    it = 0
    while it < iters:
        nxt = step(pr)
        ch = float((nxt - pr).abs().max())
        alg.HOST_SYNCS["pagerank_converge"] += 1
        pr = nxt
        it += 1
        if not ch >= tol32:
            break
    return pr, it


# --------------------------------------------------------------------------
# host-side advances
# --------------------------------------------------------------------------

def _rows_edges(indptr: np.ndarray, rows: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR edge indices of ``rows`` plus the per-edge source row
    (vectorized ragged gather — no per-row Python loop)."""
    counts = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    tot = int(counts.sum())
    if tot == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    base = np.repeat(indptr[rows].astype(np.int64), counts)
    off = np.arange(tot, dtype=np.int64) - \
        np.repeat(np.cumsum(counts) - counts, counts)
    return base + off, np.repeat(rows.astype(np.int64), counts)


def advance_degree(prev_vals: np.ndarray, delta: EpochDelta,
                   csr_prev: HostCsr, csr_cur: HostCsr
                   ) -> Optional[Tuple[np.ndarray, int]]:
    """Patch live out-degrees at touched rows only."""
    vals = np.asarray(prev_vals, np.int32).copy()
    rows = delta.touched_rows
    vals[rows] = csr_cur.deg[rows]
    return vals, 0


def advance_num_edges(prev_val: int, delta: EpochDelta
                      ) -> Optional[Tuple[int, int]]:
    ins = int(delta.inserts.sum())
    dels = int(delta.deletes.sum())
    return int(prev_val) + ins - dels, 0


def advance_wcc(prev_vals: np.ndarray, delta: EpochDelta,
                csr_cur: HostCsr) -> Optional[Tuple[np.ndarray, int]]:
    """Hook-union over canonical (min-member-ID) component labels for an
    insert-only delta. Every previous label IS the min vertex ID of its
    members, so min-rooted union-find over labels yields exactly the new
    canonical labeling. Deletes can split components -> fallback."""
    if delta.has_deletes:
        return None
    labels = np.asarray(prev_vals, np.uint64).copy()
    vid = csr_cur.vid64()
    labels[delta.new_rows] = vid[delta.new_rows]

    parent: dict = {}

    def find(x: int) -> int:
        root = x
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(x, x) != root:
            parent[x], x = root, parent[x]
        return root

    unions = 0
    ins = delta.inserts
    for u, v in zip(delta.e_src[ins].tolist(), delta.e_dst[ins].tolist()):
        ra, rb = find(int(labels[u])), find(int(labels[v]))
        if ra != rb:
            if rb < ra:
                ra, rb = rb, ra
            parent[rb] = ra
            unions += 1

    out = labels.copy()
    live = np.nonzero(csr_cur.active)[0]
    lv = labels[live]
    uniq = np.unique(lv)
    roots = np.array([find(int(x)) for x in uniq.tolist()], np.uint64)
    out[live] = roots[np.searchsorted(uniq, lv)]
    return out, unions


def advance_bfs(prev_vals: np.ndarray, delta: EpochDelta, csr_cur: HostCsr,
                source_row: int, max_iters: int
                ) -> Optional[Tuple[np.ndarray, int]]:
    """Re-relax depths from the affected frontier. Insert-only-safe
    (weight changes don't touch connectivity): depths only decrease, and
    the relaxation's fixed point is the true distance — identical to the
    level-synchronous scratch run, truncation mask included."""
    if delta.has_deletes:
        return None
    n = csr_cur.n_cap
    prev = np.asarray(prev_vals, np.int64)
    d = np.where(prev >= 0, prev, BFS_INF)
    frontier = np.zeros(n, bool)
    ins = delta.inserts
    frontier[delta.e_src[ins]] = True
    if d[source_row] > 0:
        d[source_row] = 0
        frontier[source_row] = True
    rounds = 0
    indptr, dst = csr_cur.indptr, csr_cur.dst
    while frontier.any():
        if rounds > n + 2:
            return None                     # never expected: paranoia cap
        act = np.nonzero(frontier)[0]
        eidx, rep = _rows_edges(indptr, act)
        relax = np.full(n, BFS_INF, np.int64)
        if eidx.size:
            np.minimum.at(relax, dst[eidx], d[rep] + 1)
        improved = relax < d
        d = np.minimum(d, relax)
        frontier = improved
        rounds += 1
    vals = np.where(d <= max_iters, d, -1).astype(np.int32)
    return vals, rounds


def advance_sssp(prev_vals: np.ndarray, delta: EpochDelta, csr_cur: HostCsr,
                 source_row: int, max_iters: int
                 ) -> Optional[Tuple[np.ndarray, int]]:
    """Label-correcting re-relaxation in float32 (the same left-to-right
    path sums the device Bellman-Ford computes, so the fixed point is
    bit-identical). Monotone-safe only when distances can't grow:
    deletes or weight increases -> fallback. Assumes the previous scratch
    run converged within its iteration cap (holds at every benchmarked
    scale)."""
    if delta.has_deletes or delta.has_weight_increase:
        return None
    n = csr_cur.n_cap
    d = np.asarray(prev_vals, np.float32).copy()
    frontier = np.zeros(n, bool)
    changed = delta.inserts | delta.updates
    frontier[delta.e_src[changed]] = True
    if d[source_row] > 0:
        d[source_row] = np.float32(0.0)
        frontier[source_row] = True
    rounds = 0
    indptr, dst, w = csr_cur.indptr, csr_cur.dst, csr_cur.weight
    while frontier.any():
        if rounds > 16 * max_iters + 64:
            return None                     # float pathologies: fall back
        act = np.nonzero(frontier)[0]
        eidx, rep = _rows_edges(indptr, act)
        relax = np.full(n, np.float32(np.inf), np.float32)
        if eidx.size:
            cand = (d[rep].astype(np.float32) +
                    w[eidx].astype(np.float32)).astype(np.float32)
            np.minimum.at(relax, dst[eidx], cand)
        improved = relax < d
        d = np.minimum(d, relax).astype(np.float32)
        frontier = improved
        rounds += 1
    return d, rounds


def advance_pagerank(prev_vals: np.ndarray, csr_cur: HostCsr,
                     damping: float, tol: float,
                     max_rounds: int = 400,
                     edge_work_factor: int = 32
                     ) -> Optional[Tuple[np.ndarray, int]]:
    """Localized residual push (Gauss-Southwell, vectorized rounds).

    Invariant: ``pr* = x + (I - d·Pᵀ)⁻¹ · res`` — pushing a residual
    entry moves it into ``x`` and forwards ``d``·entry along out-edges
    (uniformly for dangling rows), so when ``‖res‖₁ ≤ (1-d)·tol/2`` the
    answer is provably within ``tol/2`` of the unique fixed point —
    tighter than the device loop's own stopping error. The initial
    residual is computed EXACTLY on the new graph, so any delta
    (including structural ones) is handled; locality is a performance
    property, not a correctness assumption. Returns ``None`` when the
    push budget (``edge_work_factor``·m edge traversals) or round cap is
    exhausted — the delta was too global to win."""
    indptr, dst, active = csr_cur.indptr, csr_cur.dst, csr_cur.active
    n = csr_cur.n_cap
    m = csr_cur.m
    deg = csr_cur.deg.astype(np.int64)
    act_rows = np.nonzero(active)[0]
    n_act = max(int(active.sum()), 1)
    d = float(damping)

    x = np.where(active, np.asarray(prev_vals, np.float64), 0.0)
    # exact residual r = F(x) - x over the current graph
    e_src_all = np.repeat(np.arange(n, dtype=np.int64), deg)
    contrib = np.where(deg > 0, x / np.maximum(deg, 1), 0.0)
    inflow = np.bincount(dst[:m].astype(np.int64),
                         weights=contrib[e_src_all], minlength=n)[:n]
    dangling = float(x[active & (deg == 0)].sum())
    fx = np.where(active, (1.0 - d) / n_act +
                  d * (inflow + dangling / n_act), 0.0)
    res = fx - x

    target = max(float(tol), 1e-9) * (1.0 - d) * 0.5
    theta = target / (2.0 * n_act)
    budget = edge_work_factor * (m + 1024)
    work = 0
    rounds = 0
    while float(np.abs(res[act_rows]).sum()) > target:
        push = active & (np.abs(res) > theta)
        if not push.any():
            break           # sub-threshold mass already satisfies target
        if rounds >= max_rounds:
            return None
        rows = np.nonzero(push)[0]
        rv = res[rows].copy()
        x[rows] += rv
        res[rows] = 0.0
        counts = deg[rows]
        work += int(counts.sum())
        if work > budget:
            return None
        eidx, _ = _rows_edges(indptr, rows)
        if eidx.size:
            per_edge = d * np.repeat(rv / np.maximum(counts, 1),
                                     counts)
            res += np.bincount(dst[eidx].astype(np.int64),
                               weights=per_edge, minlength=n)[:n]
        dmass = d * float(rv[counts == 0].sum())
        if dmass != 0.0:
            res[act_rows] += dmass / n_act
        rounds += 1
    return np.where(active, x, 0.0).astype(np.float32), rounds
