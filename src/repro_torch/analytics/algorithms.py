"""GAPBS-style analytics over a RadixGraph snapshot (paper §4.4), port of
``repro.analytics.algorithms``.

All algorithms run on the CSR ``GraphSnapshot`` whose ``dst`` column holds
vertex *offsets* — the paper's edge chain: after the initial source
lookup, no vertex-index access ever happens (Fig. 6). They run eagerly on
the snapshot's device: JAX's ``lax.while_loop`` level loops become Python
loops that fetch one scalar per level or iteration (counted in
``HOST_SYNCS``), ``jax.vmap`` over sources becomes a leading source
dimension (``bc``) or a loop over sources (``khop``).

``bfs`` and ``khop`` expand each level through the frontier kernel
(``kernels.ops.frontier_expand``) on bitmaps, viewing the CSR as
``m_cap`` blocks of one entry: ``owner = edge_sources``, ``dst =
snap.dst[:, None]``, ``valid = ok[:, None]``. The JAX package runs the
same function as a jnp scatter; the results are identical.

Scatter reductions keep JAX's sentinel row: targets of invalid edges are
redirected to row ``n`` of an ``n + 1`` long buffer that is sliced off,
never to an out-of-range index. Float scatter-adds (``pagerank_scatter``,
``bc``) use atomics on the card and are not order-stable.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.tensor_ops import I32, I64, cdiv
from ..kernels import ops
from ..kernels.frontier import pack_bits, unpack_bits

__all__ = ["INF", "bfs", "sssp", "pagerank", "wcc", "triangle_count", "bc",
           "khop", "edge_sources", "csr_edges", "bfs_expand",
           "pagerank_contrib", "pagerank_scatter", "HOST_SYNCS"]

INF = 3.4e38    # float32(3.4e38), as JAX's INF

# device->host scalar fetches per algorithm (one per level / iteration of
# the loops JAX runs as lax.while_loop)
HOST_SYNCS: Dict[str, int] = {"bfs": 0, "sssp": 0, "wcc": 0,
                              "triangle_count": 0, "pagerank_converge": 0}


def edge_sources(indptr: torch.Tensor, m_cap: int) -> torch.Tensor:
    """src offset of every CSR edge slot (searchsorted over indptr)."""
    e = torch.arange(m_cap, dtype=indptr.dtype, device=indptr.device)
    return (torch.searchsorted(indptr, e, right=True, out_int32=True)
            - 1).to(I32)


def _edge_valid(snap) -> torch.Tensor:
    m_cap = snap.dst.shape[0]
    e = torch.arange(m_cap, dtype=I32, device=snap.dst.device)
    return e < snap.m


def _n(snap) -> int:
    return snap.indptr.shape[0] - 1


# --------------------------------------------------------------------------
# shard-local phases
# --------------------------------------------------------------------------

def csr_edges(snap):
    """Loop-invariant local edge view (src row, validity, routed dst) —
    build it ONCE outside a level/iteration loop."""
    n = _n(snap)
    src = edge_sources(snap.indptr, snap.dst.shape[0])
    ok = _edge_valid(snap)
    dst = torch.where(ok, snap.dst, n)   # out-of-range -> dropped
    return src, ok, dst


def _frontier_view(snap, edges):
    """The CSR as ``m_cap`` blocks of one entry, for the frontier kernel."""
    src, ok, _ = edges
    return (src.contiguous(), snap.dst.view(-1, 1).contiguous(),
            ok.view(-1, 1).contiguous())


def bfs_expand(snap, frontier: torch.Tensor, edges=None,
               impl: str = "auto") -> torch.Tensor:
    """One level expansion over the local CSR: bool[n] frontier -> bool[n]
    rows hit by an out-edge of a frontier row."""
    n = _n(snap)
    edges = edges if edges is not None else csr_edges(snap)
    W = cdiv(n, 32)
    none = torch.zeros((W,), dtype=I32, device=frontier.device)
    nxt = ops.frontier_expand(*_frontier_view(snap, edges),
                              pack_bits(frontier, W), none, impl=impl)
    return unpack_bits(nxt, n)


def pagerank_contrib(snap, pr: torch.Tensor) -> torch.Tensor:
    """Per-row outgoing contribution pr/deg (0 for dangling rows)."""
    deg = (snap.indptr[1:] - snap.indptr[:-1]).to(torch.float32)
    return torch.where(deg > 0, pr / deg.clamp_min(1.0), 0.0)


def pagerank_scatter(snap, contrib: torch.Tensor, edges=None
                     ) -> torch.Tensor:
    """Scatter contributions along local CSR edges: float[n] -> inflow[n]."""
    n = _n(snap)
    src, ok, dst = edges if edges is not None else csr_edges(snap)
    val = torch.where(ok, contrib[src.clamp(0, n - 1).to(I64)], 0.0)
    out = torch.zeros((n + 1,), dtype=torch.float32, device=contrib.device)
    return out.index_add_(0, dst.to(I64), val)[:n]


def bfs(snap, source, max_iters: int = 64, impl: str = "auto"):
    """Level-synchronous BFS. Returns int32 depth per offset (-1
    unreachable). One frontier launch and one host fetch per level; the
    frontier and visited sets stay bitmaps between levels."""
    n = _n(snap)
    dev = snap.dst.device
    view = _frontier_view(snap, csr_edges(snap))
    W = cdiv(n, 32)
    depth = torch.full((n,), -1, dtype=I32, device=dev)
    depth[source] = 0
    seed = torch.zeros((n,), dtype=torch.bool, device=dev)
    seed[source] = True
    frontier = visited = pack_bits(seed, W)
    it = 0
    while it < max_iters:
        HOST_SYNCS["bfs"] += 1
        if not bool(frontier.any()):
            break
        nxt = ops.frontier_expand(*view, frontier, visited, impl=impl)
        depth = torch.where(unpack_bits(nxt, n), it + 1, depth)
        visited = visited | nxt
        frontier = nxt
        it += 1
    return depth


def sssp(snap, source, max_iters: int = 64):
    """Bellman-Ford (non-negative weights). float32 distances,
    INF=unreached."""
    n = _n(snap)
    dev = snap.dst.device
    src, ok, dst = csr_edges(snap)
    srcc = src.clamp(0, n - 1).to(I64)
    dstl = dst.to(I64)
    w = torch.where(ok, snap.weight, 0.0)
    dist = torch.full((n,), INF, dtype=torch.float32, device=dev)
    dist[source] = 0.0
    it = 0
    while it < max_iters:
        cand = torch.where(ok, dist[srcc] + w, INF)
        relax = torch.full((n + 1,), INF, dtype=torch.float32, device=dev)
        relax.scatter_reduce_(0, dstl, cand, "amin", include_self=True)
        nd = torch.minimum(dist, relax[:n])
        changed = (nd < dist).any()
        dist = nd
        it += 1
        HOST_SYNCS["sssp"] += 1
        if not bool(changed):
            break
    return dist


def _pagerank_step(snap, edges, active, deg, n_act, damping):
    """One damped power-iteration step (shared with
    ``incremental.pagerank_converge``)."""
    def step(pr):
        contrib = pagerank_contrib(snap, pr)
        dangling = torch.where(active & (deg == 0), pr, 0.0).sum()
        inflow = pagerank_scatter(snap, contrib, edges)
        base = torch.full_like(n_act, 1 - damping) / n_act
        return torch.where(active,
                           base + damping * (inflow + dangling / n_act), 0.0)
    return step


def _pagerank_setup(snap):
    deg = (snap.indptr[1:] - snap.indptr[:-1]).to(torch.float32)
    edges = csr_edges(snap)
    active = snap.active
    n_act = active.to(torch.float32).sum().clamp_min(1.0)
    return deg, edges, active, n_act


def pagerank(snap, iters: int = 20, damping: float = 0.85):
    deg, edges, active, n_act = _pagerank_setup(snap)
    pr = torch.where(active, torch.ones_like(n_act) / n_act, 0.0)
    step = _pagerank_step(snap, edges, active, deg, n_act, damping)
    for _ in range(iters):
        pr = step(pr)
    return pr


def wcc(snap, max_iters: int = 64):
    """Weakly connected components by min-label propagation + pointer
    jumping. Assumes edges inserted symmetrically (paper treats graphs as
    undirected)."""
    n = _n(snap)
    dev = snap.dst.device
    src, ok, dst = csr_edges(snap)
    srcc = src.clamp(0, n - 1).to(I64)
    dstl = dst.to(I64)
    lab = torch.where(snap.active, torch.arange(n, dtype=I32, device=dev), n)
    it = 0
    while it < max_iters:
        cand = torch.where(ok, lab[srcc], n)
        pull = torch.full((n + 1,), n, dtype=I32, device=dev)
        pull.scatter_reduce_(0, dstl, cand, "amin", include_self=True)
        nl = torch.minimum(lab, pull[:n])
        # pointer jumping (hook): label <- label[label]
        nl = torch.minimum(nl, nl[nl.clamp(0, n - 1).to(I64)])
        changed = (nl < lab).any()
        lab = nl
        it += 1
        HOST_SYNCS["wcc"] += 1
        if not bool(changed):
            break
    return torch.where(snap.active, lab, -1)


DMAX_TRI = 256


def triangle_count(snap):
    """Triangle count via sorted-adjacency merge on the CSR (undirected,
    symmetric edges; each triangle counted 6x as directed wedges).

    For edge e=(u,v) and each neighbor w = N(u)[r], r < ``DMAX_TRI``, the
    wedge closes iff (v,w) is an edge — a 32-step binary search over v's
    sorted CSR row. The JAX package runs the r loop to ``DMAX_TRI``; this
    loop stops at the largest row width (one host fetch), past which every
    step adds zero."""
    n = _n(snap)
    m_cap = snap.dst.shape[0]
    src, ok, _ = csr_edges(snap)
    dst = torch.where(ok, snap.dst, 0)
    srcc = src.clamp(0, n - 1).to(I64)
    dcl = dst.clamp(0, n - 1).to(I64)
    sd = snap.dst
    lo = snap.indptr[dcl]
    hi = snap.indptr[dcl + 1]
    row_start = snap.indptr[srcc]
    deg_u = snap.indptr[srcc + 1] - row_start
    total = torch.zeros((), dtype=I32, device=sd.device)
    HOST_SYNCS["triangle_count"] += 1
    rows = min(DMAX_TRI, int(torch.where(ok, deg_u, 0).max()) if m_cap
               else 0)
    for r in range(rows):
        in_row = (r < deg_u) & ok
        w = torch.where(in_row, sd[(row_start + r).clamp(0, m_cap - 1)
                                   .to(I64)], -1)
        l, h = lo, hi
        for _ in range(32):
            mid = (l + h) // 2
            go_r = sd[mid.clamp(0, m_cap - 1).to(I64)] < w
            l, h = torch.where(go_r, mid + 1, l), torch.where(go_r, h, mid)
        found = (l < hi) & (sd[l.clamp(0, m_cap - 1).to(I64)] == w) & \
            (w >= 0)
        total = total + (found & in_row).sum(dtype=I32)
    return total // 6


def bc(snap, sources: torch.Tensor, max_depth: int = 32):
    """Brandes betweenness (unweighted, sampled sources), GAPBS-style.

    Forward: level-synchronous BFS accumulating path counts sigma;
    backward: dependency accumulation over levels. All sources run at once
    along a leading (S, n) dimension. Returns centrality per offset."""
    n = _n(snap)
    dev = snap.dst.device
    src, ok, dst = csr_edges(snap)
    srcc = src.clamp(0, n - 1).to(I64)
    dstl = dst.to(I64)
    dstc = dst.clamp(0, n - 1).to(I64)
    sources = torch.as_tensor(sources, device=dev).to(I64).reshape(-1)
    S = sources.shape[0]
    rows = torch.arange(S, dtype=I64, device=dev)
    base = (rows * (n + 1))[:, None]

    def scatter(tgt, val):
        out = torch.zeros((S * (n + 1),), dtype=torch.float32, device=dev)
        out.index_add_(0, (base + tgt).reshape(-1), val.reshape(-1))
        return out.view(S, n + 1)[:, :n]

    depth = torch.full((S, n), -1, dtype=I32, device=dev)
    depth[rows, sources] = 0
    sigma = torch.zeros((S, n), dtype=torch.float32, device=dev)
    sigma[rows, sources] = 1.0
    for i in range(max_depth):
        on_lvl = depth[:, srcc] == i
        add = scatter(dstl.expand(S, -1),
                      torch.where(ok & on_lvl, sigma[:, srcc], 0.0))
        newly = (add > 0) & (depth < 0)
        depth = torch.where(newly, i + 1, depth)
        sigma = torch.where(depth == i + 1, sigma + add, sigma)

    delta = torch.zeros((S, n), dtype=torch.float32, device=dev)
    du, dv = depth[:, srcc], depth[:, dstc]
    ratio = sigma[:, srcc] / sigma[:, dstc].clamp_min(1.0)
    for k in range(max_depth):
        lvl = max_depth - 1 - k
        # edges u->v with depth[u]==lvl, depth[v]==lvl+1
        onedge = ok & (du == lvl) & (dv == lvl + 1)
        contrib = torch.where(onedge, ratio * (1.0 + delta[:, dstc]), 0.0)
        delta = delta + scatter(torch.where(onedge, srcc, n), contrib)
    delta[rows, sources] = 0.0
    return delta.sum(0)


def khop(snap, sources: torch.Tensor, k: int = 2, impl: str = "auto"):
    """k-hop neighborhood sizes for a batch of source offsets (paper
    §4.4). Only the initial sources required a SORT lookup — the hops run
    entirely on offsets (edge chain). One frontier launch per hop and
    source; no host fetch."""
    n = _n(snap)
    dev = snap.dst.device
    view = _frontier_view(snap, csr_edges(snap))
    W = cdiv(n, 32)
    sources = torch.as_tensor(sources, device=dev).to(I64).reshape(-1)
    counts = []
    for s in range(sources.shape[0]):
        seed = torch.zeros((n,), dtype=torch.bool, device=dev)
        seed.index_fill_(0, sources[s:s + 1], True)
        seen = frontier = pack_bits(seed, W)
        for _ in range(k):
            nf = ops.frontier_expand(*view, frontier, seen, impl=impl)
            seen = seen | nf
            frontier = nf
        counts.append(unpack_bits(seen, n).sum(dtype=I32) - 1)
    if not counts:
        return torch.zeros((0,), dtype=I32, device=dev)
    return torch.stack(counts)
