"""Vertex-space sharding of RadixGraph (port of ``repro.dist.graph_engine``:
the engine, ingest, reads and the distributed analytics).

Partitioning is the JAX package's: ``owner(key) = hash(key) % n_shards`` on
the SOURCE vertex, so one shard holds a vertex's whole edge array and
answers its queries locally. Undirected graphs insert both directions on
the host.

One process holds every shard. Every leaf of a sharded state carries a
leading ``n_shards`` axis, as ``make_sharded_state`` stacks it in both
packages (and as a checkpoint lays it out). Where JAX runs one program per
device under ``shard_map``, the port runs each step on every shard's slice
of that axis in turn:

* a routed step builds each source shard's ``(n, cap, C)`` bucket buffer
  exactly as JAX does, all source shards at once, and the ``all_to_all``
  becomes a transpose of the stacked ``(n_src, n_dst, cap, C)`` buffer, so
  a receiving shard sees its rows ordered by (source shard, rank) — the
  order ``jax.lax.all_to_all`` delivers them in, which decides the last
  writer;
* every shard applies all of its padded ``n * cap`` rows, masked-out rows
  included, so every shard's clock advances as JAX's does;
* a replicated decision (a ``psum`` / ``pmax`` feeding a ``lax.cond`` or
  a ``while_loop``: a route's overflow, an analytics loop's "go on") is
  one fetch over all shards, counted in ``edgepool.SYNCS["host_syncs"]``.

Like the port's single-shard ``step_*`` functions, the engine updates the
state it is given IN PLACE and returns it: each shard runs on views
``leaf[s]`` of the stacked tensors, and a leaf the step replaced (a scalar
such as ``clock + B``, the pool's tensors after a rebuild) is copied back
into slot ``s``. Callers that must keep the old state copy it first
(``radixgraph.clone_state``), as ``ShardedStore`` does for a captured
epoch. The analytics programs only read the state.

The analytics run level- or iteration-synchronous loops on the host over
stacked ``(n_shards, ...)`` tensors: per-shard CSR snapshots stacked on
the shard axis, elementwise work and the CSR scatters done for all shards
at once, the frontier kernel launched per shard on its own CSR view.

Keys are ``(..., 2)`` int64 words masked to 32 bits (uint32 in the JAX
package); the hash masks after every multiply and shift, so it matches
JAX's wrapping uint32 arithmetic bit for bit. A routed payload is an int32
word matrix holding JAX's uint32 words bit for bit (``_wrap32``), the
weight riding as its float32 bits: every exchange moves JAX's bytes. The
receiver widens the words to int64 (``_widen``) where uint32 arithmetic
or an unsigned compare needs them. Query bitmask words and frontier
bitmaps are int32 tensors holding uint32 bit patterns (as
``kernels.frontier.pack_bits`` makes them); WCC labels are int64 holding
uint32 vertex IDs, exchanged as int32 words.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..analytics import algorithms as alg
from ..core import edgepool as ep
from ..core import radixgraph as rg
from ..core import sort as sort_mod
from ..core import vertex_table as vt_mod
from ..core.radixgraph import GraphState
from ..core.sort import SortSpec
from ..core.tensor_ops import I32, I64, cdiv
from ..kernels import ops
from ..kernels.frontier import unpack_bits
from .costs_hook import note_collective

__all__ = ["shard_of_keys", "make_sharded_state", "make_apply_edges",
           "make_apply_edges_pipelined", "make_sync_vertices",
           "make_snapshot", "make_khop_counts", "make_degree_map",
           "make_num_edges", "make_bfs", "make_pagerank", "make_wcc",
           "make_sssp", "make_bfs_warm", "make_bc", "collect_owner_values",
           "shard_view", "put_shard", "ROUTES"]

_M32 = 0xFFFFFFFF
_SENT = 0x7FFFFFFF
# budgeted exchanges by the route they took: the compacted buckets, or the
# dense route a spilling bucket falls back to
ROUTES: Dict[str, int] = {"compact": 0, "dense_fallback": 0}


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for int64 ``a`` in [0, 2^32): split into 16-bit
    halves of ``c`` so no product leaves int64."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def shard_of_keys(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owner shard (int32) of each ``(..., 2)`` key: the JAX package's
    multiplicative hash with an xor-shift finalizer, in uint32 arithmetic
    held in int64."""
    hi = keys[..., 0].to(I64) & _M32
    lo = keys[..., 1].to(I64) & _M32
    h = (_mul32(lo, 0x9E3779B1) + _mul32(hi, 0x85EBCA77)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    return torch.remainder(h, n_shards).to(I32)


def make_sharded_state(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
                       n_per_shard: int, device="cuda") -> GraphState:
    """Fresh per-shard (SortState, VertexTable, EdgePool) stacked on a
    leading shard axis, on ``device``."""
    device = resolve_device(device)
    one = GraphState(sort=sort_mod.make_sort(sspec, device),
                     vt=vt_mod.make_vertex_table(n_per_shard, device),
                     pool=ep.make_edge_pool(pspec, device))
    return _tmap(lambda x: x.unsqueeze(0).repeat(
        (n_shards,) + (1,) * x.dim()), one)


# --------------------------------------------------------------------------
# stacked state <-> per-shard views
# --------------------------------------------------------------------------

def _tmap(fn, tree, *rest):
    """Map over the leaves of (nested) NamedTuples and tuples."""
    if not isinstance(tree, tuple):
        return fn(tree, *rest)
    out = [_tmap(fn, *xs) for xs in zip(tree, *rest)]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def _leaves(tree):
    if not isinstance(tree, tuple):
        return [tree]
    return [t for x in tree for t in _leaves(x)]


def shard_view(state: GraphState, s: int) -> GraphState:
    """Shard ``s`` of a stacked state as views: in-place updates of the
    view land in the stacked tensors."""
    return _tmap(lambda x: x[s], state)


def put_shard(state: GraphState, s: int, view: GraphState,
              new: GraphState) -> GraphState:
    """Copy every leaf of ``new`` that is not the view it came from (the
    step replaced it) into slot ``s`` of ``state``. Returns ``state``."""
    for st, v, nw in zip(_leaves(state), _leaves(view), _leaves(new)):
        if nw.data_ptr() != v.data_ptr():
            st[s].copy_(nw)
    return state


# --------------------------------------------------------------------------
# routing: buckets, drop-mode scatters, the exchange
# --------------------------------------------------------------------------

def _bucket_slots(owner: torch.Tensor, valid: torch.Tensor, cap: int):
    """Per source shard (leading axis), the slot of each op in
    per-destination buckets of ``cap`` entries: ``owner * cap + rank``,
    rank the op's stable order among same-owner ops. ``ok`` is False for
    invalid ops and bucket overflow (rank >= cap)."""
    S, N = owner.shape
    key = torch.where(valid, owner, _SENT)
    so, order = torch.sort(key, dim=1, stable=True)
    idx = torch.arange(N, dtype=I32, device=owner.device).expand(S, N)
    first = torch.ones((S, N), dtype=torch.bool, device=owner.device)
    first[:, 1:] = so[:, 1:] != so[:, :-1]
    start = torch.cummax(torch.where(first, idx, 0), dim=1).values
    rank = torch.empty((S, N), dtype=I32, device=owner.device).scatter_(
        1, order, idx - start)
    return owner * cap + rank, valid & (rank < cap)


def _scatter_rows(x: torch.Tensor, tgt: torch.Tensor, n_rows: int, fill):
    """Per source shard: ``full((n_rows, ...), fill).at[tgt].set(x,
    mode="drop")`` — a negative target counts from the end, one outside
    [-n_rows, n_rows) drops. Kept targets are distinct; dropped rows land
    spread over dump rows past ``n_rows`` (not all on one address)."""
    S, N = x.shape[:2]
    rest = x.shape[2:]
    D = max(1, min(N, 1024))
    t = tgt.to(I64)
    t = torch.where(t < 0, t + n_rows, t)
    dump = n_rows + torch.arange(N, device=x.device) % D
    t = torch.where((t >= 0) & (t < n_rows), t, dump)
    out = torch.full((S, n_rows + D) + rest, fill, dtype=x.dtype,
                     device=x.device)
    idx = t.reshape(t.shape + (1,) * len(rest)).expand(x.shape)
    out.scatter_(1, idx, x)
    return out[:, :n_rows]


def _all_to_all(buf: torch.Tensor) -> torch.Tensor:
    """``jax.lax.all_to_all(split_axis=0, concat_axis=0)`` over the shard
    axis: (n_src, n_dst, ...) -> (n_dst, n_src, ...). Counted per shard
    (``launch.costs``): each shard sends and receives ``buf.numel() /
    n_src`` words (int32 holding JAX's uint32 words, or float32)."""
    note_collective("all-to-all", buf.numel() // buf.shape[0],
                    buf.element_size())
    return buf.transpose(0, 1).contiguous()


def _owner_counts(owner, mask, n: int) -> torch.Tensor:
    """Per source shard, the masked rows bound for each destination:
    (S, n) int64, summed from a one-hot compare (no scatter onto n
    addresses)."""
    dest = torch.arange(n, dtype=owner.dtype, device=owner.device)
    return ((owner[..., None] == dest) & mask[..., None]).sum(
        dim=1, dtype=I64)


def _route_overflow(owner, mask, n: int, budget: int) -> bool:
    """Replicated: does any shard route more than ``budget`` rows to one
    destination? One host fetch (counted)."""
    over = torch.any(_owner_counts(owner, mask, n) > budget)
    note_collective("all-reduce", 1, 4)          # JAX: psum of an int32
    return bool(ep._fetch(over)[0])


def _route_dense(owner, mask, payload, n: int, cap: int):
    """Lossless dense route: ``cap`` rows per destination, validity as a
    trailing column. Returns per receiver (rows (n, n*cap, C), valid)."""
    S, _, C = payload.shape
    slot, ok = _bucket_slots(owner, mask, cap)
    p = torch.cat([payload, ok.to(payload.dtype)[..., None]], dim=2)
    buf = _scatter_rows(p, torch.where(ok, slot, n * cap), n * cap, 0)
    r = _all_to_all(buf.reshape(S, n, cap, C + 1)).reshape(n, S * cap, C + 1)
    return r[..., :C], r[..., C] == 1


def _route_compact(owner, mask, payload, n: int, budget: int):
    """Count-prefixed compacted route: per destination one header row (its
    [0] word = row count) and ``budget`` data rows. The caller has
    established (``_route_overflow``) that no bucket spills. Returns per
    receiver (rows (n, n*budget, C), valid)."""
    S, _, C = payload.shape
    stride = budget + 1
    slot, ok = _bucket_slots(owner, mask, budget)
    tgt = torch.where(ok, slot + slot // budget + 1, n * stride)
    buf = _scatter_rows(payload, tgt, n * stride, 0).reshape(S, n, stride, C)
    buf[:, :, 0, 0] = _owner_counts(owner, ok, n)
    r = _all_to_all(buf)                          # (n_dst, n_src, stride, C)
    cnt = r[:, :, 0, 0]
    rows = r[:, :, 1:, :].reshape(n, S * budget, C)
    ar = torch.arange(budget, device=owner.device)
    valid = (ar[None, None, :] < cnt[:, :, None]).reshape(n, S * budget)
    return rows, valid


def _route(owner, mask, payload, n: int, cap: int, budget: Optional[int]):
    """The dense route with ``cap`` rows a bucket; with ``budget``, the
    compacted route unless a bucket would spill (counted in ``ROUTES``)."""
    if budget is not None:
        if not _route_overflow(owner, mask, n, budget):
            ROUTES["compact"] += 1
            return _route_compact(owner, mask, payload, n, budget)
        ROUTES["dense_fallback"] += 1
    return _route_dense(owner, mask, payload, n, cap)


def _f32_bits(w: torch.Tensor) -> torch.Tensor:
    """float32 -> its bits as an int32 word."""
    return w.contiguous().view(I32)


def _bits_f32(x: torch.Tensor) -> torch.Tensor:
    """An int32 word -> the float32 with its bits."""
    return x.contiguous().view(torch.float32)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 holding the same bit pattern."""
    v = v & _M32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(I32)


def _widen(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 in [0, 2^32) (the uint32 value)."""
    return x.to(I64) & _M32


def _pack_qbits(b: torch.Tensor) -> torch.Tensor:
    """(..., Q) bool -> (..., ceil(Q/32)) int32 words: bit q is bit q % 32
    of word q // 32 (the uint32 pattern; bit 31 is the sign bit)."""
    Q = b.shape[-1]
    QW = cdiv(Q, 32)
    bp = torch.zeros(b.shape[:-1] + (QW * 32,), dtype=torch.bool,
                     device=b.device)
    bp[..., :Q] = b
    sh = torch.arange(32, dtype=I64, device=b.device)
    v = (bp.view(b.shape[:-1] + (QW, 32)).to(I64) << sh).sum(-1)
    return _wrap32(v)


def _unpack_qbits(words: torch.Tensor, Q: int) -> torch.Tensor:
    """(..., QW) int32 words -> (..., Q) bool. ``>>`` on a negative int32
    is arithmetic, so every shifted word is masked with ``& 1``."""
    sh = torch.arange(32, dtype=I64, device=words.device)
    bits = (words.to(I64)[..., None] >> sh) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :Q] == 1


def _popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each row of a (..., W) int32 word matrix (int32),
    counted with bit tricks on the uint32 pattern held in int64."""
    x = words.to(I64) & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) >> 24) & 0xFF
    return x.sum(-1, dtype=I32)


# --------------------------------------------------------------------------
# ingest
# --------------------------------------------------------------------------

def _apply_rows(sspec, pspec, state, rows_sk, rows_dk, rows_w, rows_valid):
    """Every receiving shard applies its rows (all of them, masked or not)
    with the single-shard transition. Returns (state, dropped int32[n])."""
    drops = []
    for s in range(rows_sk.shape[0]):
        view = shard_view(state, s)
        new, d = rg.step_update_edges(
            sspec, pspec, view, rows_sk[s].contiguous(),
            rows_dk[s].contiguous(), rows_w[s].contiguous(),
            rows_valid[s].contiguous())
        put_shard(state, s, view, new)
        drops.append(d)
    return state, torch.stack(drops)


def _make_shard_batch_apply(sspec: SortSpec, pspec: ep.PoolSpec, n: int,
                            pack: bool, capacity_factor: float,
                            route_budget: Optional[int]):
    """The routed apply of ONE global op batch, shared by the per-batch and
    pipelined entries: ``(state, sk, dk, w, mask) -> (state, dropped)``."""

    def apply_one(state, sk, dk, w, mask):
        B = sk.shape[0]
        Bl = B // n
        sk = sk.reshape(n, Bl, 2).to(I64)
        dk = dk.reshape(n, Bl, 2).to(I64)
        w = w.reshape(n, Bl)
        mask = mask.reshape(n, Bl)
        cap = max(1, int(round(Bl * capacity_factor)))
        owner = shard_of_keys(sk, n)
        if route_budget is not None:
            payload = torch.cat([_wrap32(sk), _wrap32(dk),
                                 _f32_bits(w)[..., None]], dim=-1)
            rows, valid = _route(owner, mask, payload, n, Bl, route_budget)
            return _apply_rows(sspec, pspec, state, _widen(rows[..., 0:2]),
                               _widen(rows[..., 2:4]),
                               _bits_f32(rows[..., 4]), valid)
        slot, ok = _bucket_slots(owner, mask, cap)
        route_drop = (mask & ~ok).to(I32).sum(dim=1, dtype=I32)
        NC = n * cap
        tgt = torch.where(ok, slot, NC)

        def xch(x, fill):
            buf = _scatter_rows(x, tgt, NC, fill)
            return _all_to_all(buf.reshape((n, n, cap) + x.shape[2:])
                               ).reshape((n, NC) + x.shape[2:])

        if pack:
            payload = torch.cat([_wrap32(sk), _wrap32(dk),
                                 _f32_bits(w)[..., None],
                                 ok.to(I32)[..., None]], dim=-1)  # (n, Bl, 6)
            r = xch(payload, 0)
            rsk, rdk = _widen(r[..., 0:2]), _widen(r[..., 2:4])
            rw, rmask = _bits_f32(r[..., 4]), r[..., 5] == 1
        else:
            rsk, rdk = _widen(xch(_wrap32(sk), 0)), _widen(xch(_wrap32(dk), 0))
            rw, rmask = xch(w, 0.0), xch(ok.to(I32), 0) == 1
        state, dropped = _apply_rows(sspec, pspec, state, rsk, rdk, rw,
                                     rmask)
        return state, dropped + route_drop

    return apply_one


def make_apply_edges(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
                     pack: bool = True, capacity_factor: float = 1.0,
                     route_budget: Optional[int] = None):
    """Build ``apply(state, src_keys, dst_keys, w, mask) -> (state,
    dropped)`` over GLOBAL batches: (B, 2) keys, (B,) float32 weights (0 =
    delete), (B,) bool mask, B divisible by ``n_shards``; source shard
    ``s`` routes ops ``[s*B/n, (s+1)*B/n)``. ``dropped`` is int32[n_shards]:
    routing overflow (``capacity_factor < 1``) at the source shard, vertex
    table or pool exhaustion at the receiver.

    ``pack`` sends the payload as one word matrix (else one exchange per
    column; the answer is the same). ``route_budget`` sends count-prefixed
    buckets of that many rows, falling back to the dense lossless route
    whenever a bucket would spill; ``capacity_factor`` then does not
    apply, as in the JAX package."""
    apply_one = _make_shard_batch_apply(sspec, pspec, n_shards, pack,
                                        capacity_factor, route_budget)

    def apply_edges(state, src_keys, dst_keys, w, mask):
        B = src_keys.shape[0]
        assert B % n_shards == 0, \
            f"global op batch {B} not divisible by {n_shards} shards"
        return apply_one(state, src_keys, dst_keys, w, mask)

    return apply_edges


def make_apply_edges_pipelined(sspec: SortSpec, pspec: ep.PoolSpec,
                               n_shards: int, pack: bool = True,
                               capacity_factor: float = 1.0,
                               route_budget: Optional[int] = None):
    """Build ``apply(state, src_keys, dst_keys, w, mask) -> (state,
    dropped)`` over a STACKED (K, B, ...) super-batch: the K routed
    batches in order (JAX scans them in one program), the drops summed
    over them. Equal to K calls of ``make_apply_edges``."""
    apply_one = _make_shard_batch_apply(sspec, pspec, n_shards, pack,
                                        capacity_factor, route_budget)

    def apply_edges_pipelined(state, src_keys, dst_keys, w, mask):
        K, B = src_keys.shape[0], src_keys.shape[1]
        assert B % n_shards == 0, \
            f"global op batch {B} not divisible by {n_shards} shards"
        assert w.shape == (K, B) and mask.shape == (K, B)
        drops = []
        for k in range(K):
            state, d = apply_one(state, src_keys[k], dst_keys[k], w[k],
                                 mask[k])
            drops.append(d)
        return state, torch.stack(drops).sum(dim=0, dtype=I32)

    return apply_edges_pipelined


# --------------------------------------------------------------------------
# vertex sync and reads
# --------------------------------------------------------------------------

def _row_meta(state: GraphState, n: int):
    """Per-row metadata of every shard: (rowlive, owner, mine), each
    (n, n_cap)."""
    rowlive = state.vt.del_time == 0
    owner = shard_of_keys(state.vt.ids, n)
    my = torch.arange(n, dtype=I32, device=owner.device)[:, None]
    return rowlive, owner, rowlive & (owner == my)


def make_sync_vertices(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
                       budget: Optional[int] = None,
                       incremental: bool = False):
    """Build ``sync(state) -> state``: every live row's vertex ID is routed
    to its hash-owner shard and located-or-inserted there, so each vertex
    has an owner row even if it only ever appeared as a destination.
    Idempotent.

    ``incremental=True`` builds ``sync(state, prev_rows, rows=None) ->
    state``: only rows with index >= ``prev_rows[shard]`` (created since
    the caller's last sync) are routed. ``rows``, each shard's current
    row count as host ints (with ``prev_rows`` as host ints too), bounds
    the scan to rows [min(prev_rows), max(rows)), outside which no row
    qualifies: the routed buckets are the same, the cost O(new rows)
    instead of O(n_per_shard). ``budget`` sends count-prefixed buckets of
    that many rows, with the dense fallback when one would spill."""
    n = n_shards

    def sync(state, *prev):
        vt = state.vt
        n_cap = vt.del_time.shape[1]
        lo, hi = 0, n_cap
        if incremental and len(prev) > 1:
            lo, hi = int(min(prev[0])), int(max(prev[1]))
        ids = vt.ids[:, lo:hi]
        rowlive = vt.del_time[:, lo:hi] == 0
        if incremental:
            prev_rows = torch.as_tensor(prev[0], device=rowlive.device)
            rowlive = rowlive & (torch.arange(
                lo, hi, dtype=I32, device=rowlive.device)[None, :] >=
                prev_rows.to(I32)[:, None])
        owner = shard_of_keys(ids, n)
        rows, valid = _route(owner, rowlive, _wrap32(ids), n, n_cap, budget)
        rows = _widen(rows)
        for s in range(n):
            view = shard_view(state, s)
            st, vt_s, _, _ = vt_mod.ensure_vertices(
                sspec, view.sort, view.vt, rows[s].contiguous(),
                valid[s].contiguous())
            put_shard(state, s, view, GraphState(st, vt_s, view.pool))
        return state

    return sync


def _stack(items):
    return _tmap(lambda *xs: torch.stack(xs), items[0], *items[1:])


def make_snapshot(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
                  m_cap: int, read_ts: Optional[int] = None):
    """Build ``snap(state) -> GraphSnapshot`` with a leading shard axis:
    each shard's CSR of ITS slice of the edge set (the dst column holds
    that shard's row offsets)."""

    def snap(state):
        return _stack([rg.step_snapshot(sspec, pspec, m_cap,
                                        shard_view(state, s), read_ts)
                       for s in range(n_shards)])

    return snap


def make_khop_counts(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
                     k: int = 1, read_ts: Optional[int] = None,
                     m_cap: Optional[int] = None,
                     frontier_budget: Optional[int] = None,
                     impl: str = "auto"):
    """Build ``khop(state, query_keys) -> int32[Q]``: live (deduplicated)
    k-hop neighbourhood counts for arbitrary query keys, routed with the
    update hash partition; ``Q`` divisible by ``n_shards``.

    ``k == 1`` with ``m_cap=None`` answers out-degree straight off the
    owner's edge array (0 for absent vertices, self-loops count), queries
    routed to their owners and the answers routed back. With ``m_cap``
    set (required for ``k > 1``), the frontier rounds run instead over
    per-shard CSR snapshots of a vertex-SYNCED state, matching
    ``analytics.khop``: distinct vertices within ``k`` hops, the source
    excluded, 0 for absent sources.

    Frontier rounds: a query's slot is (source shard, index), so bit q
    names one query on every shard. Visited and frontier sets stay packed,
    (Qtot, n_cap/32) int32 words a shard. Each hop expands every query
    whose frontier is non-empty anywhere (one counted fetch a hop names
    them) through the frontier kernel on that shard's (m_cap, 1) CSR view
    (``impl`` picks the kernel or its plain version); the hits ride ONE
    exchange as (id, query-bitmask words) rows — compacted under
    ``frontier_budget`` with the dense fallback — and the owners OR them
    into per-row words, one source shard's bucket at a time (a row appears
    at most once in a bucket). The count is the popcount of the visited
    words summed over shards, minus the source."""
    n = n_shards
    if k not in (1, 2, 3):
        raise NotImplementedError("khop counts support k <= 3 (bounded "
                                  "frontier rounds)")
    if k > 1 and m_cap is None:
        raise ValueError("k >= 2 requires m_cap for the CSR snapshot")

    def khop_degree(state, query_keys):
        Q = query_keys.shape[0]
        Ql = Q // n
        qk = query_keys.reshape(n, Ql, 2).to(I64)
        owner = shard_of_keys(qk, n)
        slot, _ = _bucket_slots(owner, torch.ones_like(owner, dtype=bool),
                                Ql)
        buf = _scatter_rows(_wrap32(qk), slot, n * Ql, 0)
        recv = _widen(_all_to_all(buf.reshape(n, n, Ql, 2))).reshape(
            n, n * Ql, 2)
        # unrouted slots hold key 0: their answers are never read back
        cnt = torch.stack([rg.step_degree_counts(
            sspec, pspec, shard_view(state, s), recv[s], read_ts=read_ts)
            for s in range(n)])
        back = _all_to_all(cnt.reshape(n, n, Ql)).reshape(n, n * Ql)
        return torch.gather(back, 1, slot.to(I64)).reshape(-1)

    def khop_frontier(state, query_keys):
        Qtot = query_keys.shape[0]
        Ql = Qtot // n
        QW = cdiv(Qtot, 32)
        n_cap = state.vt.del_time.shape[1]
        VW = cdiv(n_cap, 32)
        dev = query_keys.device
        snaps, edges = _csr(sspec, pspec, m_cap, state, read_ts)
        views = [alg._frontier_view(_shard(snaps, s), _shard(edges, s))
                 for s in range(n)]
        rowlive, owner, _mine = _row_meta(state, n)
        # route the queries to their owners: the slot is (owner, index),
        # so the receiver's position (source shard, index) names the query
        # on every shard; the validity column keeps an unrouted slot (key
        # 0) from aliasing vertex 0
        qk = query_keys.reshape(n, Ql, 2).to(I64)
        qowner = shard_of_keys(qk, n)
        idx = torch.arange(Ql, dtype=I32, device=dev)
        qpay = torch.cat([_wrap32(qk), torch.ones((n, Ql, 1), dtype=I32,
                                                  device=dev)], dim=2)
        buf = _scatter_rows(qpay, qowner * Ql + idx, Qtot, 0)
        recv = _all_to_all(buf.reshape(n, n, Ql, 3)).reshape(n, Qtot, 3)
        roff = torch.where(recv[..., 2] == 1,
                           _lookup(sspec, state, _widen(recv[..., 0:2])), -1)
        visited = torch.zeros((n * Qtot, VW + 1), dtype=I64, device=dev)
        one = torch.ones((), dtype=I64, device=dev)
        visited.scatter_(1, torch.where(roff >= 0, roff >> 5, VW).to(
            I64).reshape(-1, 1), torch.where(
                roff >= 0, one << (roff.to(I64) & 31), 0).reshape(-1, 1))
        visited = _wrap32(visited[:, :VW]).reshape(n, Qtot, VW)
        frontier = visited
        none = torch.zeros((VW,), dtype=I32, device=dev)
        ids = _wrap32(state.vt.ids)
        bit = [_wrap32(torch.tensor(1 << b, dtype=I64)).to(dev)
               for b in range(32)]

        def mark(rows, valid):
            """Owner rows hit by each query: (n, n_cap, QW) int32 words."""
            ro = _lookup(sspec, state, _widen(rows[..., 0:2]))
            ok = valid & (ro >= 0)
            tgt = _spread(torch.where(ok, ro, n_cap), n_cap)
            words = rows[..., 2:]
            R = rows.shape[1] // n          # one source shard's bucket
            hit = torch.zeros((n, n_cap + 1 + _DUMPS, QW), dtype=I32,
                              device=dev)
            for j in range(n):
                sl = slice(j * R, (j + 1) * R)
                part = torch.zeros_like(hit)
                part.scatter_(1, tgt[:, sl, None].expand(-1, -1, QW),
                              words[:, sl])
                hit |= part
            return hit[:, :n_cap]

        for _hop in range(k):
            live_q = torch.tensor(ep._fetch(frontier.ne(0).any(-1)),
                                  dtype=torch.bool).view(n, Qtot)
            qwords = torch.zeros((n, n_cap, QW), dtype=I32, device=dev)
            for s in range(n):
                for q in torch.nonzero(live_q[s]).flatten().tolist():
                    e = ops.frontier_expand(*views[s], frontier[s, q], none,
                                            impl=impl)
                    qwords[s, :, q // 32] |= torch.where(
                        unpack_bits(e, n_cap), bit[q % 32], 0)
            mask_rows = rowlive & qwords.ne(0).any(-1)
            payload = torch.cat([ids, qwords], dim=2)
            hit = mark(*_route(owner, mask_rows, payload, n, n_cap,
                               frontier_budget))
            # only queries expanded this hop can have hits
            nxt = torch.zeros_like(frontier)
            for q in torch.nonzero(live_q.any(0)).flatten().tolist():
                on = (hit[..., q // 32].to(I64) >> (q % 32)) & 1
                nxt[:, q] = _pack_qbits(on == 1)
            frontier = nxt & ~visited
            visited = visited | frontier

        counts = _popcount_rows(visited).sum(0, dtype=I32)
        return torch.clamp(counts - 1, min=0)  # drop the source; absent: 0

    body = khop_degree if (k == 1 and m_cap is None) else khop_frontier

    def khop(state, query_keys):
        Q = query_keys.shape[0]
        assert Q % n == 0, f"query batch {Q} not divisible by {n} shards"
        return body(state, query_keys)

    return khop


def make_degree_map(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
                    m_cap: int):
    """Build ``deg(state) -> int32[n_shards, n_cap]``: live out-degree at
    owner rows (edges live in the source's owner shard, so the local CSR
    row length IS the degree)."""
    snap_fn = make_snapshot(sspec, pspec, n_shards, m_cap)

    def deg(state):
        snap = snap_fn(state)
        _, _, mine = _row_meta(state, n_shards)
        d = snap.indptr[:, 1:] - snap.indptr[:, :-1]
        return torch.where(mine, d, 0)

    return deg


def make_num_edges(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
                   m_cap: int):
    """Build ``m(state) -> int32[n_shards]``: per-shard live-edge counts
    (the store sums them on the host)."""
    snap_fn = make_snapshot(sspec, pspec, n_shards, m_cap)
    return lambda state: snap_fn(state).m.to(I32)


# --------------------------------------------------------------------------
# distributed analytics: per-shard CSR snapshots + level-synchronous loops
# with frontier / value exchanges over the shard axis
#
# Edges live in the SOURCE vertex's shard, so a shard's CSR covers exactly
# its local rows; a vertex that only appears as a destination has stub
# rows (no edges) in source shards. The vertex sync gives every vertex one
# OWNER row, where results are accumulated and read. Every program reads a
# vertex-SYNCED state and changes nothing in it.
# --------------------------------------------------------------------------

def _shard(tree, s: int):
    """Slot ``s`` of a stacked tuple / NamedTuple, as views."""
    return _tmap(lambda x: x[s], tree)


def _csr(sspec, pspec, m_cap: int, state: GraphState, read_ts=None):
    """Per-shard CSR snapshots and their loop-invariant edge views
    (``analytics.csr_edges``: src row, validity, dst routed to the dump
    row), each stacked on the shard axis."""
    n = state.vt.del_time.shape[0]
    snaps = make_snapshot(sspec, pspec, n, m_cap, read_ts)(state)
    edges = tuple(torch.stack(x) for x in zip(
        *[alg.csr_edges(_shard(snaps, s)) for s in range(n)]))
    return snaps, edges


def _lookup(sspec, state: GraphState, keys: torch.Tensor) -> torch.Tensor:
    """Each shard's SORT lookup of its own (K, 2) keys: (n, K, 2) ->
    (n, K) int32 row offsets (-1 absent)."""
    return torch.stack([sort_mod.lookup(sspec, _shard(state.sort, s),
                                        keys[s].contiguous())
                        for s in range(keys.shape[0])])


def _psum(parts: torch.Tensor) -> torch.Tensor:
    """Sum over the shard axis in shard order (shard 0 first), as a
    replicated ``psum`` of per-shard partials (counted per shard)."""
    note_collective("all-reduce", parts[0].numel(), parts.element_size())
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _go(flag: torch.Tensor) -> bool:
    """A replicated loop decision (``psum(...) > 0`` feeding a
    ``while_loop``): one counted host fetch, a psum of an int32 in
    JAX."""
    note_collective("all-reduce", 1, 4)
    return bool(ep._fetch(flag.any())[0])


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per shard ``x[s][idx[s]]``: x (n, L, ...), idx (n, E) -> (n, E,
    ...)."""
    idx = idx.to(I64)
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


# masked-out entries of an analytics scatter target one dump row (the
# padded CSR slots, the dense route's empty slots: most of 2^25 entries a
# shard at LiveJournal scale); they are spread over this many extra rows,
# so that no single address takes millions of atomics on the card
_DUMPS = 1024


def _spread(idx: torch.Tensor, dump: int) -> torch.Tensor:
    """``idx`` (n, E) with every ``dump`` entry moved to one of ``_DUMPS``
    rows past it (by position), as int64."""
    idx = idx.to(I64)
    E = idx.shape[1]
    rows = dump + 1 + torch.arange(E, device=idx.device) % _DUMPS
    return torch.where(idx == dump, rows, idx)


def _scatter(rows: int, fill, idx: torch.Tensor, vals: torch.Tensor,
             reduce: str) -> torch.Tensor:
    """Per shard, ``full((rows + 1, ...), fill).at[idx].add(vals)``
    (``reduce="sum"``: atomics on the card, not order-stable) or
    ``.at[idx].min(vals)`` (``"amin"``: exact): (n, E) targets in [0,
    rows], row ``rows`` the dump, (n, E, ...) values -> (n, rows + 1,
    ...). Entries bound for the dump are spread (``_spread``) and folded
    back into it after."""
    n = idx.shape[0]
    out = torch.full((n, rows + 1 + _DUMPS) + vals.shape[2:], fill,
                     dtype=vals.dtype, device=vals.device)
    idx = _spread(idx, rows)
    if vals.dim() > 2:
        idx = idx.reshape(idx.shape + (1,) * (vals.dim() - 2)).expand(
            vals.shape)
    if reduce == "sum":
        out.scatter_add_(1, idx, vals)
        out[:, rows] += out[:, rows + 1:].sum(1)
    else:
        out.scatter_reduce_(1, idx, vals, reduce, include_self=True)
        out[:, rows] = torch.minimum(out[:, rows],
                                     out[:, rows + 1:].amin(1))
    return out[:, :rows + 1]


def _owner_value_route(sspec, state: GraphState, n: int, owner, rowlive,
                       budget: Optional[int]):
    """The live-row -> owner-row exchange shared by every iterative
    combine loop (PageRank inflow, WCC labels, SSSP distances, BC sigma /
    delta). Returns ``(rtgt, fwd, bwd)``.

    The route is data-independent — every live row ships to its
    hash-owner's shard — so it is resolved ONCE per program: a key
    exchange binds each receiver slot to one of the receiver's own rows
    (``rtgt``, (n, R), ``n_cap`` the dump row), and per iteration only
    VALUES move:

    ``fwd(vals)``   (n, n_cap, C) per-row values -> (n, R, C) routed rows
                    at the receivers, aligned with ``rtgt`` (combine with
                    a scatter onto ``n_cap + 1`` rows);
    ``bwd(merged)`` (n, n_cap + 1, C) owner-merged values -> ((n, n_cap,
                    C), ok): every routed row reads its owner's merged
                    value back over the inverse exchange (``ok`` marks
                    routed rows).

    With ``budget`` set, ONE counted fetch decides for the whole program:
    the count-prefixed compacted buckets when none spills, else the dense
    layout; the results are identical either way."""
    n_cap = owner.shape[1]
    keys = _wrap32(state.vt.ids)
    compact = budget is not None and not _route_overflow(owner, rowlive, n,
                                                         budget)
    if budget is not None:
        ROUTES["compact" if compact else "dense_fallback"] += 1
    if compact:
        F, stride = budget, budget + 1
        rows, valid = _route_compact(owner, rowlive, keys, n, F)
        slot, ok = _bucket_slots(owner, rowlive, F)
        tgt = torch.where(ok, slot + slot // F + 1, n * stride)
    else:
        F, stride = n_cap, n_cap
        rows, valid = _route_dense(owner, rowlive, keys, n, n_cap)
        slot, ok = _bucket_slots(owner, rowlive, n_cap)
        tgt = torch.where(ok, slot, n * stride)
    R = n * F
    roff = _lookup(sspec, state, _widen(rows))
    rtgt = torch.where(valid & (roff >= 0), roff, n_cap).to(I64)
    tgtc = tgt.clamp(0, n * stride - 1).to(I64)

    def fwd(vals):
        C = vals.shape[2]
        wide = vals.dtype == I64                 # uint32 words: as int32
        vbuf = _scatter_rows(_wrap32(vals) if wide else vals, tgt,
                             n * stride, 0)
        r = _all_to_all(vbuf.reshape(n, n, stride, C))
        if compact:
            r = r[:, :, 1:, :]
        r = r.reshape(n, R, C)
        return _widen(r) if wide else r

    def bwd(merged):
        ans = _gather(merged, rtgt)                          # (n, R, C)
        wide = ans.dtype == I64
        if wide:
            ans = _wrap32(ans)
        C = ans.shape[2]
        if compact:
            abuf = torch.zeros((n, n, stride, C), dtype=ans.dtype,
                               device=ans.device)
            abuf[:, :, 1:, :] = ans.reshape(n, n, F, C)
            back = _all_to_all(abuf).reshape(n, n * stride, C)
        else:
            back = _all_to_all(ans.reshape(n, n, stride, C)).reshape(
                n, n * stride, C)
        back = _gather(back, tgtc)
        return (_widen(back) if wide else back), ok

    return rtgt, fwd, bwd


def _source_rows(sspec, state: GraphState, keys: torch.Tensor):
    """Each shard's row of each replicated (K, 2) source key: (n, K)."""
    n = state.vt.del_time.shape[0]
    k = keys.to(I64).reshape(1, -1, 2).expand(n, -1, -1)
    return _lookup(sspec, state, k)


def make_bfs(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
             m_cap: int, max_iters: int = 32,
             frontier_budget: Optional[int] = None, impl: str = "auto"):
    """Build ``bfs(state, source_key) -> int32[n_shards, n_cap]``: level-
    synchronous distributed BFS. Per level each shard expands its own CSR
    through the frontier kernel (``analytics.bfs_expand``; ``impl`` picks
    the kernel or its plain version), discovered rows' IDs ride one
    exchange to their owner shards, which mark depth and seed the next
    frontier; one counted fetch a level decides whether to go on. Depths
    are authoritative at owner rows (-1 unreachable); stub rows may keep
    the level their shard first saw the vertex.

    ``frontier_budget`` compacts each level's exchange (count-prefixed
    buckets, the dense route when one would spill; one counted fetch a
    level decides), and the depths are identical either way."""
    n = n_shards

    def bfs(state, source_key):
        n_cap = state.vt.del_time.shape[1]
        dev = state.vt.del_time.device
        snaps, edges = _csr(sspec, pspec, m_cap, state)
        rowlive, owner, _mine = _row_meta(state, n)
        my = torch.arange(n, dtype=I32, device=dev)[:, None]
        ids = _wrap32(state.vt.ids)

        def mark_hits(rows, valid):
            roff = _lookup(sspec, state, _widen(rows[..., 0:2]))
            seen = valid & (roff >= 0)
            hit = torch.zeros((n, n_cap + 1 + _DUMPS), dtype=torch.bool,
                              device=dev)
            hit.scatter_(1, _spread(torch.where(seen, roff, n_cap), n_cap),
                         True)
            return hit[:, :n_cap]

        off0 = _source_rows(sspec, state, source_key)        # (n, 1)
        row = torch.arange(n_cap, dtype=I32, device=dev)[None, :]
        depth = torch.where(row == off0, 0, -1).to(I32)
        frontier = (row == off0) & rowlive
        go, it = _go(frontier), 0
        while go and it < max_iters:
            new_local = torch.stack([alg.bfs_expand(
                _shard(snaps, s), frontier[s], _shard(edges, s), impl=impl)
                for s in range(n)]) & (depth < 0)
            # stub rows are marked locally (each row notifies at most
            # once); owner rows are marked through the exchange, which
            # also dedups discoveries arriving from several shards
            hit = mark_hits(*_route(owner, new_local, ids, n, n_cap,
                                    frontier_budget))
            depth = torch.where(new_local & (owner != my), it + 1, depth)
            nxt = hit & (depth < 0)
            depth = torch.where(nxt, it + 1, depth)
            go, it = _go(nxt), it + 1
            frontier = nxt
        return depth

    return bfs


def _iters(it: int, n: int, device) -> torch.Tensor:
    """A loop's iteration count, replicated per shard (JAX's output)."""
    return torch.full((n,), it, dtype=I32, device=device)


def make_pagerank(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
                  m_cap: int, iters: int = 20, damping: float = 0.85,
                  frontier_budget: Optional[int] = None,
                  tol: Optional[float] = None, warm: bool = False):
    """Build ``pr(state) -> float32[n_shards, n_cap]``: distributed
    PageRank. Ranks live at owner rows; per iteration each shard scatters
    contributions along its own CSR (``analytics.pagerank_scatter``) and
    every live row's inflow rides the owner route back to the row's
    owner. The active count and the dangling mass are per-shard partials
    summed in shard order.

    ``tol=None`` runs ``iters`` iterations. With ``tol`` the loop stops
    when the owner rows' ``max|dpr|`` (compared in float32, one counted
    fetch an iteration) drops under ``tol``, ``iters`` the cap, and
    returns ``(pr, iters_run)``; ``warm`` also takes a ``(n_shards,
    n_cap)`` float32 seed (negative = no previous value, start uniform).
    Float sums are not order-stable on the card: hold ranks to 1e-5."""
    n = n_shards
    assert not (warm and tol is None), "warm PageRank needs a tol"
    tol32 = None if tol is None else float(np.float32(tol))

    def pr(state, *extra):
        dev = state.vt.del_time.device
        n_cap = state.vt.del_time.shape[1]
        snaps, edges = _csr(sspec, pspec, m_cap, state)
        rowlive, owner, mine = _row_meta(state, n)
        deg = (snaps.indptr[:, 1:] - snaps.indptr[:, :-1]).to(torch.float32)
        n_act = _psum(mine.to(torch.float32).sum(1)).clamp_min(1.0)
        rank = torch.where(mine, torch.ones_like(n_act) / n_act, 0.0)
        if warm:
            w0 = extra[0].to(dev)
            rank = torch.where(mine & (w0 >= 0), w0, rank)
        rtgt, fwd, bwd = _owner_value_route(sspec, state, n, owner, rowlive,
                                            frontier_budget)
        base = torch.full_like(n_act, 1 - damping) / n_act

        def one(p):
            local_in = torch.stack([alg.pagerank_scatter(
                _shard(snaps, s), alg.pagerank_contrib(_shard(snaps, s),
                                                       p[s]),
                _shard(edges, s)) for s in range(n)])
            inflow = _scatter(n_cap, 0.0, rtgt,
                              fwd(local_in[..., None])[..., 0], "sum")
            dangling = _psum(torch.where(mine & (deg == 0), p, 0.0).sum(1))
            return torch.where(mine, base + damping *
                               (inflow[:, :n_cap] + dangling / n_act), 0.0)

        if tol is None:
            for _ in range(iters):
                rank = one(rank)
            return rank
        it = 0
        while it < iters:
            nxt = one(rank)
            ch = torch.where(mine, (nxt - rank).abs(), 0.0).max()
            rank, it = nxt, it + 1
            if not _go(ch >= tol32):
                break
        return rank, _iters(it, n, dev)

    return pr


def _min_relax(val, fill, cand_of, edges, route, mine, max_rounds: int):
    """The min-plus combine loop of WCC, SSSP and warm BFS: each round
    every shard relaxes its own edges (``cand_of(val at the edge's
    source)``, a min-scatter at the destination rows), the owners merge
    every copy's value with a min-scatter, and the merged value goes back
    to every copy. It stops after a round in which no OWNER row improved
    (one counted fetch a round) or after ``max_rounds``. Min is exact, so
    the values and the round count do not depend on the order. Returns
    ``(val, rounds)``."""
    src, ok, dst = edges
    n, n_cap = val.shape
    srcc = src.clamp(0, n_cap - 1)
    rtgt, fwd, bwd = route
    changed, it = True, 0
    while changed and it < max_rounds:
        cand = torch.where(ok, cand_of(_gather(val, srcc)), fill)
        nv = torch.minimum(val, _scatter(n_cap, fill, dst, cand,
                                         "amin")[:, :n_cap])
        back, okb = bwd(_scatter(n_cap, fill, rtgt, fwd(nv[..., None]),
                                 "amin"))
        nv = torch.where(okb, back[..., 0], nv)
        changed, it = _go(mine & (nv < val)), it + 1
        val = nv
    return val, it


def make_wcc(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
             m_cap: int, max_iters: int = 64,
             frontier_budget: Optional[int] = None, warm: bool = False):
    """Build ``wcc(state) -> int64[n_shards, n_cap]``: distributed weakly
    connected components by min-label propagation along each shard's
    edges. Each component converges to the minimum live vertex ID in it
    (canonical across shard counts), an unsigned 32-bit label held in
    int64 (a signed int32 min would misorder labels at or above 2^31);
    keys' hi words must be zero. ``0xFFFFFFFF`` marks dead rows.

    ``warm`` adds a ``(n_shards, n_cap)`` label seed (a previous epoch's
    output; ``0xFFFFFFFF`` is the identity under min) and returns
    ``(labels, iters_run)``: insert-only deltas only merge components, so
    the previous labels stay upper bounds."""
    n = n_shards

    def wcc(state, *extra):
        snaps, edges = _csr(sspec, pspec, m_cap, state)
        rowlive, owner, mine = _row_meta(state, n)
        lab = torch.where(rowlive, state.vt.ids[..., 1].to(I64) & _M32, _M32)
        if warm:
            w0 = extra[0].to(device=lab.device, dtype=I64) & _M32
            lab = torch.where(rowlive, torch.minimum(lab, w0), _M32)
        route = _owner_value_route(sspec, state, n, owner, rowlive,
                                   frontier_budget)
        lab, it = _min_relax(lab, _M32, lambda x: x, edges, route, mine,
                             max_iters)
        out = torch.where(rowlive, lab, _M32)
        return (out, _iters(it, n, out.device)) if warm else out

    return wcc


def make_sssp(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
              m_cap: int, max_iters: int = 64,
              frontier_budget: Optional[int] = None, warm: bool = False):
    """Build ``sssp(state, source_key) -> float32[n_shards, n_cap]``:
    distributed Bellman-Ford (non-negative weights). Each round relaxes
    every shard's edges with the single-shard reference's float op
    (``dist[u] + w``), owners merge with a min-scatter and broadcast the
    merged distance back; min is exact and the edge set partitioned, so
    distances and rounds equal ``analytics.sssp``'s. ``INF`` =
    unreachable.

    ``warm`` adds a ``(n_shards, n_cap)`` float32 distance seed (a
    previous epoch's output) and returns ``(dist, iters_run)``; valid
    for insert / weight-decrease deltas (the seeds stay upper bounds)."""
    n = n_shards
    INF = alg.INF

    def sssp(state, source_key, *extra):
        dev = state.vt.del_time.device
        n_cap = state.vt.del_time.shape[1]
        snaps, edges = _csr(sspec, pspec, m_cap, state)
        w_e = torch.where(edges[1], snaps.weight, 0.0)
        rowlive, owner, mine = _row_meta(state, n)
        off0 = _source_rows(sspec, state, source_key)
        row = torch.arange(n_cap, dtype=I32, device=dev)[None, :]
        dist = torch.where((row == off0) & rowlive, 0.0, INF).to(
            torch.float32)
        if warm:
            dist = torch.where(rowlive, torch.minimum(
                dist, extra[0].to(dev)), INF)
        route = _owner_value_route(sspec, state, n, owner, rowlive,
                                   frontier_budget)
        dist, it = _min_relax(dist, INF, lambda d: d + w_e, edges, route,
                              mine, max_iters)
        out = torch.where(rowlive, dist, INF)
        return (out, _iters(it, n, dev)) if warm else out

    return sssp


def make_bfs_warm(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
                  m_cap: int, max_iters: int = 32,
                  frontier_budget: Optional[int] = None):
    """Build ``bfs_warm(state, source_key, warm) -> (int32[n_shards,
    n_cap], iters)``: distributed BFS as integer min-plus relaxation
    seeded from a previous epoch's depths (``-1`` = unknown). It converges
    from any upper-bound seed (previous depths are, after an insert-only
    delta) to the true distance; depths past ``max_iters`` read -1, as the
    scratch program's level cap gives. Stub rows get the owner's depth
    every round, so parity with scratch holds at owner rows."""
    n = n_shards
    BIG = 1 << 30

    def bfs_warm(state, source_key, warm_vals):
        dev = state.vt.del_time.device
        n_cap = state.vt.del_time.shape[1]
        _snaps, edges = _csr(sspec, pspec, m_cap, state)
        rowlive, owner, mine = _row_meta(state, n)
        off0 = _source_rows(sspec, state, source_key)
        row = torch.arange(n_cap, dtype=I32, device=dev)[None, :]
        w0 = warm_vals.to(device=dev, dtype=I32)
        d = torch.where(rowlive & (w0 >= 0), w0, BIG)
        d = torch.where((row == off0) & rowlive, 0, d).to(I32)
        route = _owner_value_route(sspec, state, n, owner, rowlive,
                                   frontier_budget)
        d, it = _min_relax(d, BIG, lambda x: x.clamp_max(BIG) + 1, edges,
                           route, mine, 2 * max_iters + 2)
        out = torch.where(rowlive & (d <= max_iters), d, -1)
        return out, _iters(it, n, dev)

    return bfs_warm


def make_bc(sspec: SortSpec, pspec: ep.PoolSpec, n_shards: int,
            m_cap: int, max_depth: int = 32,
            frontier_budget: Optional[int] = None):
    """Build ``bc(state, source_keys) -> float32[n_shards, n_cap]``:
    distributed Brandes betweenness (unweighted, sampled sources). All S
    sources run together, an S column each, so each forward and backward
    level is one value exchange whatever S is. Forward: shards accumulate
    path counts along their edges, owners sum the partials, mark newly
    reached rows and send (depth, sigma) back to every copy. Backward:
    dependencies accumulate at the SOURCE rows of each shard's edges,
    owners sum, and delta goes back. Both loops run all ``max_depth``
    levels, empty ones included. Float sums: hold to 1e-5."""
    n = n_shards

    def bc(state, source_keys):
        dev = state.vt.del_time.device
        n_cap = state.vt.del_time.shape[1]
        S = source_keys.shape[0]
        snaps, (src, ok, dst) = _csr(sspec, pspec, m_cap, state)
        srcc = src.clamp(0, n_cap - 1)
        dstc = dst.clamp(0, n_cap - 1)
        rowlive, owner, mine = _row_meta(state, n)
        roffs = _source_rows(sspec, state, source_keys)        # (n, S)
        row = torch.arange(n_cap, dtype=I32, device=dev)[None, :, None]
        is_src = (row == roffs[:, None, :]) & (roffs[:, None, :] >= 0) & \
            rowlive[..., None]
        rtgt, fwd, bwd = _owner_value_route(sspec, state, n, owner, rowlive,
                                            frontier_budget)
        okS = ok[..., None]

        def owner_sum(local):
            """Per-row partials -> each owner's sum, (n, n_cap, S)."""
            return _scatter(n_cap, 0.0, rtgt, fwd(local), "sum")[:, :n_cap]

        def sync_cols(vals):
            """Owner rows -> every copy (values already merged)."""
            return bwd(torch.cat([vals, torch.zeros_like(vals[:, :1])], 1))

        depth = torch.where(is_src, 0, -1).to(I32)
        sigma = torch.where(is_src, 1.0, 0.0).to(torch.float32)
        for i in range(max_depth):
            on_lvl = _gather(depth, srcc) == i
            add_l = _scatter(n_cap, 0.0, dst, torch.where(
                okS & on_lvl, _gather(sigma, srcc), 0.0), "sum")
            add = owner_sum(add_l[:, :n_cap])
            depth = torch.where((add > 0) & (depth < 0), i + 1, depth)
            sigma = torch.where(depth == i + 1, sigma + add, sigma)
            back, okb = sync_cols(torch.cat([depth.to(torch.float32), sigma],
                                            2))
            depth = torch.where(okb[..., None], back[..., :S].to(I32), depth)
            sigma = torch.where(okb[..., None], back[..., S:], sigma)

        du, dv = _gather(depth, srcc), _gather(depth, dstc)
        ratio = _gather(sigma, srcc) / _gather(sigma, dstc).clamp_min(1.0)
        delta = torch.zeros((n, n_cap, S), dtype=torch.float32, device=dev)
        for k in range(max_depth):
            lvl = max_depth - 1 - k
            onedge = okS & (du == lvl) & (dv == lvl + 1)
            contrib = torch.where(onedge, ratio * (1.0 + _gather(delta, dstc)),
                                  0.0)
            # JAX adds every slot at its clipped source row; the padded
            # slots' contributions are 0, so they go to the dump instead
            acc_l = _scatter(n_cap, 0.0, torch.where(ok, srcc, n_cap),
                             contrib, "sum")[:, :n_cap]
            delta = delta + owner_sum(acc_l)
            back, okb = sync_cols(delta)
            delta = torch.where(okb[..., None], back, delta)
        delta = torch.where(is_src, 0.0, delta)
        return torch.where(mine, delta.sum(2), 0.0)

    return bc


def collect_owner_values(state: GraphState, values, n_shards: int) -> dict:
    """Host merge of a distributed analytics result: per-shard owner-row
    ``values`` ((n_shards, n_cap), a tensor or an array) -> ``{vertex ID:
    value}`` over every live vertex, each read from its one owner row.
    Vectorised: the owner-row mask is taken on the state's device, and
    only the owner rows' IDs come to the host for one zip."""
    from ..core.keys import unpack_keys
    _live, _owner, mine = _row_meta(state, n_shards)
    vids = unpack_keys(state.vt.ids[mine])
    if isinstance(values, torch.Tensor):
        vals = values[mine.to(values.device)].cpu().numpy()
    else:
        vals = np.asarray(values)[mine.cpu().numpy()]
    return dict(zip(vids.tolist(), vals.tolist()))
