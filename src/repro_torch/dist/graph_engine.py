"""Vertex-space sharding of RadixGraph (port of ``repro.dist.graph_engine``:
the engine, ingest and reads).

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
* a replicated decision (``_route_overflow``'s ``psum`` feeding a
  ``lax.cond``) is one fetch of an ``any`` over all shards, counted in
  ``edgepool.SYNCS["host_syncs"]``.

Like the port's single-shard ``step_*`` functions, the engine updates the
state it is given IN PLACE and returns it: each shard runs on views
``leaf[s]`` of the stacked tensors, and a leaf the step replaced (a scalar
such as ``clock + B``, the pool's tensors after a rebuild) is copied back
into slot ``s``. Callers that must keep the old state copy it first
(``radixgraph.clone_state``), as ``ShardedStore`` does for a captured
epoch.

Keys are ``(..., 2)`` int64 words masked to 32 bits (uint32 in the JAX
package); the hash masks after every multiply and shift, so it matches
JAX's wrapping uint32 arithmetic bit for bit. A routed payload is an int64
word matrix; the weight rides as its float32 bits.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import resolve_device
from ..core import edgepool as ep
from ..core import radixgraph as rg
from ..core import sort as sort_mod
from ..core import vertex_table as vt_mod
from ..core.radixgraph import GraphState
from ..core.sort import SortSpec
from ..core.tensor_ops import I32, I64

__all__ = ["shard_of_keys", "make_sharded_state", "make_apply_edges",
           "make_apply_edges_pipelined", "make_sync_vertices",
           "make_snapshot", "make_khop_counts", "make_degree_map",
           "make_num_edges", "shard_view", "put_shard", "ROUTES"]

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
    axis: (n_src, n_dst, ...) -> (n_dst, n_src, ...)."""
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
    return bool(ep._fetch(over)[0])


def _route_dense(owner, mask, payload, n: int, cap: int):
    """Lossless dense route: ``cap`` rows per destination, validity as a
    trailing column. Returns per receiver (rows (n, n*cap, C), valid)."""
    S, _, C = payload.shape
    slot, ok = _bucket_slots(owner, mask, cap)
    p = torch.cat([payload, ok.to(I64)[..., None]], dim=2)
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
    """float32 -> its bits as an int64 word in [0, 2^32)."""
    return w.contiguous().view(I32).to(I64) & _M32


def _bits_f32(x: torch.Tensor) -> torch.Tensor:
    """An int64 word in [0, 2^32) -> the float32 with those bits."""
    x = x & _M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32).view(
        torch.float32)


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
            payload = torch.stack([sk[..., 0], sk[..., 1], dk[..., 0],
                                   dk[..., 1], _f32_bits(w)], dim=-1)
            rows, valid = _route(owner, mask, payload, n, Bl, route_budget)
            return _apply_rows(sspec, pspec, state, rows[..., 0:2],
                               rows[..., 2:4], _bits_f32(rows[..., 4]), valid)
        slot, ok = _bucket_slots(owner, mask, cap)
        route_drop = (mask & ~ok).to(I32).sum(dim=1, dtype=I32)
        NC = n * cap
        tgt = torch.where(ok, slot, NC)

        def xch(x, fill):
            buf = _scatter_rows(x, tgt, NC, fill)
            return _all_to_all(buf.reshape((n, n, cap) + x.shape[2:])
                               ).reshape((n, NC) + x.shape[2:])

        if pack:
            payload = torch.stack([sk[..., 0], sk[..., 1], dk[..., 0],
                                   dk[..., 1], _f32_bits(w), ok.to(I64)],
                                  dim=-1)                 # (n, Bl, 6)
            r = xch(payload, 0)
            rsk, rdk = r[..., 0:2], r[..., 2:4]
            rw, rmask = _bits_f32(r[..., 4]), r[..., 5] == 1
        else:
            rsk, rdk, rw = xch(sk, 0), xch(dk, 0), xch(w, 0.0)
            rmask = xch(ok.to(I64), 0) == 1
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
        rows, valid = _route(owner, rowlive, ids.to(I64), n, n_cap, budget)
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
                     frontier_budget: Optional[int] = None):
    """Build ``khop(state, query_keys) -> int32[Q]`` for ``k == 1`` with
    ``m_cap=None``: live out-degree straight off the owner's edge array (0
    for absent vertices), queries routed to their owners and the answers
    routed back. The frontier rounds (``k > 1``, or ``m_cap`` set) come
    with the sharded analytics, not ported yet: they raise."""
    n = n_shards
    if not (k == 1 and m_cap is None):
        raise NotImplementedError(
            "sharded k-hop frontier rounds (k > 1, or k == 1 with m_cap) "
            "are not ported yet; k == 1 without m_cap answers degrees")

    def khop(state, query_keys):
        Q = query_keys.shape[0]
        assert Q % n == 0, f"query batch {Q} not divisible by {n} shards"
        Ql = Q // n
        qk = query_keys.reshape(n, Ql, 2).to(I64)
        owner = shard_of_keys(qk, n)
        slot, _ = _bucket_slots(owner, torch.ones_like(owner, dtype=bool),
                                Ql)
        buf = _scatter_rows(qk, slot, n * Ql, 0)
        recv = _all_to_all(buf.reshape(n, n, Ql, 2)).reshape(n, n * Ql, 2)
        # unrouted slots hold key 0: their answers are never read back
        cnt = torch.stack([rg.step_degree_counts(
            sspec, pspec, shard_view(state, s), recv[s], read_ts=read_ts)
            for s in range(n)])
        back = _all_to_all(cnt.reshape(n, n, Ql)).reshape(n, n * Ql)
        return torch.gather(back, 1, slot.to(I64)).reshape(-1)

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

