"""The port's kernel functions against the JAX package's oracles.

Inputs are made from a seed with numpy and handed to both sides. The
plain PyTorch versions (what the wrappers run on CPU tensors) are held to
the jnp oracles of ``repro.kernels.ref`` over the sweeps of
``tests/test_kernels.py``. Every compared output is an integer or a copied
float, so the tolerance is bit-exact (atol = 0). Frontier bitmaps cross
as JAX uint32 words and port int32 words with the same bits
(``np.ndarray.view``).

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sort as S
from repro.core.keys import pack_keys
from repro.core.sort import SortSpec
from repro.core.sort_optimizer import optimize_sort
from repro.kernels import ref as R
from _kernel_cases import (APPEND_ARGS, APPEND_CASES, COMPACT_CASES,
                           DEFRAG_CASES, WIDE_CASES, WIDE_WIDTHS,
                           append_case, edge_pool_append_calls, rows_case,
                           wide_rows_case, writes_outside_probes)
from repro_torch.core.keys import pack_keys as tpack_keys
from repro_torch.kernels import ops as tops
from repro_torch.kernels.append import append_edges, append_edges_plain
from repro_torch.kernels.compact import (compact_rows, compact_rows_plain,
                                         defrag_rows, defrag_rows_plain)
from repro_torch.kernels.frontier import (frontier_expand,
                                          frontier_expand_plain, pack_bits,
                                          unpack_bits)
from repro_torch.kernels.sort_lookup import sort_lookup_plain


def _eq(a, b):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) and
                   a.dtype == torch.bfloat16 else a)
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) and
                   b.dtype == torch.bfloat16 else b)
    if a.dtype == jnp.bfloat16:
        a = a.astype(np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _rows(seed, K, D, n_cap=64):
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, n_cap, (K, D)).astype(np.int32)
    w = np.round(rng.uniform(0, 2, (K, D))).astype(np.float32)
    ts = rng.permutation(K * D).reshape(K, D).astype(np.int32)
    size = rng.integers(0, D + 1, (K,)).astype(np.int32)
    return dst, w, ts, size


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


@pytest.mark.parametrize("K,D", [(1, 8), (3, 16), (5, 64), (2, 128)])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_compact_rows_plain_sweep(K, D, wdtype):
    dst, w, ts, size = _rows(K * 1000 + D, K, D)
    a = R.compact_rows_ref(jnp.asarray(dst), jnp.asarray(w, wdtype),
                           jnp.asarray(ts), jnp.asarray(size))
    td, tw, tt, tz = _t(dst, w, ts, size)
    b = compact_rows_plain(td, tw.to(getattr(torch, wdtype)), tt, tz)
    assert b[1].dtype == getattr(torch, wdtype)
    for x, y in zip(a, b):
        _eq(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compact_rows_plain_read_ts(seed):
    rng = np.random.default_rng(seed)
    K, D = 2, 32
    dst = rng.integers(-1, 32, (K, D)).astype(np.int32)
    w = np.round(rng.uniform(0, 2, (K, D))).astype(np.float32)
    ts = rng.permutation(K * D).reshape(K, D).astype(np.int32)
    size = np.minimum(int(rng.integers(1, 65)), D) * np.ones(K, np.int32)
    rt = int(rng.integers(0, K * D))
    a = R.compact_rows_ref(*map(jnp.asarray, (dst, w, ts, size)), read_ts=rt)
    b = compact_rows_plain(*_t(dst, w, ts, size), read_ts=rt)
    for x, y in zip(a, b):
        _eq(x, y)


@pytest.mark.parametrize("K,D", [(1, 8), (4, 16), (3, 64), (2, 128)])
@pytest.mark.parametrize("keep_all", [False, True])
def test_defrag_rows_plain_sweep(K, D, keep_all):
    dst, w, ts, size = _rows(K * 7 + D, K, D)
    a = R.defrag_rows_ref(*map(jnp.asarray, (dst, w, ts, size)),
                          keep_all=keep_all)
    b = defrag_rows_plain(*_t(dst, w, ts, size), keep_all=keep_all)
    for x, y in zip(a, b):
        _eq(x, y)


def test_defrag_rows_keep_all_orders_by_dst_then_pos():
    dst = np.array([[3, 1, 3, 2, 1, -1]], np.int32)
    w = np.array([[1.0, 0.0, 2.0, 1.0, 5.0, 9.0]], np.float32)
    ts = np.array([[1, 2, 3, 4, 5, 6]], np.int32)
    size = np.array([5], np.int32)
    d, ww, tt, cnt, live = defrag_rows_plain(*_t(dst, w, ts, size),
                                             keep_all=True)
    assert int(cnt[0]) == 5 and int(live[0]) == 3
    assert d[0, :5].tolist() == [1, 1, 2, 3, 3]
    assert ww[0, :5].tolist() == [0.0, 5.0, 1.0, 1.0, 2.0]


def _append_inputs(seed, NB=32, BS=8, B=24, corner=False):
    """The sweep of tests/test_kernels.py, with distinct write slots (the
    edge pool never lands two ops on one slot). ``corner`` confines probe
    extents to rows [0, 8) and slots to rows [8, 16): the bounded-tile
    case, with appends after the extent end."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, 16, (NB, BS)).astype(np.int32)
    w = np.round(rng.uniform(0, 2, (NB, BS))).astype(np.float32)
    ts = (rng.permutation(NB * BS).reshape(NB, BS) + 1).astype(np.int32)
    if corner:
        flat = rng.choice(8 * BS, B, replace=False) + 8 * BS
        pstart = rng.integers(-1, 8, B).astype(np.int32)
        psize = rng.integers(0, BS + 1, B).astype(np.int32)
    else:
        flat = rng.choice(NB * BS, B, replace=False)
        pstart = rng.integers(-1, NB, B).astype(np.int32)
        psize = rng.integers(0, 3 * BS, B).astype(np.int32)
    wblk = (flat // BS).astype(np.int32)
    wlane = (flat % BS).astype(np.int32)
    wval = rng.random(B) < 0.7
    wd = rng.integers(0, 16, B).astype(np.int32)
    ww = np.round(rng.uniform(0, 2, B)).astype(np.float32)
    wts = (rng.permutation(B) + 1000).astype(np.int32)
    pv = rng.integers(-1, 16, B).astype(np.int32)
    return (dst, w, ts, wblk, wlane, wval, wd, ww, wts, pstart, psize, pv)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("corner", [False, True])
def test_append_plain_matches_oracle(seed, corner):
    """Pool contents after the scatter AND per-probe was_live, bit-exact
    against ``append_ref``; the plain version updates the pools in place."""
    args = _append_inputs(seed, corner=corner)
    nd, nw, nt, was = R.append_ref(*map(jnp.asarray, args))
    targs = _t(*args)
    was_t = append_edges_plain(*targs)
    for x, y in zip((nd, nw, nt, was), (targs[0], targs[1], targs[2],
                                        was_t)):
        _eq(x, y)


# ---- edge cases of tests/_kernel_cases.py (the card's cases too) ----

@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_rows_plain_edge_cases(case):
    """Occupancies around the warp and block paths of the kernel, size >
    D, one repeated dst, only tombstones, dsts at multiples of the table
    sizes, dst 2^30 - 1 (and 2^30 up: empty), the read_ts filter, bfloat16
    weights, D = 8192 and MAX_ROW_WIDTH."""
    c = rows_case(case)
    wd = c["wdtype"]
    a = R.compact_rows_ref(jnp.asarray(c["dst"]), jnp.asarray(c["w"], wd),
                           jnp.asarray(c["ts"]), jnp.asarray(c["size"]),
                           read_ts=c["read_ts"])
    td, tw, tt, tz = _t(c["dst"], c["w"], c["ts"], c["size"])
    b = compact_rows_plain(td, tw.to(getattr(torch, wd)), tt, tz,
                           read_ts=c["read_ts"])
    for x, y in zip(a, b):
        _eq(x, y)


@pytest.mark.parametrize("case", DEFRAG_CASES)
@pytest.mark.parametrize("keep_all", [False, True])
def test_defrag_rows_plain_edge_cases(case, keep_all):
    c = rows_case(case)
    args = (c["dst"], c["w"], c["ts"], c["size"])
    a = R.defrag_rows_ref(*map(jnp.asarray, args), keep_all=keep_all)
    b = defrag_rows_plain(*_t(*args), keep_all=keep_all)
    for x, y in zip(a, b):
        _eq(x, y)


@pytest.mark.parametrize("case", WIDE_CASES)
@pytest.mark.parametrize("D", WIDE_WIDTHS)
@pytest.mark.parametrize("keep_all", [False, True])
def test_defrag_rows_plain_wide_rows(case, D, keep_all):
    """Rows past 16,384 entries (the kernel's sorted runs and merges): one
    hub destination rewritten thousands of times, tombstones only,
    occupancy far below the width, repeated destinations, bfloat16."""
    c = wide_rows_case(case, D)
    wd = c["wdtype"]
    a = R.defrag_rows_ref(jnp.asarray(c["dst"]), jnp.asarray(c["w"], wd),
                          jnp.asarray(c["ts"]), jnp.asarray(c["size"]),
                          keep_all=keep_all)
    td, tw, tt, tz = _t(c["dst"], c["w"], c["ts"], c["size"])
    b = defrag_rows_plain(td, tw.to(getattr(torch, wd)), tt, tz,
                          keep_all=keep_all)
    for x, y in zip(a, b):
        _eq(x, y)


@pytest.mark.parametrize("case", APPEND_CASES)
def test_append_plain_edge_cases(case):
    """No probes, no ops, both, out-of-range and negative (wrapping) write
    indices, a block size that is not a multiple of 4, extents that end
    at the pool's last block and probes past it; pools and was_live
    bit-exact against ``append_ref``."""
    args = [append_case(case)[k] for k in APPEND_ARGS]
    nd, nw, nt, was = R.append_ref(*map(jnp.asarray, args))
    targs = _t(*args)
    was_t = append_edges_plain(*targs)
    for x, y in zip((nd, nw, nt, was), (*targs[:3], was_t)):
        _eq(x, y)


def test_append_plain_on_edge_pool_calls():
    """The edge pool's own append calls (tombstones, hubs, a rebuild):
    every landing write lies outside every probed extent, the condition
    of the kernel's single launch, and the plain version matches
    ``append_ref`` bit-exactly on each call."""
    calls = edge_pool_append_calls("cpu")
    assert len(calls) >= 8
    for c in calls:
        assert writes_outside_probes(c)
        args = [c[k] for k in APPEND_ARGS]
        nd, nw, nt, was = R.append_ref(*map(jnp.asarray, args))
        targs = _t(*args)
        was_t = append_edges_plain(*targs)
        for x, y in zip((nd, nw, nt, was), (*targs[:3], was_t)):
            _eq(x, y)


def test_writes_outside_probes_sees_a_write_in_a_probed_extent():
    c = append_case("extents")
    assert writes_outside_probes(c)
    q = int(np.flatnonzero((c["pstart"] >= 0) & (c["pv"] >= 0) &
                           (c["psize"] > 0))[0])
    c["wblk"][0], c["wlane"][0], c["wval"][0] = c["pstart"][q], 0, True
    assert not writes_outside_probes(c)


@pytest.mark.parametrize("n", [128, 500])
def test_sort_lookup_plain_matches_oracle(n):
    rng = np.random.default_rng(n)
    cfg = optimize_sort(n, 32, 5)
    spec = SortSpec.from_config(cfg, 2 * n)
    stt = S.make_sort(spec)
    ids = rng.choice(2 ** 32, n, replace=False).astype(np.uint64)
    stt = S.insert_mappings(spec, stt, pack_keys(ids, 32),
                            jnp.arange(n, dtype=jnp.int32),
                            jnp.ones(n, bool))
    q = np.concatenate([ids, rng.choice(2 ** 32, 256).astype(np.uint64)])
    a = R.sort_lookup_ref(stt.pools, stt.counts, pack_keys(q, 32),
                          fanout_bits=spec.fanout_bits,
                          bit_offsets=spec.bit_offsets)
    pools = [torch.from_numpy(np.array(p)) for p in stt.pools]
    b = sort_lookup_plain(pools, tpack_keys(q, 32, "cpu"),
                          fanout_bits=spec.fanout_bits,
                          bit_offsets=spec.bit_offsets)
    _eq(a, b)
    assert (b[:n] >= 0).all()


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    dst, w, ts, size = _rows(9, 3, 32)
    td, tw, tt, tz = _t(dst, w, ts, size)
    for x, y in zip(compact_rows(td, tw, tt, tz),
                    compact_rows_plain(td, tw, tt, tz)):
        _eq(x, y)
    for x, y in zip(defrag_rows(td, tw, tt, tz, keep_all=True),
                    defrag_rows_plain(td, tw, tt, tz, keep_all=True)):
        _eq(x, y)
    args_a = _t(*_append_inputs(5))
    args_b = [t.clone() for t in args_a]
    _eq(append_edges(*args_a), append_edges_plain(*args_b))
    for x, y in zip(args_a[:3], args_b[:3]):
        _eq(x, y)
    before, calls = tops.launch_counts(), tops.call_counts()
    tops.compact_rows(td, tw, tt, tz)
    assert tops.launch_counts() == before   # no kernel launched on the CPU
    assert tops.call_counts() == calls
    with pytest.raises(ValueError):
        tops.compact_rows(td, tw, tt, tz, impl="bogus")


# ---- frontier: bitmaps cross as JAX uint32 <-> port int32, same bits ----

def _frontier_inputs(seed, NB=32, BS=8, n=128, lo=-1, hi=None):
    rng = np.random.default_rng(seed)
    W = n // 32
    hi = n if hi is None else hi
    owner = rng.integers(lo, hi, NB).astype(np.int32)
    dst = rng.integers(lo, hi, (NB, BS)).astype(np.int32)
    valid = rng.random((NB, BS)) < 0.5
    f = rng.integers(0, 2 ** 32, W, dtype=np.uint32)
    v = rng.integers(0, 2 ** 32, W, dtype=np.uint32)
    return owner, dst, valid, f, v


def _frontier_both(owner, dst, valid, f, v):
    a = R.frontier_ref(*map(jnp.asarray, (owner, dst, valid, f, v)))
    b = frontier_expand_plain(*_t(owner, dst, valid, f.view(np.int32),
                                  v.view(np.int32)))
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(a), b.numpy().view(np.uint32))
    return b


@pytest.mark.parametrize("seed", range(8))
def test_frontier_plain_matches_oracle(seed):
    """The sweep of tests/test_kernels.py: NB 32, BS 8, n 128, random
    bitmaps."""
    _frontier_both(*_frontier_inputs(seed))


@pytest.mark.parametrize("case", ["owner_past_bitmap", "dst_past_bitmap",
                                  "negative_owner", "negative_dst"])
def test_frontier_plain_edge_cases(case):
    """The oracle's rules where the Pallas kernel would read or write out
    of bounds: an owner >= 32 W is clipped to the last bit, a dst >= 32 W
    is dropped, an owner < 0 never expands."""
    owner, dst, valid, f, v = _frontier_inputs(11)
    valid[:] = True
    v[:] = 0
    f[:] = 0xFFFFFFFF
    W = f.shape[0]
    if case == "owner_past_bitmap":
        owner[:] = 32 * W + 5
        f[-1] = 0x7FFFFFFF                       # last bit clear: nothing
        assert not _frontier_both(owner, dst, valid, f, v).any()
        f[-1] = 0x80000000                       # last bit set: everything
        assert _frontier_both(owner, dst, valid, f, v).any()
    elif case == "dst_past_bitmap":
        dst[:] = 32 * W + np.arange(dst.size).reshape(dst.shape) % 7
        dst[0, 0] = 3
        out = _frontier_both(owner.clip(0), dst, valid, f, v)
        assert out.tolist() == [8] + [0] * (W - 1)
    elif case == "negative_owner":
        owner[:] = -1
        assert not _frontier_both(owner, dst, valid, f, v).any()
    else:
        dst[:] = -5
        assert not _frontier_both(owner, dst, valid, f, v).any()


def test_frontier_csr_view_matches_bfs_hop():
    """The (m_cap, 1) view of a CSR: one entry a block, owner =
    edge_sources; one expansion equals the jnp hop of ``bfs`` with
    visited = the frontier itself."""
    from repro.analytics import algorithms as JA
    rng = np.random.default_rng(5)
    n, m_cap, m = 96, 512, 400
    deg = rng.multinomial(m, np.ones(n) / n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    dst = np.full(m_cap, -1, np.int32)
    dst[:m] = rng.integers(0, n, m)
    fr = rng.random(n) < 0.2
    src = np.array(JA.edge_sources(jnp.asarray(indptr), m_cap))
    ok = np.arange(m_cap) < m
    W = (n + 31) // 32
    fbits = pack_bits(torch.from_numpy(fr), W)
    out = frontier_expand_plain(torch.from_numpy(src),
                                torch.from_numpy(dst[:, None].copy()),
                                torch.from_numpy(ok[:, None].copy()),
                                fbits, fbits)
    hit = np.zeros(n + 1, bool)
    live = ok & fr[np.clip(src, 0, n - 1)]
    hit[np.where(live, np.where(ok, dst, n), n)] = True
    want = hit[:n] & ~fr
    np.testing.assert_array_equal(unpack_bits(out, n).numpy(), want)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 128])
def test_pack_bits_matches_jax_bit_patterns(n):
    rng = np.random.default_rng(n)
    b = rng.random(n) < 0.5
    b[-1] = True                                 # bit 31 of a word set
    W = (n + 31) // 32
    pad = np.zeros(32 * W, bool)
    pad[:n] = b
    want = jnp.sum(jnp.asarray(pad.reshape(W, 32), jnp.uint32)
                   << jnp.arange(32, dtype=jnp.uint32), axis=1,
                   dtype=jnp.uint32)
    got = pack_bits(torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (W,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    np.testing.assert_array_equal(unpack_bits(got, n).numpy(), b)
    words = rng.integers(0, 2 ** 32, W, dtype=np.uint32)
    words[0] |= np.uint32(1 << 31)
    bits = unpack_bits(torch.from_numpy(words.view(np.int32)), 32 * W)
    np.testing.assert_array_equal(
        bits.numpy(), ((words[:, None] >> np.arange(32, dtype=np.uint32))
                       & 1).reshape(-1).astype(bool))


def test_frontier_wrapper_runs_the_plain_version_on_cpu_tensors():
    args = _t(*_frontier_inputs(3)[:3])
    f, v = (torch.from_numpy(x.view(np.int32)) for x in
            _frontier_inputs(3)[3:])
    before = tops.launch_counts()
    for impl in ("auto", "pallas", "ref"):
        assert torch.equal(tops.frontier_expand(*args, f, v, impl=impl),
                           frontier_expand_plain(*args, f, v))
    assert torch.equal(frontier_expand(*args, f, v),
                       frontier_expand_plain(*args, f, v))
    assert "frontier_expand" in before
    assert tops.launch_counts() == before   # no kernel launched on the CPU
