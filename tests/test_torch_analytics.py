"""The port's analytics against the JAX package's, on the CPU.

One CSR snapshot per stream is built by the JAX package and carried to
the port with ``convert.snapshot_from_numpy``, so both sides read the
same arrays. Streams are made from a seed with numpy: a symmetric
(undirected) one and a directed one, both with 20% tombstones; the
directed one leaves vertices unreachable. JAX runs on the CPU through its
jnp paths. Every registry entry is also driven through
``make_store("local", ...)`` in both packages from one kwargs dict.

Tolerances: integer results (bfs, wcc, khop, triangle_count, degree_map,
num_edges) and sssp's float32 min-plus distances are bit-exact (atol 0:
each distance is one add and a min, exact in any order). PageRank and BC
sum floats in scatter-adds and reductions whose order differs between
XLA and PyTorch: atol 1e-5. ``pagerank_converge``'s iteration count is
compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analytics as JA
from repro.analytics.incremental import pagerank_converge as jconverge
from repro.api import AnalyticsOp as JOp
from repro.api import OpBatch as JBatch
from repro.api import make_store as jmake
from repro.core.radixgraph import RadixGraph as JG
from repro_torch import analytics as TA
from repro_torch.analytics import algorithms as talg
from repro_torch.analytics.incremental import pagerank_converge as tconverge
from repro_torch.api import (AnalyticsOp, OpBatch, analytics_spec,
                             available_analytics, make_store)
from repro_torch.convert import snapshot_from_numpy, snapshot_to_numpy

KW = dict(n_max=256, key_bits=32, expected_n=128, batch=256,
          pool_blocks=1024, block_size=8, dmax=256, k_max=32)
M_CAP = 2048
FLOAT_TOL = 1e-5


def _stream(seed, nv=100, n=700):
    rng = np.random.default_rng(seed)
    ids = rng.choice(2 ** 32, nv, replace=False).astype(np.uint64)
    s = ids[rng.integers(0, nv, n)]
    d = ids[rng.integers(0, nv - 20, n)]     # the last 20 IDs: sources only
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.random(n) < 0.2] = 0.0
    return ids, s, d, w


@pytest.fixture(scope="module", params=[True, False],
                ids=["symmetric", "directed"])
def graph(request):
    undirected = request.param
    ids, s, d, w = _stream(1 if undirected else 2)
    g = JG(undirected=undirected, **KW)
    g.apply_ops(s, d, w)
    js = g.snapshot(m_cap=M_CAP)
    ts = snapshot_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    off = g.lookup(ids)
    return dict(js=js, ts=ts, off=off, ids=ids, undirected=undirected)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b, tol=0.0):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if tol:
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(a, b)


def test_snapshot_round_trip(graph):
    back = snapshot_to_numpy(graph["ts"])
    for f, x in zip(back._fields, jax.tree.leaves(
            jax.tree.map(np.asarray, graph["js"]))):
        _same(getattr(back, f), x)


def test_csr_phases(graph):
    js, ts = graph["js"], graph["ts"]
    for a, b in zip(JA.csr_edges(js), TA.csr_edges(ts)):
        _same(a, b)
    _same(JA.edge_sources(js.indptr, M_CAP), TA.edge_sources(ts.indptr,
                                                            M_CAP))
    rng = np.random.default_rng(4)
    fr = rng.random(KW["n_max"]) < 0.15
    for impl in ("auto", "ref"):
        _same(JA.bfs_expand(js, jnp.asarray(fr)),
              TA.bfs_expand(ts, torch.from_numpy(fr), impl=impl))
    pr = rng.uniform(0, 1, KW["n_max"]).astype(np.float32)
    jc = JA.pagerank_contrib(js, jnp.asarray(pr))
    tc = TA.pagerank_contrib(ts, torch.from_numpy(pr))
    _same(jc, tc)
    _same(JA.pagerank_scatter(js, jc), TA.pagerank_scatter(ts, tc),
          FLOAT_TOL)


@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("max_iters", [64, 2])
def test_bfs(graph, impl, max_iters):
    """Every source row, including the source-only IDs of the directed
    stream (nothing reaches them) and a truncated level cap."""
    js, ts = graph["js"], graph["ts"]
    for src in (int(graph["off"][0]), int(graph["off"][-1])):
        a = JA.bfs(js, jnp.int32(src), max_iters=max_iters)
        b = TA.bfs(ts, src, max_iters=max_iters, impl=impl)
        _same(a, b)
        assert (_np(b) == -1).any()      # unreachable or truncated rows


@pytest.mark.parametrize("max_iters", [64, 2])
def test_sssp(graph, max_iters):
    js, ts = graph["js"], graph["ts"]
    src = int(graph["off"][3])
    _same(JA.sssp(js, jnp.int32(src), max_iters=max_iters),
          TA.sssp(ts, src, max_iters=max_iters))


def test_pagerank_and_converge(graph):
    js, ts = graph["js"], graph["ts"]
    _same(JA.pagerank(js, iters=20), TA.pagerank(ts, iters=20), FLOAT_TOL)
    n = KW["n_max"]
    a, ia = jconverge(js, jnp.zeros((n,)), iters=200, tol=1e-7,
                      uniform0=True)
    b, ib = tconverge(ts, torch.zeros(n), iters=200, tol=1e-7,
                      uniform0=True)
    _same(a, b, FLOAT_TOL)
    assert int(ia) == ib
    # warm start from a perturbed vector, and a cap that truncates
    pr0 = np.asarray(a) * np.float32(1.01)
    a, ia = jconverge(js, jnp.asarray(pr0), iters=3, tol=1e-7)
    b, ib = tconverge(ts, torch.from_numpy(pr0), iters=3, tol=1e-7)
    _same(a, b, FLOAT_TOL)
    assert int(ia) == ib == 3


@pytest.mark.parametrize("max_iters", [64, 1])
def test_wcc(graph, max_iters):
    _same(JA.wcc(graph["js"], max_iters=max_iters),
          TA.wcc(graph["ts"], max_iters=max_iters))


def test_triangle_count(graph):
    a = JA.triangle_count(graph["js"])
    b = TA.triangle_count(graph["ts"])
    _same(a, b)
    if graph["undirected"]:
        assert int(b) > 0


def test_bc(graph):
    srcs = graph["off"][[0, 5, 9, 5]].astype(np.int32)   # a repeated source
    _same(JA.bc(graph["js"], jnp.asarray(srcs)),
          TA.bc(graph["ts"], torch.from_numpy(srcs)), FLOAT_TOL)


@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_khop(graph, impl, k):
    srcs = graph["off"][[0, 1, 50, 99]].astype(np.int32)
    _same(JA.khop(graph["js"], jnp.asarray(srcs), k=k),
          TA.khop(graph["ts"], torch.from_numpy(srcs), k=k, impl=impl))


# ---- every registry entry through make_store in both packages ----

def _registry_ops(ids, absent):
    src = int(ids[0])
    return [
        ("bfs", dict(source=src)),
        ("bfs", dict(source=absent)),                     # absent source
        ("bfs", dict(source=src, max_iters=2)),
        ("pagerank", dict(iters=20)),
        ("pagerank", dict(iters=200, tol=1e-7)),
        ("wcc", {}),
        ("sssp", dict(source=src)),
        ("sssp", dict(source=absent)),
        ("bc", dict(sources=np.array([ids[0], absent, ids[7]], np.uint64))),
        ("khop", dict(sources=np.array([ids[2], absent, ids[0]], np.uint64),
                      k=2)),
        ("triangle_count", {}),
        ("degree_map", {}),
        ("num_edges", {}),
    ]


@pytest.fixture(scope="module")
def stores():
    ids, s, d, w = _stream(3)
    kw = dict(m_cap=M_CAP, undirected=True, **KW)
    js, ts = jmake("local", **kw), make_store("local", device="cpu", **kw)
    js.apply(JBatch.edges(s, d, w))
    ts.apply(OpBatch.edges(s, d, w))
    return js, ts, ids


def _same_value(a, b, tol):
    if isinstance(a, dict):
        assert set(a) == set(b)
        ks = sorted(a)
        va = np.array([a[k] for k in ks])
        vb = np.array([b[k] for k in ks])
        assert va.dtype == vb.dtype
        np.testing.assert_allclose(va, vb, rtol=0, atol=tol)
    elif isinstance(a, np.ndarray):
        _same(a, b, tol)
    else:
        assert type(a) is type(b) and a == b


def test_registry_matches_jax(stores):
    js, ts, ids = stores
    assert available_analytics() == sorted(
        ["bfs", "pagerank", "wcc", "sssp", "bc", "khop", "triangle_count",
         "degree_map", "num_edges"])
    from repro.api.registry import available_analytics as javailable
    assert available_analytics(distributed=True) == \
        javailable(distributed=True)
    assert available_analytics(distributed=False) == ["triangle_count"]
    absent = 12345          # never inserted
    assert absent not in set(ids.tolist())
    for name, params in _registry_ops(ids, absent):
        a = js.analytics_result(JOp(name, params), js.capture())
        b = ts.analytics_result(AnalyticsOp(name, params), ts.capture())
        tol = FLOAT_TOL if name in ("pagerank", "bc") else 0.0
        _same_value(a.value, b.value, tol)
        assert (a.mode, a.iters, a.reason, a.epoch) == \
            (b.mode, b.iters, b.reason, b.epoch), name
        if a.raw is None:
            assert b.raw is None
        elif isinstance(a.raw, np.ndarray):
            _same(a.raw, b.raw, tol)
        else:
            assert a.raw == b.raw


def test_wcc_canonical_labels(stores):
    js, ts, ids = stores
    a = js.analytics_result(JOp("wcc", {}))
    b = ts.analytics_result(AnalyticsOp("wcc", {}))
    assert b.raw.dtype == np.uint64
    _same(a.raw, b.raw)
    # each label is the minimum member ID of its component
    labels = np.array([b.value[int(v)] for v in ids if int(v) in b.value],
                      np.uint64)
    members = np.array([int(v) for v in ids if int(v) in b.value],
                       np.uint64)
    for lab in np.unique(labels):
        assert members[labels == lab].min() == lab


def test_spec_fields_match_jax():
    from repro.api.registry import analytics_spec as jspec
    for name in available_analytics():
        a, b = jspec(name), analytics_spec(name)
        assert (a.dyn, a.result, a.absent) == (b.dyn, b.result, b.absent)
        assert (a.advance is None) == (b.advance is None)
        assert (a.warm_guard is None) == (b.warm_guard is None)
        assert (a.canonical_single is None) == (b.canonical_single is None)
        assert (a.make_dist is None) == (b.make_dist is None), name
        assert (a.make_dist_warm is None) == (b.make_dist_warm is None), \
            name
        flags = dict(has_deletes=True, has_weight_increase=True)
        if a.warm_guard is not None:
            for f in (flags, dict(flags, has_deletes=False),
                      dict(has_deletes=False, has_weight_increase=False)):
                assert a.warm_guard(f) == b.warm_guard(f)


def test_algorithms_run_on_the_snapshot_device(graph):
    """Outputs stay on the snapshot's device, and each level loop counts
    one host fetch per level."""
    ts = graph["ts"]
    before = dict(talg.HOST_SYNCS)
    depth = TA.bfs(ts, int(graph["off"][0]))
    levels = int(depth.max())
    assert depth.device == ts.dst.device
    # one fetch per expansion (the last one finds no new row), plus the
    # one that finds the frontier empty
    assert talg.HOST_SYNCS["bfs"] - before["bfs"] == levels + 2
    for out in (TA.sssp(ts, 0), TA.wcc(ts), TA.pagerank(ts, iters=2),
                TA.khop(ts, torch.tensor([0, 1]))):
        assert out.device == ts.dst.device
