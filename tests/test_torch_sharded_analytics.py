"""Sharded analytics through the store: the port's ``ShardedStore``
(``make_store("sharded")``) against the JAX package's, and against the
port's own ``LocalStore``.

The JAX stores need 2 devices: one subprocess, started by a module-scoped
fixture with ``--xla_force_host_platform_device_count=2`` set before JAX
touches a device, runs this file as a script and writes one ``.npz``. The
port runs in this process on the CPU (``device="cpu"``). Both packages'
stores are built from ONE kwargs dict and take the same ops.

Three scenarios, each the sharded part of a JAX test:

* ``dist``: the distributed BFS and PageRank of
  ``tests/test_dist.py::test_distributed_analytics_subprocess`` (a mixed
  stream with 10% tombstones), through the stores;
* ``cross``: ``tests/test_api.py::test_cross_backend_parity_subprocess``,
  every registered analytics with a sharded program (BFS, PageRank, WCC,
  SSSP, BC, k-hop with k = 1, 2, 3, an absent BFS source, the degree map
  and the edge count), the local and the sharded backend answering alike;
* ``advance``: ``tests/test_incremental.py::
  test_sharded_advance_parity_subprocess``, warm sharded programs and
  per-shard host advances over two clean epochs and a delete epoch: the
  same path (incremental or scratch) with the same reason as JAX, the
  answers equal to scratch.

Tolerances: integers, depths, labels, distances, modes, reasons and
iteration counts exact; PageRank and BC within 1e-5 (relative, floored at
1, as the JAX cross-backend test holds them), since float sums are
associated differently. The stores' extents stay inside the JAX store's
CPU probe window, where the two append paths agree.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
FLOATS = ("pagerank", "bc")

DIST_KW = dict(n_shards=2, n_per_shard=1024, expected_n=256,
               pool_blocks=1024, block_size=8, k_max=32, dmax=256,
               batch=1024, query_batch=64, m_cap=4096)
CROSS_KW = dict(n_shards=2, n_per_shard=2048, expected_n=256,
                pool_blocks=8192, block_size=8, dmax=512, k_max=64,
                batch=512, query_batch=64)
LOCAL_KW = dict(n_max=2048, key_bits=32, expected_n=256, batch=512,
                pool_blocks=8192, block_size=8, dmax=512, k_max=64)
ADV_KW = dict(n_shards=2, n_per_shard=2048, expected_n=256,
              pool_blocks=4096, block_size=16, k_max=64, dmax=512,
              batch=128, query_batch=64, m_cap=4096, max_delta_frac=0.9)
ADV_EPOCHS = ("clean0", "clean1", "deletes")


def _dist_stream():
    rng = np.random.default_rng(1)
    ids = rng.choice(2 ** 32, 120, replace=False).astype(np.uint64)
    B = 1024
    src, dst = rng.choice(ids, B), rng.choice(ids, B)
    w = rng.uniform(0.5, 2, B).astype(np.float32)
    w[rng.random(B) < 0.1] = 0.0
    return ids, src, dst, w


def _cross_stream():
    rng = np.random.default_rng(3)
    ids = rng.choice(2 ** 32, 80, replace=False).astype(np.uint64)
    B = 600
    s0, d0 = rng.choice(ids, B // 2), rng.choice(ids, B // 2)
    src, dst = np.concatenate([s0, d0]), np.concatenate([d0, s0])
    wh = rng.uniform(0.5, 2, B // 2).astype(np.float32)
    w = np.concatenate([wh, wh])
    w[rng.random(B) < 0.1] = 0.0
    return ids, src, dst, w


def _cross_ops(A, ids, src):
    """(key, AnalyticsOp) of the cross-backend scenario."""
    ops = [("bfs", A("bfs", {"source": int(src[0]), "max_iters": 64})),
           ("pagerank", A("pagerank", {"iters": 15})),
           ("pagerank_tol", A("pagerank", {"iters": 15, "tol": 1e-6})),
           ("wcc", A("wcc")),
           ("sssp", A("sssp", {"source": int(src[0]), "max_iters": 64})),
           ("bc", A("bc", {"sources": ids[:8], "max_depth": 16})),
           ("bfs_ghost", A("bfs", {"source": 123456789})),
           ("degree_map", A("degree_map")),
           ("num_edges", A("num_edges"))]
    ops += [(f"khop{k}", A("khop", {"sources": ids[:16], "k": k}))
            for k in (1, 2, 3)]
    return ops


def _sym(s, d, w):
    return (np.concatenate([s, d]), np.concatenate([d, s]),
            np.concatenate([w, w]))


def _advance_run(make_store, OpBatch, A, record):
    """The advance scenario on one package's sharded store; ``record(
    epoch, key, advanced, scratch)`` sees every advance beside a scratch
    run at the same epoch."""
    rng = np.random.default_rng(23)
    store = make_store("sharded", **ADV_KW)
    ids = rng.choice(2 ** 32, 64, replace=False).astype(np.uint64)
    s = ids[rng.integers(0, 64, 400)]
    d = ids[rng.integers(0, 64, 400)]
    w = rng.uniform(1.0, 2.0, 400).astype(np.float32)
    store.apply(OpBatch.edges(*_sym(s, d, w)))
    ops = [("pagerank", A("pagerank", dict(iters=200, tol=1e-7))),
           ("pagerank_fixed", A("pagerank", dict(iters=20))),
           ("wcc", A("wcc", {})),
           ("bfs", A("bfs", dict(source=int(ids[0])))),
           ("sssp", A("sssp", dict(source=int(ids[0])))),
           ("khop", A("khop", dict(sources=ids[:8], k=2))),
           ("degree_map", A("degree_map", {})),
           ("num_edges", A("num_edges", {}))]
    ep = store.capture()
    warm = {k: store.analytics_result(o, ep) for k, o in ops}
    for k in range(2):                      # clean monotone epochs
        lo, hi = 0.5 * 0.5 ** k, 0.9 * 0.5 ** k
        s = ids[rng.integers(0, 64, 20)]
        d = ids[rng.integers(0, 64, 20)]
        w = rng.uniform(lo, hi, 20).astype(np.float32)
        store.apply(OpBatch.edges(*_sym(s, d, w)))
        cur = store.capture()
        for key, o in ops:
            ri = store.analytics_advance(o, warm[key], cur)
            record(ADV_EPOCHS[k], key, ri, store.analytics_result(o, cur))
            warm[key] = ri
    store.apply(OpBatch.edges(*_sym(s[:4], d[:4],       # delete epoch
                                    np.zeros(4, np.float32))))
    cur = store.capture()
    for key, o in ops:
        ri = store.analytics_advance(o, warm[key], cur)
        record("deletes", key, ri, store.analytics_result(o, cur))


def _flat(v):
    """An answer as named numpy arrays: a per-vertex dict as sorted IDs
    and values, anything else as one array."""
    if isinstance(v, dict):
        ks = sorted(v)
        return {"ids": np.array(ks, np.uint64),
                "vals": np.array([v[k] for k in ks])}
    return {"v": np.asarray(v)}


# --------------------------------------------------------------------------
# the JAX reference (run as a script in a subprocess)
# --------------------------------------------------------------------------

def _reference(out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    from repro.api import AnalyticsOp, OpBatch, make_store
    out = {}

    def put(prefix, v):
        for k, a in _flat(v).items():
            out[f"{prefix}/{k}"] = a

    ids, src, dst, w = _dist_stream()
    js = make_store("sharded", **DIST_KW)
    assert js.apply(OpBatch.edges(src, dst, w)).dropped == 0
    put("dist/bfs", js.analytics(AnalyticsOp(
        "bfs", {"source": int(src[0]), "max_iters": 32})))
    put("dist/pagerank", js.analytics(AnalyticsOp("pagerank",
                                                  {"iters": 25})))

    ids, src, dst, w = _cross_stream()
    js = make_store("sharded", **CROSS_KW)
    assert js.apply(OpBatch.edges(src, dst, w)).dropped == 0
    for key, op in _cross_ops(AnalyticsOp, ids, src):
        r = js.analytics_result(op)
        put(f"cross/{key}", r.value)
        out[f"cross/{key}/iters"] = np.array(r.iters)

    def record(epoch, key, ri, rs):
        p = f"advance/{epoch}/{key}"
        put(p, ri.value)
        put(p + "/scratch", rs.value)
        out[p + "/path"] = np.array([ri.mode, str(ri.reason)])
        out[p + "/iters"] = np.array(ri.iters)

    _advance_run(make_store, OpBatch, AnalyticsOp, record)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_analytics_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


# --------------------------------------------------------------------------
# the port, in this process
# --------------------------------------------------------------------------

def _store(backend, **kw):
    from repro_torch.api import make_store
    return make_store(backend, device="cpu", **kw)


def _max_err(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max(
        initial=0.0))


def _assert_value(ref, prefix, name, value):
    """``value`` (a port answer) equals the JAX answer under ``prefix``."""
    got = _flat(value)
    keys = {k[len(prefix) + 1:] for k in ref
            if k.startswith(prefix + "/") and "/" not in k[len(prefix) + 1:]
            and k[len(prefix) + 1:] in ("ids", "vals", "v")}
    assert keys == set(got), (prefix, keys, set(got))
    if "ids" in got:
        np.testing.assert_array_equal(got["ids"], ref[prefix + "/ids"],
                                      err_msg=prefix)
    k = "vals" if "vals" in got else "v"
    if name in FLOATS:
        assert _max_err(name, got[k], ref[f"{prefix}/{k}"]) <= 1e-5, prefix
    else:
        np.testing.assert_array_equal(got[k].astype(np.float64),
                                      ref[f"{prefix}/{k}"].astype(
                                          np.float64), err_msg=prefix)


def _family(key):
    return "pagerank" if key.startswith("pagerank") else key


@pytest.fixture(scope="module")
def cross():
    """The cross-backend scenario on the port's two backends."""
    from repro_torch.api import AnalyticsOp, OpBatch
    ids, src, dst, w = _cross_stream()
    out = {}
    for backend, kw in (("local", LOCAL_KW), ("sharded", CROSS_KW)):
        st = _store(backend, **kw)
        assert st.apply(OpBatch.edges(src, dst, w)).dropped == 0
        out[backend] = {key: st.analytics_result(op)
                        for key, op in _cross_ops(AnalyticsOp, ids, src)}
    return out


def test_distributed_bfs_and_pagerank_match_jax_and_the_local_store(ref):
    from repro_torch.api import AnalyticsOp, OpBatch
    ids, src, dst, w = _dist_stream()
    answers = {}
    for backend, kw in (("sharded", DIST_KW),
                        ("local", dict(n_max=2048, key_bits=32,
                                       expected_n=256, batch=1024,
                                       pool_blocks=8192, block_size=8,
                                       dmax=2048))):
        st = _store(backend, **kw)
        assert st.apply(OpBatch.edges(src, dst, w)).dropped == 0
        answers[backend] = (
            st.analytics(AnalyticsOp("bfs", {"source": int(src[0]),
                                             "max_iters": 32})),
            st.analytics(AnalyticsOp("pagerank", {"iters": 25})))
    (bfs, pr), (lbfs, lpr) = answers["sharded"], answers["local"]
    _assert_value(ref, "dist/bfs", "bfs", bfs)
    _assert_value(ref, "dist/pagerank", "pagerank", pr)
    assert bfs == lbfs and set(pr) == set(lpr)
    assert max(abs(pr[v] - lpr[v]) for v in pr) < 1e-6
    assert max(bfs.values()) >= 2


@pytest.mark.parametrize("key", [k for k, _ in _cross_ops(
    lambda *a: None, np.zeros(16, np.uint64), np.zeros(1, np.uint64))])
def test_cross_backend_answers_match_jax_and_the_local_store(ref, cross,
                                                             key):
    """Each answer of the port's sharded store equals the JAX sharded
    store's and the port's local store's (BC and PageRank within 1e-5,
    iteration counts exact)."""
    sh, lo = cross["sharded"][key], cross["local"][key]
    _assert_value(ref, f"cross/{key}", _family(key), sh.value)
    assert sh.iters == int(ref[f"cross/{key}/iters"])
    if _family(key) in FLOATS:
        assert set(sh.value) == set(lo.value)
        ks = sorted(sh.value)
        assert _max_err(key, [sh.value[k] for k in ks],
                        [lo.value[k] for k in ks]) <= 1e-5
    elif isinstance(sh.value, np.ndarray):
        np.testing.assert_array_equal(sh.value, lo.value)
    else:
        assert sh.value == lo.value, key
    assert sh.mode == "scratch"


def test_cross_backend_answers_are_not_trivial(cross):
    sh = cross["sharded"]
    assert max(sh["bfs"].value.values()) >= 2
    assert set(sh["bfs_ghost"].value.values()) == {-1}
    assert (sh["khop1"].value <= sh["khop3"].value).all()
    assert sh["khop3"].value.sum() > sh["khop1"].value.sum()
    assert sh["num_edges"].value == sum(sh["degree_map"].value.values())
    assert sh["pagerank_tol"].iters > 1


@pytest.fixture(scope="module")
def advances():
    from repro_torch.api import AnalyticsOp, OpBatch, make_store
    out = {}

    def record(epoch, key, ri, rs):
        out[(epoch, key)] = (ri, rs)

    _advance_run(lambda b, **kw: make_store(b, device="cpu", **kw),
                 OpBatch, AnalyticsOp, record)
    return out


@pytest.mark.parametrize("epoch", ADV_EPOCHS)
def test_advance_paths_and_answers_match_jax(ref, advances, epoch):
    """Every advance takes JAX's path with JAX's reason and iteration
    count, equals JAX's answer, and equals a scratch run at its epoch."""
    keys = sorted({k for e, k in advances if e == epoch})
    assert len(keys) == 8
    for key in keys:
        ri, rs = advances[(epoch, key)]
        p = f"advance/{epoch}/{key}"
        assert [ri.mode, str(ri.reason)] == ref[p + "/path"].tolist(), p
        assert ri.iters == int(ref[p + "/iters"]), p
        _assert_value(ref, p, _family(key), ri.value)
        _assert_value(ref, p + "/scratch", _family(key), rs.value)
        if isinstance(ri.value, dict):
            assert set(ri.value) == set(rs.value)
            ks = sorted(ri.value)
            err = _max_err(key, [ri.value[k] for k in ks],
                           [rs.value[k] for k in ks])
            assert err <= (1e-5 if _family(key) in FLOATS else 0.0), p
        else:
            np.testing.assert_array_equal(ri.value, rs.value, err_msg=p)


def test_advance_modes_follow_the_guards(advances):
    """Clean epochs advance every warm-capable analytics; the delete
    epoch sends bfs, wcc and sssp to scratch with the guard's reason;
    fixed-iteration PageRank has no warm program and k-hop no advance."""
    for epoch in ADV_EPOCHS:
        for key in ("pagerank", "wcc", "bfs", "sssp", "degree_map",
                    "num_edges", "pagerank_fixed", "khop"):
            ri, _rs = advances[(epoch, key)]
            if key == "pagerank_fixed":
                assert (ri.mode, ri.reason) == ("scratch", "no-warm-program")
            elif key == "khop":
                assert (ri.mode, ri.reason) == ("scratch", "no-warm")
            elif epoch == "deletes" and key in ("bfs", "wcc", "sssp"):
                assert (ri.mode, ri.reason) == ("scratch", "deletes")
            else:
                assert ri.mode == "incremental", (epoch, key, ri.reason)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _reference(sys.argv[1])
