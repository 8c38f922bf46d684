"""Incremental epoch-delta analytics and the query service, port against
the JAX package on the CPU.

Each scenario of ``tests/test_incremental.py`` that runs on one shard is
written once, over a namespace of either package's entry points, and run
on both from the same seed (inputs made with numpy). Both runs must give
the same values, modes, reasons and iteration counts, and the port's run
must also pass the scenario's own assertions. ``extract_delta`` is
compared field by field on the same two epochs, and one
``GraphQueryService`` run is compared on its results and stats.

Streams are applied symmetrically, as in ``tests/test_incremental.py``.

Tolerances: every value is bit-exact (integers, sssp's float32 min-plus
distances, the copied host advances) except PageRank, whose scratch run
sums floats in another order than XLA: atol 1e-5. Iteration counts,
modes and reasons are compared exactly.
"""
import types

import numpy as np
import pytest

from repro.api import AnalyticsOp as JOp
from repro.api import OpBatch as JBatch
from repro.api import make_store as jmake
from repro.core import epoch_delta as jed
from repro.serve.graph_service import GraphQueryService as JService
from repro_torch.api import AnalyticsOp, OpBatch, make_store
from repro_torch.core import epoch_delta as ted
from repro_torch.core.status import ADVANCE_FALLBACKS
from repro_torch.serve import GraphQueryService

CAPS = dict(n_max=512, pool_blocks=1024, block_size=8, dmax=256, k_max=64,
            batch=128)
PR_TOL = 1e-5

PKGS = {
    "jax": types.SimpleNamespace(make_store=jmake, OpBatch=JBatch,
                                 AnalyticsOp=JOp, Service=JService, ed=jed),
    "torch": types.SimpleNamespace(
        make_store=lambda *a, **k: make_store(*a, device="cpu", **k),
        OpBatch=OpBatch, AnalyticsOp=AnalyticsOp, Service=GraphQueryService,
        ed=ted),
}


def _store(P, max_delta_frac=0.9):
    return P.make_store("local", key_bits=32, expected_n=64,
                        undirected=False, m_cap=2048,
                        max_delta_frac=max_delta_frac, **CAPS)


def _ops(P, src):
    return [P.AnalyticsOp("pagerank", dict(iters=200, tol=1e-7)),
            P.AnalyticsOp("wcc", {}),
            P.AnalyticsOp("bfs", dict(source=src)),
            P.AnalyticsOp("sssp", dict(source=src)),
            P.AnalyticsOp("degree_map", {}),
            P.AnalyticsOp("num_edges", {})]


def _sym(s, d, w):
    return (np.concatenate([s, d]), np.concatenate([d, s]),
            np.concatenate([w, w]))


def _max_err(a, b):
    if isinstance(a, dict):
        if set(a) != set(b):
            return float("inf")
        if not a:
            return 0.0
        ks = sorted(a)
        va = np.array([float(a[k]) for k in ks], np.float64)
        vb = np.array([float(b[k]) for k in ks], np.float64)
        return float(np.abs(va - vb).max())
    return abs(float(a) - float(b))


def _tol(name):
    return PR_TOL if name == "pagerank" else 0.0


def _check_parity(name, rs, ri):
    err = _max_err(rs.value, ri.value)
    assert err <= _tol(name), (name, ri.mode, ri.reason, err)


def _base_load(P, store, rng, nv=40, n_pairs=120):
    ids = rng.choice(2 ** 32, nv, replace=False).astype(np.uint64)
    s = ids[rng.integers(0, nv, n_pairs)]
    d = ids[rng.integers(0, nv, n_pairs)]
    w = rng.uniform(1.0, 2.0, n_pairs).astype(np.float32)
    store.apply(P.OpBatch.edges(*_sym(s, d, w)))
    return ids


def _both(scenario, *args):
    """Run ``scenario(P, trace, *args)`` on both packages and compare the
    traces of (label, AnalyticsResult) they record."""
    traces = {}
    for key, P in PKGS.items():
        traces[key] = []
        scenario(P, traces[key], *args)
    assert len(traces["jax"]) == len(traces["torch"])
    for (la, a), (lb, b) in zip(traces["jax"], traces["torch"]):
        assert la == lb
        name = la[0]
        assert _max_err(a.value, b.value) <= _tol(name), la
        assert (a.mode, str(a.reason), a.iters, a.epoch) == \
            (b.mode, str(b.reason), b.iters, b.epoch), la
    return traces["torch"]


# ---- the property: advance is exact on every path, fallback included ----

def _advance_scenario(P, trace, seed):
    rng = np.random.default_rng(seed)
    store = _store(P)
    ids = _base_load(P, store, rng)
    ops = _ops(P, int(ids[0]))
    live = set()

    ep = store.capture()
    warm = {o.name: store.analytics_result(o, ep) for o in ops}
    for k in range(3):
        dirty = bool(rng.random() < 0.4)
        n = int(rng.integers(5, 25))
        lo, hi = 0.5 * 0.5 ** k, 0.9 * 0.5 ** k
        s = ids[rng.integers(0, len(ids), n)]
        d = ids[rng.integers(0, len(ids), n)]
        w = rng.uniform(lo, hi, n).astype(np.float32)
        fresh = set(zip(s.tolist(), d.tolist()))
        dels = set()
        if dirty and live:
            cand = sorted(live)
            take = rng.integers(0, len(cand), max(1, n // 4))
            dels = {cand[i] for i in take}
            ds = np.array([p[0] for p in dels], np.uint64)
            dd = np.array([p[1] for p in dels], np.uint64)
            s = np.concatenate([s, ds])
            d = np.concatenate([d, dd])
            w = np.concatenate([w, np.zeros(len(dels), np.float32)])
        live = (live | fresh) - dels
        dirty = bool(dels)
        store.apply(P.OpBatch.edges(*_sym(s, d, w)))
        cur = store.capture()
        for o in ops:
            ri = store.analytics_advance(o, warm[o.name], cur)
            rs = store.analytics_result(o, cur)
            _check_parity(o.name, rs, ri)
            if not dirty:
                assert ri.mode == "incremental", (o.name, ri.reason)
            elif o.name in ("bfs", "wcc", "sssp"):
                assert ri.mode == "scratch" and ri.reason, (o.name, ri)
            trace.append(((o.name, k, "advance"), ri))
            trace.append(((o.name, k, "scratch"), rs))
            warm[o.name] = ri


@pytest.mark.parametrize("seed", [3, 101, 7777])
def test_advance_matches_scratch_local(seed):
    """Random mixed insert/update/delete streams: every epoch, every
    algorithm, ``analytics_advance`` equals the scratch run, on both
    packages alike."""
    _both(_advance_scenario, seed)


# ---- every fallback reason, deterministically ----

def _fallback_scenario(P, trace):
    rng = np.random.default_rng(7)
    store = _store(P)
    ids = _base_load(P, store, rng)
    store.apply(P.OpBatch.edges(*_sym(ids[[0, 0]], ids[[1, 2]],
                                      np.array([0.8, 0.5], np.float32))))
    op = P.AnalyticsOp("bfs", dict(source=int(ids[0])))
    ep = store.capture()
    warm = store.analytics_result(op, ep)

    store.apply(P.OpBatch.edges(*_sym(ids[:1], ids[1:2],
                                      np.zeros(1, np.float32))))
    cur = store.capture()
    ri = store.analytics_advance(op, warm, cur)
    assert (ri.mode, ri.reason) == ("scratch", "advance-refused")
    _check_parity("bfs", store.analytics_result(op, cur), ri)
    trace.append((("bfs", "deletes"), ri))
    warm, ep = ri, cur

    sop = P.AnalyticsOp("sssp", dict(source=int(ids[0])))
    swarm = store.analytics_result(sop, ep)
    store.apply(P.OpBatch.edges(*_sym(ids[:1], ids[2:3],
                                      np.full(1, 9.0, np.float32))))
    cur = store.capture()
    ri = store.analytics_advance(sop, swarm, cur)
    assert (ri.mode, ri.reason) == ("scratch", "advance-refused")
    trace.append((("sssp", "weight-increase"), ri))
    ri2 = store.analytics_advance(op, warm, cur)
    assert ri2.mode == "incremental", ri2.reason
    trace.append((("bfs", "weight-increase"), ri2))
    warm, ep = ri2, cur

    store.apply(P.OpBatch.delete_vertices(ids[5:6]))
    cur = store.capture()
    ri = store.analytics_advance(op, warm, cur)
    assert (ri.mode, ri.reason) == ("scratch", "vertex-event")
    trace.append((("bfs", "vertex-event"), ri))
    warm, ep = ri, cur

    tight = _store(P, max_delta_frac=0.01)
    tids = _base_load(P, tight, np.random.default_rng(8))
    top = P.AnalyticsOp("num_edges", {})
    twarm = tight.analytics_result(top, tight.capture())
    s = tids[np.arange(30) % len(tids)]
    d = tids[(np.arange(30) * 7 + 1) % len(tids)]
    tight.apply(P.OpBatch.edges(*_sym(s, d, np.full(30, 0.3, np.float32))))
    ri = tight.analytics_advance(top, twarm, tight.capture())
    assert (ri.mode, ri.reason) == ("scratch", "delta-too-large")
    trace.append((("num_edges", "delta-too-large"), ri))

    store.graph.defrag()
    same = store.analytics_advance(op, warm, store.capture())
    assert same is warm
    store.apply(P.OpBatch.edges(*_sym(ids[:1], ids[3:4],
                                      np.full(1, 0.2, np.float32))))
    cur = store.capture()
    ri = store.analytics_advance(op, warm, cur)
    assert (ri.mode, ri.reason) == ("scratch", "defrag")
    _check_parity("bfs", store.analytics_result(op, cur), ri)
    trace.append((("bfs", "defrag"), ri))

    # no warm result, and a source the graph never saw
    ri = store.analytics_advance(op, None, cur)
    assert (ri.mode, ri.reason) == ("scratch", "no-warm")
    trace.append((("bfs", "no-warm"), ri))
    aop = P.AnalyticsOp("bfs", dict(source=12345))
    awarm = store.analytics_result(aop, cur)
    store.apply(P.OpBatch.edges(*_sym(ids[:1], ids[4:5],
                                      np.full(1, 0.2, np.float32))))
    ri = store.analytics_advance(aop, awarm, store.capture())
    assert (ri.mode, ri.reason) == ("scratch", "absent-source")
    trace.append((("bfs", "absent-source"), ri))


def test_fallback_reasons_local():
    trace = _both(_fallback_scenario)
    assert all(r.reason in ADVANCE_FALLBACKS for _, r in trace
               if r.mode == "scratch")


def _fixed_pr_scenario(P, trace):
    rng = np.random.default_rng(11)
    store = _store(P)
    ids = _base_load(P, store, rng)
    op = P.AnalyticsOp("pagerank", dict(iters=20))
    warm = store.analytics_result(op, store.capture())
    store.apply(P.OpBatch.edges(*_sym(ids[:2], ids[3:5],
                                      np.full(2, 0.4, np.float32))))
    ri = store.analytics_advance(op, warm, store.capture())
    assert (ri.mode, ri.reason) == ("scratch", "advance-refused")
    trace.append((("pagerank", "fixed"), ri))


def test_fixed_iteration_pagerank_never_advances():
    _both(_fixed_pr_scenario)


def _scalar_scenario(P, trace):
    rng = np.random.default_rng(13)
    store = _store(P)
    ids = _base_load(P, store, rng)
    store.apply(P.OpBatch.edges(*_sym(ids[:3], ids[4:7],
                                      np.full(3, 0.7, np.float32))))
    ops = [P.AnalyticsOp("degree_map", {}), P.AnalyticsOp("num_edges", {})]
    ep = store.capture()
    warm = {o.name: store.analytics_result(o, ep) for o in ops}
    store.apply(P.OpBatch.edges(*_sym(ids[:3], ids[4:7],
                                      np.zeros(3, np.float32))))
    cur = store.capture()
    for o in ops:
        ri = store.analytics_advance(o, warm[o.name], cur)
        assert ri.mode == "incremental", (o.name, ri.reason)
        _check_parity(o.name, store.analytics_result(o, cur), ri)
        trace.append(((o.name,), ri))


def test_scalar_advances_survive_deletes():
    _both(_scalar_scenario)


# ---- bounded retention: warm LRU + refcounted epoch pins ----

def _retention_scenario(P, trace, out):
    rng = np.random.default_rng(17)
    store = _store(P)
    ids = _base_load(P, store, rng)
    svc = P.Service(store, seal_every=1, max_warm_states=3, write_batch=64)
    retained = []
    for i in range(16):
        s = ids[rng.integers(0, len(ids), 8)]
        d = ids[rng.integers(0, len(ids), 8)]
        w = rng.uniform(0.1, 0.9, 8).astype(np.float32)
        svc.submit_update(*_sym(s, d, w))
        svc.submit_query("bfs", source=int(ids[i % 6]))
        svc.submit_query("pagerank", tol=1e-7, iters=200)
        svc.run()
        retained.append(svc.stats["retained_epochs"])
    out[P.OpBatch.__module__] = (retained, svc)
    assert svc.stats["warm_evictions"] > 0
    assert svc.stats["analytics_incremental"] > 0
    assert max(retained[8:]) <= svc.max_warm_states + 2, retained
    assert retained[-1] <= svc.max_warm_states + 2, retained


def test_service_retention_plateaus():
    out = {}
    _both(_retention_scenario, out)
    (ra, sa), (rb, sb) = out.values()
    assert ra == rb
    for k in ("warm_evictions", "analytics_incremental",
              "analytics_scratch", "epochs_sealed", "queries_answered"):
        assert sa.stats[k] == sb.stats[k], k
    for t, v in sa.results.items():
        assert _max_err(v, sb.results[t]) <= PR_TOL, t


def _memo_scenario(P, trace, out):
    rng = np.random.default_rng(19)
    store = _store(P)
    ids = _base_load(P, store, rng)
    svc = P.Service(store, seal_every=0, max_warm_states=4)
    t1 = svc.submit_query("wcc")
    svc.step()
    t2 = svc.submit_query("wcc")
    svc.step()
    assert svc.results[t1] is svc.results[t2]
    assert svc.stats["analytics_scratch"] == 1
    svc.submit_update(*_sym(ids[:2], ids[3:5],
                            np.full(2, 0.7, np.float32)))
    svc.step()
    svc.seal_epoch()
    t3 = svc.submit_query("wcc")
    svc.step()
    assert svc.stats["analytics_incremental"] == 1
    assert set(svc.results[t3]) >= set(svc.results[t1])
    out[P.OpBatch.__module__] = [svc.results[t] for t in (t1, t2, t3)]


def test_service_memo_identity_and_modes():
    out = {}
    _both(_memo_scenario, out)
    a, b = out.values()
    assert a == b


# ---- extract_delta field by field, and one whole service run ----

def test_extract_delta_matches_jax():
    """The same two epochs (inserts, an update, tombstones and new rows)
    give the same ``EpochDelta`` in both packages; so do the refusals."""
    got = {}
    for key, P in PKGS.items():
        rng = np.random.default_rng(23)
        store = _store(P)
        ids = _base_load(P, store, rng)
        store.apply(P.OpBatch.edges(*_sym(ids[:2], ids[6:8],   # known live
                                          np.full(2, 1.5, np.float32))))
        e0 = store.capture()
        fresh = rng.choice(2 ** 32, 5, replace=False).astype(np.uint64)
        s = np.concatenate([ids[:6], fresh])
        d = np.concatenate([ids[6:12], ids[:5]])
        w = rng.uniform(0.1, 0.9, 11).astype(np.float32)
        w[:2] = 0.0
        store.apply(P.OpBatch.edges(*_sym(s, d, w)))
        e1 = store.capture()
        delta, reason = store._delta(e0, e1)
        store.apply(P.OpBatch.delete_vertices(ids[7:8]))
        e2 = store.capture()
        got[key] = (delta, reason, store._delta(e1, e2),
                    P.ed.merged_flags([delta]))
    (da, ra, va, fa), (db, rb, vb, fb) = got.values()
    assert ra == rb == "ok"
    assert va == vb == (None, "vertex-event")
    assert fa == fb
    assert db.n_changed > 0 and db.new_rows.size == 5 and db.has_deletes
    for f in ("touched_rows", "new_rows", "e_src", "e_dst", "w_prev",
              "w_new"):
        x, y = getattr(da, f), getattr(db, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (da.m_prev, da.m_cur) == (db.m_prev, db.m_cur)


def _service_run(P):
    rng = np.random.default_rng(29)
    store = _store(P)
    ids = _base_load(P, store, rng)
    svc = P.Service(store, write_batch=32, query_batch=64, seal_every=2,
                    incremental=True, max_warm_states=4)
    tickets = []
    for i in range(10):
        s = ids[rng.integers(0, len(ids), 20)]
        d = ids[rng.integers(0, len(ids), 20)]
        w = rng.uniform(0.1, 0.9, 20).astype(np.float32)
        assert svc.submit_update(*_sym(s, d, w))
        tickets.append(svc.submit_query("degree", ids=ids[:16]))
        if i % 3 == 0:
            tickets.append(svc.submit_query("bfs", source=int(ids[1])))
            tickets.append(svc.submit_query("wcc"))
            tickets.append(svc.submit_query("khop", sources=ids[:3], k=2))
        if i == 5:
            assert svc.submit_add_vertices(np.array([77, 78], np.uint64))
        svc.step()
    svc.submit_query("sssp", source=int(ids[2]))
    svc.run()
    return svc, tickets


def test_service_run_matches_jax():
    """The same submissions give the same results and the same stats in
    both packages (timings aside); the port's final answers equal scratch
    runs at the last sealed epoch."""
    (ja, jt), (ta, tt) = (_service_run(P) for P in PKGS.values())
    assert jt == tt and set(ja.results) == set(ta.results)
    for t in ja.results:
        a, b = ja.results[t], ta.results[t]
        if isinstance(a, dict):
            assert _max_err(a, b) == 0.0, t
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sa, sb = ja.stats, ta.stats
    timing = {k for k in sa if k.endswith("_ms")}
    assert set(sa) == set(sb)
    for k in set(sa) - timing:
        assert sa[k] == sb[k], k
    assert sb["analytics_incremental"] > 0 and sb["analytics_scratch"] > 0
    # the final answers against scratch runs at the last sealed epoch
    for name, params in (("wcc", {}), ("degree_map", {}),
                         ("sssp", dict(source=77))):
        want = ta.store.analytics_result(AnalyticsOp(name, params),
                                         at=ta._sealed).value
        tk = ta.submit_query(name, **params)
        ta.step()
        assert _max_err(ta.results[tk], want) == 0.0, name
