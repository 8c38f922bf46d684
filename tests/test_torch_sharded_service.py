"""The port's ``GraphQueryService`` over its ``ShardedStore`` against the
JAX service over the JAX ``ShardedStore``, at 2 shards: the cases of
``tests/test_graph_service.py`` (its fixture, degree against the oracle,
reads pinned to the sealed epoch, analytics against a single-shard
reference, memoisation, sync reuse, the pipelined drain and its stats,
backpressure), run in that file's order on both packages. Each case
records its answers and the service's non-timing stats; the tests hold
the port's to the JAX service's (PageRank under the JAX suite's rule,
|a - b| / max(1, |b|) <= 1e-5; the rest exact) and to the JAX tests' own
assertions.

The JAX store needs 2 devices: one subprocess, started by a
module-scoped fixture with ``--xla_force_host_platform_device_count=4``
set before JAX touches a device, runs this file as a script and writes
one ``.npz`` while the port runs the same cases in this process on the
CPU. Also here: durable-ack over ``DurableStore(sharded)``, and the
``persist`` / ``serve`` launch modes on the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
N_SHARDS = 2
SERVED = dict(n_shards=N_SHARDS, n_per_shard=2048, expected_n=512,
              pool_blocks=8192, block_size=8, dmax=512, k_max=64, batch=256,
              query_batch=64)
SMALL = dict(n_shards=N_SHARDS, n_per_shard=1024, expected_n=256,
             pool_blocks=2048, block_size=8, dmax=256, k_max=32, batch=64,
             query_batch=32)
TINY = dict(n_shards=N_SHARDS, n_per_shard=512, expected_n=128,
            pool_blocks=1024, block_size=8, dmax=128, k_max=32, batch=64,
            query_batch=32)
PR_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: one intra-op thread keeps its
    pool from spinning against the JAX reference and the other workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats(svc, tag, out):
    for k, v in svc.stats.items():
        if not k.endswith("_ms"):
            out[f"{tag}/stats/{k}"] = np.array(v)


def _fixture_data():
    rng = np.random.default_rng(7)
    ids = rng.choice(2 ** 32, 90, replace=False).astype(np.uint64)
    n_e = 1500
    src, dst = rng.choice(ids, n_e), rng.choice(ids, n_e)
    w = rng.uniform(0.5, 2, n_e).astype(np.float32)
    w[rng.random(n_e) < 0.15] = 0.0
    return ids, src, dst, w


def _cases(make_store, Service, kw):
    """Every case of ``tests/test_graph_service.py``, in its order, on one
    package (``kw``: extra store kwargs). Returns the answers and stats as
    named numpy arrays."""
    out = {}
    ids, src, dst, w = _fixture_data()
    svc = Service(make_store("sharded", **SERVED, **kw), pr_iters=25)
    svc.submit_update(src, dst, w)
    svc.run()
    _stats(svc, "fixture", out)

    # degree queries
    t = svc.submit_query("degree", ids=ids)
    out["degree"] = np.asarray(svc.run()[t])
    _stats(svc, "degree", out)

    # reads pinned to the sealed epoch (an edge between existing vertices
    # absent from the live edge set, then deleted again)
    probe = ids[:8]
    last = {}
    for s, d, ww in zip(src, dst, w):
        last[(int(s), int(d))] = ww
    live = {k for k, ww in last.items() if ww}
    extra_dst = next(int(x) for x in ids[20:]
                     if (int(probe[0]), int(x)) not in live)
    t0 = svc.submit_query("degree", ids=probe)
    svc.run()
    out["pinned/sealed"] = np.asarray(svc.results[t0])
    svc.submit_update(probe[:1], [extra_dst], [1.0])
    t1 = svc.submit_query("degree", ids=probe)
    svc.step()
    out["pinned/same_step"] = np.asarray(svc.results[t1])
    t2 = svc.submit_query("degree", ids=probe)
    svc.run()
    out["pinned/next"] = np.asarray(svc.results[t2])
    svc.submit_update(probe[:1], [extra_dst], [0.0])
    svc.run()
    _stats(svc, "pinned", out)

    # analytics (compared with a single-shard reference by the tests)
    tb = svc.submit_query("bfs", source=int(src[0]))
    tp = svc.submit_query("pagerank")
    res = svc.run()
    out["bfs"] = np.array([res[tb].get(int(v), -2) for v in ids])
    out["pagerank"] = np.array([float(res[tp][int(v)]) for v in ids])
    _stats(svc, "analytics", out)

    # memoisation within one sealed epoch
    t1 = svc.submit_query("pagerank")
    t2 = svc.submit_query("pagerank")
    svc.run()
    out["memo/same_object"] = np.array(svc.results[t2] is svc.results[t1])

    # sync reuse across epochs without vertex creation
    runs0 = svc.stats["sync_runs"]
    svc.submit_query("pagerank")
    svc.run()
    reused0 = svc.stats["sync_reused"]
    skips0 = svc.stats["sync_skips"]
    svc.submit_update(src[:4], dst[:4], w[:4] + 1.0)
    svc.submit_update(src[:4], dst[:4], w[:4])
    svc.submit_query("pagerank")
    svc.run()
    known = set(int(x) for x in ids)
    fresh = np.array([x for x in range(7, 100) if x not in known][:2],
                     np.uint64)
    out["sync/churn"] = np.array([
        runs0, reused0, svc.stats["sync_runs"], svc.stats["sync_skips"] -
        skips0, svc.stats["sync_reused"] - reused0])
    svc.submit_update(fresh, fresh[::-1], np.ones(2, np.float32))
    svc.run()
    out["sync/fresh_runs"] = np.array(svc.stats["sync_runs"])
    t = svc.submit_query("bfs", source=int(fresh[0]))
    out["sync/fresh_bfs"] = np.array(svc.run()[t][int(fresh[1])])
    svc.submit_update(fresh, fresh[::-1], np.zeros(2, np.float32))
    svc.run()
    _stats(svc, "sync", out)

    # the pipelined drain and its stats
    rng = np.random.default_rng(11)
    pids = rng.choice(2 ** 32, 64, replace=False).astype(np.uint64)
    n_e = 64 * 10
    psrc, pdst = rng.choice(pids, n_e), rng.choice(pids, n_e)
    pw = rng.uniform(0.5, 2, n_e).astype(np.float32)

    programs = {}

    def make(depth):
        """Both services' stores share one spec, and so their compiled
        programs (where the store caches them per instance)."""
        store = make_store("sharded", **SMALL, **kw)
        store._fns = programs.setdefault("fns", store._fns)
        return Service(store, pipeline_depth=depth)
    deep = make(4)
    trace = [deep.stats["write_flushes"], deep.stats["queued_write_ops"]]
    deep.submit_update(psrc, pdst, pw)
    trace.append(deep.stats["queued_write_ops"])
    deep.step()
    trace += [deep.stats[k] for k in ("write_flushes",
                                      "inflight_write_batches",
                                      "queued_write_ops", "flushes",
                                      "super_batches")]
    deep.run()
    trace += [deep.stats[k] for k in ("queued_write_ops", "write_flushes",
                                      "inflight_write_batches")]
    flat = make(1)
    flat.submit_update(psrc, pdst, pw)
    flat.run()
    trace += [flat.stats["write_flushes"], flat.stats["super_batches"]]
    out["pipe/trace"] = np.array(trace)
    td, tf = (s.submit_query("degree", ids=pids) for s in (deep, flat))
    out["pipe/deep"] = np.asarray(deep.run()[td])
    out["pipe/flat"] = np.asarray(flat.run()[tf])
    _stats(deep, "pipe_deep", out)
    _stats(flat, "pipe_flat", out)

    # backpressure
    bp = Service(make_store("sharded", **TINY, **kw), max_pending=100)
    a = np.arange(90, dtype=np.uint64)
    b = np.arange(20, dtype=np.uint64)
    oks = [bp.submit_update(a, a + 1), bp.submit_update(b, b + 1)]
    bp.run()
    oks.append(bp.submit_update(b, b + 1))
    out["backpressure"] = np.array(oks)
    return out


def _reference(out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from repro.api import make_store
    from repro.serve.graph_service import GraphQueryService
    np.savez(out_path, **_cases(make_store, GraphQueryService, {}))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """``(port, jax)`` answer dicts; the JAX subprocess runs while the
    port runs here."""
    from repro_torch.api import make_store
    from repro_torch.serve import GraphQueryService
    path = tmp_path_factory.mktemp("sharded_service") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(path)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = _cases(make_store, GraphQueryService, dict(device="cpu"))
        _out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with np.load(path) as z:
        return port, dict(z)


def _oracle():
    ids, src, dst, w = _fixture_data()
    last = {}
    for s, d, ww in zip(src, dst, w):
        last[(int(s), int(d))] = ww
    deg = {}
    for (s, _d), ww in last.items():
        if ww:
            deg[s] = deg.get(s, 0) + 1
    return ids, src, dst, w, np.array([deg.get(int(x), 0) for x in ids])


def _equal(port, ref, keys):
    for k in keys:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_stats_match_jax_case_by_case(both):
    """Every non-timing service and store counter, after every case."""
    port, ref = both
    pk = sorted(k for k in port if "/stats/" in k)
    assert pk == sorted(k for k in ref if "/stats/" in k)
    _equal(port, ref, pk)
    assert port["fixture/stats/ops_dropped"] == 0
    assert port["fixture/stats/sync_runs"] > 0


def test_degree_queries_match_oracle(both):
    port, ref = both
    _equal(port, ref, ["degree"])
    np.testing.assert_array_equal(port["degree"], _oracle()[4])


def test_reads_pinned_to_sealed_epoch(both):
    """A read submitted in the step of a write answers from the previous
    sealed epoch; the next one sees the write."""
    port, ref = both
    _equal(port, ref, ["pinned/sealed", "pinned/same_step", "pinned/next"])
    np.testing.assert_array_equal(port["pinned/same_step"],
                                  port["pinned/sealed"])
    bumped = port["pinned/sealed"].copy()
    bumped[0] += 1
    np.testing.assert_array_equal(port["pinned/next"], bumped)


def test_analytics_match_jax_and_a_single_shard_reference(both):
    from repro_torch.analytics import algorithms as A
    from repro_torch.core.radixgraph import RadixGraph
    port, ref = both
    _equal(port, ref, ["bfs"])
    rel = np.abs(port["pagerank"] - ref["pagerank"]) / np.maximum(
        1.0, np.abs(ref["pagerank"]))
    assert rel.max() <= PR_TOL
    ids, src, dst, w, _deg = _oracle()
    g = RadixGraph(n_max=512, key_bits=32, expected_n=128, batch=512,
                   pool_blocks=8192, block_size=8, dmax=512, k_max=64,
                   device="cpu")
    g.apply_ops(src, dst, w)
    snap = g.snapshot()
    off = np.asarray(g.lookup(ids))
    s0 = int(np.asarray(g.lookup(np.array([src[0]], np.uint64)))[0])
    ref_d = A.bfs(snap, s0).numpy()
    ref_pr = A.pagerank(snap, iters=25).numpy()
    np.testing.assert_array_equal(port["bfs"], ref_d[off])
    np.testing.assert_allclose(port["pagerank"], ref_pr[off], atol=1e-6,
                               rtol=0)


def test_analytics_memoized_per_epoch(both):
    port, ref = both
    assert bool(port["memo/same_object"]) and bool(ref["memo/same_object"])


def test_sync_reused_across_epochs_without_vertex_creation(both):
    """Analytics on a sealed epoch reuse the write path's incremental
    sync; edge churn between existing vertices skips the sync; a write
    that creates vertices runs it once, and bfs reaches them."""
    port, ref = both
    _equal(port, ref, ["sync/churn", "sync/fresh_runs", "sync/fresh_bfs"])
    runs0, reused0, runs1, d_skips, d_reused = port["sync/churn"].tolist()
    assert reused0 > 0 and runs1 == runs0
    assert d_skips > 0 and d_reused > 0
    assert int(port["sync/fresh_runs"]) == runs0 + 1
    assert int(port["sync/fresh_bfs"]) == 1


def test_pipelined_write_drain_and_stats_depth_reporting(both):
    port, ref = both
    _equal(port, ref, ["pipe/trace", "pipe/deep", "pipe/flat"])
    n_e = 640
    assert port["pipe/trace"].tolist() == [
        0, 0, n_e, 1, 4, n_e - 4 * 64, 1, 1, 0, 3, 2, 10, 10]
    np.testing.assert_array_equal(port["pipe/deep"], port["pipe/flat"])
    assert port["pipe_deep/stats/ops_dropped"] == 0
    assert port["pipe_flat/stats/ops_dropped"] == 0


def test_backpressure(both):
    port, ref = both
    _equal(port, ref, ["backpressure"])
    assert port["backpressure"].tolist() == [True, False, True]


def test_durable_ack_over_a_sharded_durable_store(tmp_path):
    """Over ``DurableStore(sharded)`` every write phase ends on a group
    commit: ``durable_syncs`` counts the steps that wrote (not the
    read-only one), and the WAL scans back whole, one record a step."""
    from repro_torch.api import make_store
    from repro_torch.core.status import Reason
    from repro_torch.serve import GraphQueryService
    from repro_torch.storage import DurableStore, read_wal
    store = DurableStore(make_store("sharded", device="cpu", **SMALL),
                         tmp_path, group_commit=64)
    svc = GraphQueryService(store)
    assert svc.durable_ack
    rng = np.random.default_rng(14)
    ids = rng.choice(2 ** 32, 32, replace=False).astype(np.uint64)
    wrote = 0
    for step in range(4):
        if step != 2:
            svc.submit_update(rng.choice(ids, 16), rng.choice(ids, 16),
                              rng.uniform(0.5, 2, 16).astype(np.float32))
            wrote += 1
        svc.submit_query("degree", ids=ids[:8])
        svc.step()
    assert svc.stats["durable_syncs"] == wrote == 3
    assert store.stats["wal_syncs"] >= wrote
    scan = read_wal(store.wal.path)
    assert scan.tail is Reason.OK and len(scan.records) == wrote
    assert [len(r.batch) for r in scan.records] == [16] * wrote
    assert svc.stats["ops_applied"] == 16 * wrote
    store.close()


@pytest.mark.parametrize("mode", ["persist", "serve"])
def test_launch_modes_run_on_the_cpu(mode):
    from repro_torch.launch import dryrun_graph as dg
    rec = dg.main(["--mode", mode, "--shards", "2", "--device", "cpu"])
    assert rec["status"] == "ok" and rec["chips"] == 2
    assert rec["device"] == "cpu"
    if mode == "persist":
        assert rec["recovery_bit_exact"] is True
        assert rec["checkpoints_written"] >= 1
    else:
        assert rec["ops_dropped"] == 0 and rec["bfs_reached"] > 0
    assert (dg.RESULTS / f"torch-radixgraph-{mode}__2shards.json").exists()


def test_hlo_launch_modes_exit_without_a_record():
    """The JAX package's HLO-lowering modes, ``ingest`` and
    ``analytics``: the port has no lowering, so it runs them (one batch,
    each program) under its cost counter and writes a record with JAX's
    keys (``tests/test_torch_dryrun_graph.py`` holds the counts to
    JAX's)."""
    from repro_torch.launch import dryrun_graph as dg
    small = ["--shards", "2", "--device", "cpu", "--n-per-shard", "4096",
             "--batch-per-shard", "256"]
    ing = dg.main(["--mode", "ingest"] + small)
    assert ing["status"] == "ok" and ing["ops_dropped"] == 0
    assert ing["collective_counts"]["all-to-all"] == 1
    assert (dg.RESULTS / "torch-radixgraph-ingest__2shards.json").exists()
    ana = dg.main(["--mode", "analytics"] + small)
    assert ana["status"] == "ok" and set(ana["algs"]) == {"bfs", "pagerank"}
    assert (dg.RESULTS / "torch-radixgraph-analytics__2shards.json").exists()


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _reference(sys.argv[1])
