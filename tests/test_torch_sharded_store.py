"""The port's ``ShardedStore`` (``make_store("sharded")``) against the JAX
package's, and against the port's own ``LocalStore``.

The JAX store needs 2 devices: one subprocess, started by a module-scoped
fixture with ``--xla_force_host_platform_device_count=4`` set before JAX
touches a device, runs this file as a script and writes one ``.npz``: its
reads live and at a captured epoch, its clock, counters and state leaves,
and its state at a resume point. The port runs in this process on the CPU
(``device="cpu"``). Every compared output is an integer, an index or a
copied float: the comparisons are exact.

Both stores are built from ONE kwargs dict. The JAX store's append probes
a ``probe_width`` window on the CPU (the fused probe runs on a TPU); the
stream keeps every edge array inside that window, where the two agree.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
# k_max 4: a batch that overflows more than 4 edge arrays rebuilds, so
# both shards rebuild mid-stream (and the rebuilt pools fit)
KW = dict(n_shards=2, n_per_shard=1024, expected_n=256, pool_blocks=1024,
          block_size=8, k_max=4, dmax=256, batch=128, query_batch=64,
          pipeline_depth=3)
FLUSHES = ((0, 700), (700, 1300), (1300, 2000), (2000, 2600))
CAPTURE_AFTER = 1      # the epoch: after the second flush
KINDS = ("lookup", "degree", "neighbors", "num_vertices", "num_edges",
         "snapshot")
COUNTERS = ("ops_applied", "ops_dropped", "sync_runs", "sync_skips",
            "defrags", "tiles_scanned", "flushes", "super_batches")


def _stream(seed=3, n=2600):
    rng = np.random.default_rng(seed)
    ids = rng.choice(2 ** 32, 300, replace=False).astype(np.uint64)
    p = 1.0 / np.arange(1, 301) ** 0.8
    p /= p.sum()
    src = ids[rng.choice(300, n, p=p)]
    dst = ids[rng.choice(300, n, p=p)]
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.random(n) < 0.25] = 0.0
    # queried IDs: every vertex, and three the stream never names
    q = np.concatenate([ids, np.array([5, 7, 2 ** 32 - 1], np.uint64)])
    return q, src, dst, w


def _read(store, Read, kind, q, at=None):
    op = Read(kind, ids=q) if kind in ("lookup", "degree", "neighbors") \
        else Read(kind)
    return store.read(op, at=at)


def _flat(kind, v):
    """A read answer as named numpy arrays, JAX and port alike."""
    if kind == "neighbors":
        return {"counts": np.array([len(a) for a, _ in v]),
                "ids": np.concatenate([np.asarray(a, np.uint64)
                                       for a, _ in v]),
                "w": np.concatenate([np.asarray(b, np.float32)
                                     for _, b in v])}
    if kind == "snapshot":
        return {f: np.array(getattr(v, f)) for f in v._fields}
    return {"v": np.array(v)}


# --------------------------------------------------------------------------
# the JAX reference (run as a script in a subprocess)
# --------------------------------------------------------------------------

def _reference(out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from repro.api import OpBatch, ReadOp, make_store
    q, src, dst, w = _stream()
    out = {}

    def put_state(prefix, state):
        for j, a in enumerate(jax.tree.leaves(state)):
            out[f"{prefix}/{j}"] = np.asarray(a)

    def put_reads(prefix, store, at=None):
        for kind in KINDS:
            for k, a in _flat(kind, _read(store, ReadOp, kind, q, at)
                              ).items():
                out[f"{prefix}/{kind}/{k}"] = a

    js = make_store("sharded", **KW)
    epoch = None
    for i, (lo, hi) in enumerate(FLUSHES):
        r = js.apply(OpBatch.edges(src[lo:hi], dst[lo:hi], w[lo:hi]))
        out[f"dropped/{i}"] = np.array(r.dropped)
        if i == CAPTURE_AFTER:
            epoch = js.capture()
            put_state("resume", js.state)
            put_reads("epoch_then", js, epoch)
    put_reads("live", js)
    put_reads("epoch", js, epoch)
    put_state("final", js.state)
    out["clock"] = np.array([js.clock(), js.clock(epoch)])
    for k in COUNTERS:
        out[f"stats/{k}"] = np.array(js.stats[k])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_ref") / "ref.npz"
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

def _host_leaves(state):
    from repro_torch.convert import state_to_numpy
    from repro_torch.dist.graph_engine import _leaves
    return _leaves(state_to_numpy(state))


def _assert_leaves(ref, prefix, leaves):
    assert sum(1 for k in ref if k.startswith(prefix + "/")) == len(leaves)
    for j, a in enumerate(leaves):
        r = ref[f"{prefix}/{j}"]
        assert r.dtype == a.dtype, (prefix, j)
        np.testing.assert_array_equal(a, r, err_msg=f"{prefix} leaf {j}")


def _assert_reads(ref, prefix, kind, answer):
    got = _flat(kind, answer)
    keys = {k[len(prefix) + len(kind) + 2:] for k in ref
            if k.startswith(f"{prefix}/{kind}/")}
    assert keys == set(got), (prefix, kind, keys, set(got))
    for k, a in got.items():
        r = ref[f"{prefix}/{kind}/{k}"]
        if kind == "snapshot" and k == "ids":
            a = a.astype(np.uint32)
        assert r.dtype == a.dtype, (prefix, kind, k, r.dtype, a.dtype)
        np.testing.assert_array_equal(a, r, err_msg=f"{prefix} {kind} {k}")


@pytest.fixture(scope="module")
def run():
    from repro_torch.api import OpBatch, ReadOp, make_store
    q, src, dst, w = _stream()
    ts = make_store("sharded", device="cpu", **KW)
    drops, epoch, then, copies = [], None, None, []
    for i, (lo, hi) in enumerate(FLUSHES):
        drops.append(ts.apply(OpBatch.edges(src[lo:hi], dst[lo:hi],
                                            w[lo:hi])).dropped)
        copies.append(ts.state_copies)
        if i == CAPTURE_AFTER:
            epoch = ts.capture()
            then = {kind: _read(ts, ReadOp, kind, q, epoch)
                    for kind in KINDS}
    return dict(ts=ts, q=q, drops=drops, epoch=epoch, then=then,
                copies=copies)


@pytest.mark.parametrize("kind", KINDS)
def test_live_reads_match_jax(ref, run, kind):
    from repro_torch.api import ReadOp
    _assert_reads(ref, "live", kind, _read(run["ts"], ReadOp, kind,
                                           run["q"]))


@pytest.mark.parametrize("kind", KINDS)
def test_epoch_reads_match_jax_after_further_applies(ref, run, kind):
    """Reads at an epoch captured before two more flushes equal JAX's and
    what the port answered at capture time; the first apply after the
    capture copied the state once."""
    from repro_torch.api import ReadOp
    now = _read(run["ts"], ReadOp, kind, run["q"], run["epoch"])
    _assert_reads(ref, "epoch", kind, now)
    _assert_reads(ref, "epoch_then", kind, run["then"][kind])
    assert run["copies"] == [0, 0, 1, 1]


def test_state_clock_and_counters_match_jax(ref, run):
    ts = run["ts"]
    _assert_leaves(ref, "final", _host_leaves(ts.state))
    assert [ts.clock(), ts.clock(run["epoch"])] == ref["clock"].tolist()
    for k in COUNTERS:
        assert ts.stats[k] == int(ref[f"stats/{k}"]), k
    assert run["drops"] == [int(ref[f"dropped/{i}"])
                            for i in range(len(FLUSHES))]
    # the stream stays inside the JAX store's CPU probe window
    assert int(ts.state.vt.size.max()) < 256
    assert ts.stats["sync_runs"] > 0 and ts.state.pool.defrags.min() > 0
    assert (ts.state.pool.next_block <= KW["pool_blocks"]).all()


def test_resumes_from_a_jax_sharded_state(ref):
    """The JAX store's state after two flushes, loaded into a fresh port
    store, gives JAX's state after the remaining flushes."""
    from repro_torch.api import OpBatch, make_store
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.dist.graph_engine import _leaves, _tmap
    _q, src, dst, w = _stream()
    ts = make_store("sharded", device="cpu", **KW)
    arrays = iter([ref[f"resume/{j}"]
                   for j in range(len(_leaves(ts.state)))])
    tree = _tmap(lambda _: next(arrays), state_to_numpy(ts.state))
    ts.state = state_from_numpy(tree, "cpu")
    _assert_leaves(ref, "resume", _host_leaves(ts.state))
    for lo, hi in FLUSHES[CAPTURE_AFTER + 1:]:
        ts.apply(OpBatch.edges(src[lo:hi], dst[lo:hi], w[lo:hi]))
    _assert_leaves(ref, "final", _host_leaves(ts.state))


def test_local_and_sharded_backends_answer_alike():
    """The port's two backends, one stream: identical reads."""
    from repro_torch.api import OpBatch, ReadOp, make_store
    q, src, dst, w = _stream(seed=11, n=2000)
    stores = [make_store("local", device="cpu", n_max=2048, key_bits=32,
                         expected_n=256, batch=128, pool_blocks=4096,
                         block_size=8, dmax=256, k_max=32),
              make_store("sharded", device="cpu", **KW)]
    ans = []
    for s in stores:
        for lo in range(0, len(src), 500):
            assert s.apply(OpBatch.edges(src[lo:lo + 500], dst[lo:lo + 500],
                                         w[lo:lo + 500])).dropped == 0
        a = {kind: _read(s, ReadOp, kind, q) for kind in
             ("lookup", "degree", "num_vertices", "num_edges")}
        a["neighbors"] = [sorted(zip(x.tolist(), y.tolist())) for x, y in
                          _read(s, ReadOp, "neighbors", q)]
        ans.append(a)
    local, sharded = ans
    assert local["neighbors"] == sharded["neighbors"]
    for kind in ("lookup", "degree", "num_vertices", "num_edges"):
        np.testing.assert_array_equal(local[kind], sharded[kind],
                                      err_msg=kind)
    assert local["num_edges"] > 0 and local["lookup"][:300].sum() > 250
    assert not local["lookup"][300:].any()


def test_sharded_vertex_batch_raises_structured_error():
    from repro_torch.api import OpBatch, UnsupportedOpError, make_store
    sh = make_store("sharded", device="cpu", n_shards=1, n_per_shard=512,
                    expected_n=128, pool_blocks=1024, block_size=8,
                    dmax=256, k_max=64, batch=128, query_batch=64)
    assert "add_vertices" not in sh.supported_ops
    for batch in (OpBatch.add_vertices(np.arange(4, dtype=np.uint64)),
                  OpBatch.delete_vertices(np.arange(2, dtype=np.uint64))):
        with pytest.raises(UnsupportedOpError) as ei:
            sh.apply(batch)
        assert ei.value.kind == batch.kind
        assert ei.value.backend == "sharded"
        assert isinstance(ei.value, NotImplementedError)


def test_service_rejects_unsupported_vertex_ops():
    from repro_torch.api import make_store
    from repro_torch.serve import GraphQueryService
    sh = make_store("sharded", device="cpu", n_shards=1, n_per_shard=512,
                    expected_n=128, pool_blocks=1024, block_size=8,
                    dmax=256, k_max=64, batch=128, query_batch=64)
    svc = GraphQueryService(sh)
    assert svc.submit_add_vertices(np.arange(4, dtype=np.uint64)) is False
    assert svc.submit_delete_vertices(np.arange(2, dtype=np.uint64)) is False
    assert svc.stats["writes_rejected"] == 2
    svc.step()                      # nothing queued, nothing crashes


def test_sharded_analytics_wait_for_the_registry():
    """``triangle_count`` has no sharded program registered (in either
    package): it raises, as the JAX store does, and touches no state."""
    from repro_torch.api import AnalyticsOp, available_analytics, make_store
    sh = make_store("sharded", device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="mesh"):
        sh.analytics(AnalyticsOp("triangle_count"))
    assert torch.equal(sh.state.pool.clock, torch.ones(2, dtype=torch.int32))
    assert available_analytics(distributed=False) == ["triangle_count"]


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _reference(sys.argv[1])
