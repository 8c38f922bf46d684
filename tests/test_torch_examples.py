"""The sequences of ``examples/quickstart.py`` (local and sharded),
``examples/streaming_analytics.py`` and ``examples/train_lm.py`` on both
packages, their outputs compared. The examples are scripts of the JAX
package; each sequence below is the script's, call for call, with the
package's API passed in (the port's stores on the CPU).

Integer answers (counts, degrees, neighbours, BFS depths, component
partitions) must be equal; PageRank within |a - b| <= 1e-5 max(1, |b|)
(float sums); the training losses within rtol 2e-4, as
``tests/test_torch_train_launch.py`` holds a resumed run. ``train_lm``
runs as its qwen2.5-3b SMOKE run, synthetic and ``--graph``, cut to 6
steps, both packages resuming the JAX run's checkpoint at step 3.

The JAX sides (most of the time: their compiles) run at once, a
subprocess a sequence (this file as a script).
"""
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

import repro_torch.api as tapi
from repro_torch.launch import train as ttrain

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

QUICKSTART = {
    "local": dict(n_max=4096, key_bits=32, expected_n=1000, batch=1024,
                  pool_blocks=16384, block_size=16, undirected=True),
    "sharded": dict(n_shards=1, n_per_shard=4096, expected_n=1000,
                    batch=1024, pool_blocks=16384, block_size=16,
                    undirected=True),
}
STREAMING = {
    "local": dict(n_max=8192, key_bits=32, expected_n=2000, batch=2048,
                  pool_blocks=32768, block_size=16, undirected=True),
    "sharded": dict(n_shards=1, n_per_shard=8192, expected_n=2000,
                    batch=2048, pool_blocks=32768, block_size=16,
                    undirected=True),
}


def _make(api, backend, cfg):
    kw = dict(cfg)
    if api is tapi:
        kw["device"] = "cpu"
    return api.make_store(backend, **kw)


def _quickstart(api, backend):
    """``examples/quickstart.py``: its outputs, in order."""
    out = {}
    store = _make(api, backend, QUICKSTART[backend])
    rng = np.random.default_rng(0)
    ids = rng.choice(2**32, 1000, replace=False).astype(np.uint64)
    src, dst = rng.choice(ids, 8000), rng.choice(ids, 8000)
    w = rng.uniform(0.5, 2.0, 8000).astype(np.float32)
    res = store.apply(api.OpBatch.edges(src, dst, w))
    out["counts"] = (int(store.read(api.ReadOp("num_vertices"))),
                     int(store.read(api.ReadOp("num_edges"))),
                     int(res.dropped))
    v0 = store.capture()
    store.apply(api.OpBatch.edges(src[:4000], dst[:4000],
                                  np.zeros(4000, np.float32)))
    store.apply(api.OpBatch.edges(src[4000:5000], dst[4000:5000],
                                  np.full(1000, 9.0, np.float32)))
    out["after"] = int(store.read(api.ReadOp("num_edges")))
    out["lookup"] = np.asarray(store.read(api.ReadOp("lookup",
                                                     ids=ids[:4]))).tolist()
    out["deg"] = np.asarray(store.read(api.ReadOp("degree",
                                                  ids=ids[:4]))).tolist()
    nbr_ids, nbr_w = store.read(api.ReadOp("neighbors", ids=ids[:1]))[0]
    out["nbrs"] = sorted(zip(np.asarray(nbr_ids).tolist(),
                             np.asarray(nbr_w).tolist()))
    out["old_deg"] = int(store.read(api.ReadOp("degree", ids=ids[:1]),
                                    at=v0)[0])
    out["pr"] = store.analytics(api.AnalyticsOp("pagerank", {"iters": 20}))
    out["bfs"] = store.analytics(api.AnalyticsOp("bfs",
                                                 {"source": int(src[0])}))
    out["wcc"] = store.analytics(api.AnalyticsOp("wcc"))
    return out


def _streaming(api, backend):
    """``examples/streaming_analytics.py``: its outputs, in order."""
    out = []
    store = _make(api, backend, STREAMING[backend])
    rng = np.random.default_rng(1)
    ids = rng.choice(2**32, 2000, replace=False).astype(np.uint64)
    epochs = []
    for _ in range(6):
        src, dst = rng.choice(ids, 4000), rng.choice(ids, 4000)
        w = rng.uniform(0.5, 2.0, 4000).astype(np.float32)
        w[rng.random(4000) < 0.2] = 0.0
        store.apply(api.OpBatch.edges(src, dst, w))
        epochs.append(store.capture())
        out.append(("wave", epochs[-1].seq,
                    int(store.read(api.ReadOp("num_edges")))))
    for h in epochs[::2]:
        pr = store.analytics(api.AnalyticsOp("pagerank", {"iters": 10}),
                             at=h)
        comp = store.analytics(api.AnalyticsOp("wcc"), at=h)
        out.append(("epoch", h.seq,
                    int(store.read(api.ReadOp("num_edges"), at=h)), pr,
                    comp))
    return out


def _partition(labels: dict):
    """A component labelling as a set of vertex sets (labels are
    representatives, compared by the sets they name)."""
    groups = {}
    for v, c in labels.items():
        groups.setdefault(c, set()).add(v)
    return {frozenset(g) for g in groups.values()}


def _close_pr(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in b:
        assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), k


def _train_argv(d, data, steps):
    return ["--arch", "qwen2.5-3b", "--steps", str(steps), "--ckpt-dir",
            str(d), "--ckpt-every", "3", "--lr", "1e-3", "--data", data,
            "--smoke", "--batch", "16", "--seq", "64"]


def _jax_side(job: str, out_dir: str):
    """One JAX sequence, its outputs pickled into ``out_dir/job``; a
    train job also leaves the checkpoint of its step 3 in
    ``out_dir/<job>_ckpt`` for the port to resume."""
    import repro.api as japi
    kind, arg = job.split("-")
    if kind == "quickstart":
        out = _quickstart(japi, arg)
    elif kind == "streaming":
        out = _streaming(japi, arg)
    else:
        from repro.launch import train as jtrain
        d = os.path.join(out_dir, job + "_run")
        assert len(jtrain.main(_train_argv(d, arg, 3))) == 3
        shutil.copytree(d, os.path.join(out_dir, job + "_ckpt"))
        out = jtrain.main(_train_argv(d, arg, 6))
    with open(os.path.join(out_dir, job), "wb") as f:
        pickle.dump(out, f)


JOBS = ["quickstart-local", "quickstart-sharded", "streaming-local",
        "streaming-sharded", "train-synthetic", "train-graph"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every JAX side at once, a subprocess each; returns (outputs by
    job, the directory holding the train checkpoints)."""
    d = tmp_path_factory.mktemp("examples_ref")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs = {j: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), j, str(d)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for j in JOBS}
    out = {}
    for j, p in procs.items():
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-4000:]
        with open(d / j, "rb") as f:       # written by this file's job
            out[j] = pickle.load(f)
    return out, d


@pytest.mark.parametrize("backend", ["local", "sharded"])
def test_quickstart_on_both_packages(ref, backend):
    j, t = ref[0][f"quickstart-{backend}"], _quickstart(tapi, backend)
    for k in ("counts", "after", "lookup", "deg", "nbrs", "old_deg"):
        assert t[k] == j[k], k
    assert j["counts"][2] == 0 and all(j["lookup"])
    _close_pr(t["pr"], j["pr"])
    assert {k: int(v) for k, v in t["bfs"].items()} == \
        {k: int(v) for k, v in j["bfs"].items()}
    assert _partition(t["wcc"]) == _partition(j["wcc"])


@pytest.mark.parametrize("backend", ["local", "sharded"])
def test_streaming_analytics_on_both_packages(ref, backend):
    j, t = ref[0][f"streaming-{backend}"], _streaming(tapi, backend)
    assert len(t) == len(j) == 9
    for a, b in zip(t, j):
        assert a[:3] == b[:3]
        if a[0] == "epoch":
            _close_pr(a[3], b[3])
            assert _partition(a[4]) == _partition(b[4])


@pytest.mark.parametrize("data", ["synthetic", "graph"])
def test_train_lm_on_both_packages(ref, data, tmp_path):
    """``examples/train_lm.py``'s default run (qwen2.5-3b SMOKE, batch
    16 x 64, lr 1e-3) cut to 6 steps. The packages draw their initial
    params from different generators, so the JAX launcher runs the first
    3 steps and checkpoints (``--ckpt-every 3``); each launcher resumes
    that checkpoint (params, optimizer state, the stream's position) for
    steps 3-5."""
    outs, d = ref
    shutil.copytree(d / f"train-{data}_ckpt", tmp_path / "port")
    port = ttrain.main(_train_argv(tmp_path / "port", data, 6) +
                       ["--device", "cpu"])
    want = outs[f"train-{data}"]
    assert len(port) == len(want) == 3
    np.testing.assert_allclose(port, want, rtol=2e-4)


if __name__ == "__main__":
    _jax_side(sys.argv[1], sys.argv[2])
