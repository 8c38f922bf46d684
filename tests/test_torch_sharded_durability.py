"""Durability of the port's ``ShardedStore`` (``make_store("sharded")``
behind ``repro_torch.storage``) against the JAX package's, at 2 and 4
shards.

Each package runs one scenario per shard count: a ``DurableStore`` over a
sharded store takes flush 0, a full checkpoint, flush 1, a delta
checkpoint, flushes 2 and 3 into the WAL only; the directory is then
copied and the copy's WAL tail torn (flush 3's record cut short); the
live store takes flushes 4 and 5. Every flush names vertices no earlier
one did, so each runs the incremental vertex sync.

The port runs first, in this process on the CPU, and leaves its
directories on disk. The JAX store needs 4 devices: one subprocess,
started by a module-scoped fixture with
``--xla_force_host_platform_device_count=4`` set before JAX touches a
device, runs this file as a script. It runs the same scenarios, restores
the port's checkpoint chain, recovers a copy of the port's torn
directory and resumes it with flushes 3-5, and writes the states it saw
to one ``.npz``. The tests then compare files byte for byte, manifests
as JSON and states leaf for leaf (the pool's entries on owned blocks
where a delta checkpoint left vacated blocks with its base's bytes).

Both stores are built from ONE kwargs dict. The JAX store's append probes
a ``probe_width`` window on the CPU (the fused probe runs on a TPU); the
stream keeps every edge array inside it (asserted), where the two agree.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
KW = dict(n_per_shard=1024, expected_n=256, pool_blocks=1024, block_size=8,
          k_max=64, dmax=256, batch=128, query_batch=64, pipeline_depth=3)
SHARDS = (2, 4)
N_FLUSHES = 6
TEAR_BYTES = 5          # cut off the WAL's last record (flush 3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small: one intra-op thread keeps its
    pool from spinning against the JAX reference and the other workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flushes(seed=3, n_ids=480, size=400):
    """Six flushes of ``size`` ops; flush k draws from the first
    80 (k + 1) IDs (powerlaw), so each creates vertices; 25% tombstones."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(2 ** 32, n_ids, replace=False).astype(np.uint64)
    out = []
    for k in range(N_FLUSHES):
        m = 80 * (k + 1)
        p = 1.0 / np.arange(1, m + 1) ** 0.8
        p /= p.sum()
        w = rng.uniform(0.5, 2.0, size).astype(np.float32)
        w[rng.random(size) < 0.25] = 0.0
        out.append((ids[rng.choice(m, size, p=p)],
                    ids[rng.choice(m, size, p=p)], w))
    return out


def _scenario(pkg, n, root: pathlib.Path, leaves, record):
    """Run the scenario of the module docstring on package ``pkg`` (a dict
    of its ``make_store``, ``OpBatch``, ``DurableStore``), recording the
    live state after flushes 1, 2 and 5 as ``ckpt``, ``wal``, ``final``.
    Returns the two checkpoint manifests and the store."""
    flushes = _flushes()
    store = pkg["make_store"]("sharded", n_shards=n, **pkg["kw"])
    dur = pkg["DurableStore"](store, root / "dur", group_commit=4)

    def apply(k):
        r = dur.apply(pkg["OpBatch"].edges(*flushes[k]))
        assert r.dropped == 0

    apply(0)
    mans = [dur.checkpoint()]
    apply(1)
    mans.append(dur.checkpoint())
    record("ckpt", leaves(store.state))
    apply(2)
    record("wal", leaves(store.state))
    apply(3)
    dur.sync()
    shutil.copytree(root / "dur", root / "torn")
    seg = sorted((root / "torn" / "wal").glob("wal_*.log"))[-1]
    with open(seg, "r+b") as f:
        f.truncate(seg.stat().st_size - TEAR_BYTES)
    apply(4)
    apply(5)
    record("final", leaves(store.state))
    dur.close()
    return mans, store


# --------------------------------------------------------------------------
# the JAX reference (run as a script in a subprocess)
# --------------------------------------------------------------------------

def _reference(out_path, port_root, jax_root):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from repro.api import OpBatch, make_store
    from repro.storage import DurableStore, recover
    pkg = dict(make_store=make_store, OpBatch=OpBatch,
               DurableStore=DurableStore, kw=KW)
    out = {}

    def leaves(state):
        return [np.asarray(a) for a in jax.tree.leaves(state)]

    for n in SHARDS:
        def record(tag, ls, n=n):
            for j, a in enumerate(ls):
                out[f"{tag}/{n}/{j}"] = a
        root = pathlib.Path(jax_root) / f"n{n}"
        _mans, writer = _scenario(pkg, n, root, leaves, record)

        def fresh():
            """A store of the writer's spec that reuses its compiled
            programs (they depend on the spec and mesh only)."""
            s = make_store("sharded", n_shards=n, **KW)
            s._fns = writer._fns
            return s
        proot = pathlib.Path(port_root) / f"n{n}"
        js = fresh()
        js.restore(proot / "dur")
        record("x_restore", leaves(js.state))
        out[f"x_restore/{n}/synced_rows"] = np.array(js._synced_rows)
        shutil.copytree(proot / "torn", root / "x_torn")
        rec, report = recover(root / "x_torn", fresh)
        record("x_recover", leaves(rec.state))
        out[f"x_recover/{n}/replayed"] = np.array(report["replayed"])
        flushes = _flushes()
        for k in (3, 4, 5):
            rec.apply(OpBatch.edges(*flushes[k]))
        record("x_resume", leaves(rec.state))
        rec.close()
    np.savez(out_path, **out)


# --------------------------------------------------------------------------
# the port, in this process; then the reference
# --------------------------------------------------------------------------

def _host_leaves(state):
    from repro_torch.convert import state_to_numpy
    from repro_torch.dist.graph_engine import _leaves
    return _leaves(state_to_numpy(state))


def _port_pkg():
    from repro_torch.api import OpBatch, make_store
    from repro_torch.storage import DurableStore
    return dict(make_store=make_store, OpBatch=OpBatch,
                DurableStore=DurableStore, kw=dict(KW, device="cpu"))


def _tstore(n, **kw):
    from repro_torch.api import make_store
    return make_store("sharded", n_shards=n, device="cpu", **dict(KW, **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' scenarios: the port's recorded leaves and manifests
    by shard count, the JAX subprocess's ``.npz`` as a dict, and the roots
    of both packages' directories."""
    base = tmp_path_factory.mktemp("sharded_durability")
    port_root, jax_root = base / "port", base / "jax"
    port = dict(leaves={}, mans={})
    for n in SHARDS:
        def record(tag, ls, n=n):
            port["leaves"][(tag, n)] = ls
        port["mans"][n] = _scenario(_port_pkg(), n, port_root / f"n{n}",
                                    _host_leaves, record)[0]
    path = base / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(path), str(port_root), str(jax_root)],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        ref = dict(z)
    return dict(port=port, ref=ref, port_root=port_root, jax_root=jax_root)


def _ref_leaves(ref, tag, n):
    return [ref[f"{tag}/{n}/{j}"] for j in range(
        sum(1 for k in ref if k.startswith(f"{tag}/{n}/") and
            k.rsplit("/", 1)[1].isdigit()))]


def _tree(leaves, n):
    """A port ``GraphState`` on the CPU from host leaves in leaf order."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.dist.graph_engine import _tmap
    it = iter(leaves)
    tree = _tmap(lambda _: next(it), state_to_numpy(_tstore(n).state))
    return state_from_numpy(tree, "cpu")


def _assert_same(a, b, n, where):
    """Host leaf lists equal leaf for leaf, except the pool's entries on
    blocks no row owns (``crash_smoke.assert_states_equal``)."""
    from repro_torch.storage.crash_smoke import assert_states_equal
    assert len(a) == len(b), where
    for j, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (where, j)
    assert_states_equal(_tree(a, n), _tree(b, n), where)


def _assert_exact(a, b, where):
    assert len(a) == len(b), where
    for j, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype, (where, j)
        np.testing.assert_array_equal(x, y, err_msg=f"{where} leaf {j}")


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", SHARDS)
def test_live_states_match_jax(runs, n):
    """The same ops through both packages' durable sharded stores give the
    same state at every recorded point; the stream stays inside the JAX
    store's probe window and the pools fit."""
    port, ref = runs["port"], runs["ref"]
    for tag in ("ckpt", "wal", "final"):
        _assert_exact(port["leaves"][(tag, n)], _ref_leaves(ref, tag, n),
                      f"{tag} n{n}")
    final = _tree(port["leaves"][("final", n)], n)
    assert int(final.vt.size.max()) < 256
    assert (final.pool.next_block <= KW["pool_blocks"]).all()


@pytest.mark.parametrize("n", SHARDS)
def test_checkpoint_files_byte_identical_to_jax(runs, n):
    """Full and delta checkpoints: equal manifests (the same ``meta``:
    seq, sync watermark a shard, defrags, op counts) and byte-identical
    ``.npy`` members; the WAL segments byte-identical too."""
    kinds = [m["kind"] for m in runs["port"]["mans"][n]]
    assert kinds == ["full", "delta"]
    pdir = runs["port_root"] / f"n{n}" / "dur"
    jdir = runs["jax_root"] / f"n{n}" / "dur"
    for ck in ("ckpt_00000000", "ckpt_00000001"):
        pfiles = sorted(p.name for p in (pdir / ck).iterdir())
        assert pfiles == sorted(p.name for p in (jdir / ck).iterdir())
        assert any(f.startswith("delta__") for f in pfiles) == \
            (ck == "ckpt_00000001")
        pm = json.loads((pdir / ck / "manifest.json").read_text())
        jm = json.loads((jdir / ck / "manifest.json").read_text())
        assert pm == jm, ck
        assert pm["n_shards"] == n and len(pm["meta"]["synced_rows"]) == n
        for f in pfiles:
            assert (pdir / ck / f).read_bytes() == \
                (jdir / ck / f).read_bytes(), (ck, f)
    psegs = sorted(p.name for p in (pdir / "wal").iterdir())
    assert psegs == sorted(p.name for p in (jdir / "wal").iterdir())
    for s in psegs:
        assert (pdir / "wal" / s).read_bytes() == \
            (jdir / "wal" / s).read_bytes(), s


@pytest.mark.parametrize("n", SHARDS)
def test_each_package_restores_the_others_chain(runs, n):
    """The port restores JAX's full + delta chain, and JAX the port's,
    into the state both had at the delta checkpoint, with the sync
    watermark of the manifest."""
    port, ref = runs["port"], runs["ref"]
    ts = _tstore(n)
    man = ts.restore(runs["jax_root"] / f"n{n}" / "dur")
    assert man["kind"] == "delta" and man["ckpt_id"] == 1
    _assert_same(_host_leaves(ts.state), _ref_leaves(ref, "ckpt", n), n,
                 f"port restores JAX n{n}")
    assert ts._synced_rows.tolist() == man["meta"]["synced_rows"]
    assert ts._synced_rows.tolist() == \
        ref[f"x_restore/{n}/synced_rows"].tolist()
    _assert_same(_ref_leaves(ref, "x_restore", n),
                 port["leaves"][("ckpt", n)], n, f"JAX restores port n{n}")


@pytest.mark.parametrize("n", SHARDS)
def test_each_package_recovers_the_others_torn_directory(runs, n, tmp_path):
    """Checkpoint chain + WAL with a torn tail: each package recovers the
    other's directory into the state after flush 2 (flush 3's record is
    cut), replaying one record through ``ShardedStore.apply``."""
    from repro_torch.core.status import Reason
    from repro_torch.storage import recover
    port, ref = runs["port"], runs["ref"]
    d = tmp_path / "torn"
    shutil.copytree(runs["jax_root"] / f"n{n}" / "torn", d)
    rec, report = recover(d, lambda: _tstore(n))
    assert report["checkpoint"] == 1 and report["replayed"] == 1
    assert report["wal_tail"] is Reason.WAL_TORN
    _assert_same(_host_leaves(rec.state), _ref_leaves(ref, "wal", n), n,
                 f"port recovers JAX n{n}")
    assert int(ref[f"x_recover/{n}/replayed"]) == 1
    _assert_same(_ref_leaves(ref, "x_recover", n),
                 port["leaves"][("wal", n)], n, f"JAX recovers port n{n}")
    rec.close()


@pytest.mark.parametrize("n", SHARDS)
def test_restore_then_further_batches_resume_leaf_equal(runs, n, tmp_path):
    """A store restored from the chain (no replay: the sync watermark
    comes from the manifest) and a store recovered from the torn
    directory each take the remaining flushes and end leaf-equal to the
    uninterrupted store, the JAX store and JAX's resumed recovery."""
    from repro_torch.api import OpBatch
    from repro_torch.storage import recover
    port, ref = runs["port"], runs["ref"]
    flushes = _flushes()
    final = port["leaves"][("final", n)]
    _assert_exact(final, _ref_leaves(ref, "final", n), f"final n{n}")
    _assert_same(_ref_leaves(ref, "x_resume", n), final, n,
                 f"JAX resumes port n{n}")
    ts = _tstore(n)
    ts.restore(runs["port_root"] / f"n{n}" / "dur")
    copies = ts.state_copies
    for k in (2, 3, 4, 5):
        ts.apply(OpBatch.edges(*flushes[k]))
    assert ts.state_copies == copies + 1       # the restored state pinned
    _assert_same(_host_leaves(ts.state), final, n, f"restore+resume n{n}")
    d = tmp_path / "torn"
    shutil.copytree(runs["port_root"] / f"n{n}" / "torn", d)
    rec, _ = recover(d, lambda: _tstore(n))
    for k in (3, 4, 5):
        rec.apply(OpBatch.edges(*flushes[k]))
    _assert_same(_host_leaves(rec.state), final, n, f"recover+resume n{n}")
    rec.close()


def test_delta_across_a_shards_rebuild_falls_back_to_full(tmp_path):
    """k_max 4: a later flush rebuilds some shard, so the next checkpoint
    is full (``why_full`` defrag, per-shard counters in the manifest); the
    one after, with no rebuild between, is a delta again, and restores."""
    from repro_torch.api import OpBatch
    from repro_torch.convert import state_to_numpy
    flushes = _flushes()
    ts = _tstore(2, k_max=4)
    ts.apply(OpBatch.edges(*flushes[0]))
    m0 = ts.checkpoint(tmp_path)
    d0 = ts.state.pool.defrags.tolist()
    for k in range(1, N_FLUSHES):
        ts.apply(OpBatch.edges(*flushes[k]))
        d1 = ts.state.pool.defrags.tolist()
        if d1 != d0:
            break
    assert d1 != d0
    m1 = ts.checkpoint(tmp_path)
    assert (m0["kind"], m1["kind"], m1["why_full"]) == \
        ("full", "full", "defrag")
    assert m1["defrags"] == d1
    src, dst, _w = flushes[k]
    ts.apply(OpBatch.edges(src[:8], dst[:8], np.full(8, 3.0, np.float32)))
    assert ts.state.pool.defrags.tolist() == d1
    m2 = ts.checkpoint(tmp_path)
    assert m2["kind"] == "delta" and m2["base"] == m1["ckpt_id"]
    back = _tstore(2, k_max=4)
    back.restore(tmp_path)
    _assert_same(_host_leaves(back.state),
                 _host_leaves(ts.state), 2, "delta after rebuild")
    assert state_to_numpy(back.state).pool.defrags.tolist() == d1


def test_delta_guards_and_shape_check_over_shards(tmp_path):
    """A 4-shard save over a 2-shard chain is full (``shard-mismatch``); an
    overflow counted on one shard since the base voids the delta; a chain
    of 2 shards does not install into a 4-shard store."""
    from repro_torch.api import OpBatch
    from repro_torch.core.status import Reason
    from repro_torch.storage import CheckpointError
    flushes = _flushes()
    two = _tstore(2)
    two.apply(OpBatch.edges(*flushes[0]))
    two.checkpoint(tmp_path, keep=4)
    four = _tstore(4)
    four.apply(OpBatch.edges(*flushes[0]))
    m = four.checkpoint(tmp_path, keep=4)
    assert (m["kind"], m["why_full"]) == ("full", "shard-mismatch")
    four.state.pool.overflow[3] += 1
    m = four.checkpoint(tmp_path, keep=4)
    assert (m["kind"], m["why_full"]) == ("full", "overflow")
    with pytest.raises(CheckpointError) as ei:
        _tstore(4).restore(tmp_path, ckpt_id=0)
    assert ei.value.code is Reason.CKPT_BAD_MANIFEST
    assert "mismatched store spec" in str(ei.value)


def test_advance_across_a_restore_answers_restore_boundary(tmp_path):
    """A warm result from before a restore is not advanced into the
    restored lineage: ``analytics_advance`` answers from scratch with
    ``RESTORE_BOUNDARY``, equal to a scratch run; the same window without
    the restore advances incrementally."""
    from repro_torch.api import AnalyticsOp, OpBatch
    from repro_torch.core.status import Reason
    src, dst, w = _flushes()[0]
    op = AnalyticsOp("bfs", {"source": int(src[0]), "max_iters": 16})
    small = OpBatch.edges(src[:16], dst[::-1][:16], np.ones(16, np.float32))
    modes = []
    for restore in (True, False):
        ts = _tstore(2)
        ts.apply(OpBatch.edges(src, dst, w))
        prev = ts.analytics_result(op, ts.capture())
        if restore:
            ts.checkpoint(tmp_path)
            ts.restore(tmp_path)
        ts.apply(small)
        at = ts.capture()
        res = ts.analytics_advance(op, prev, at)
        modes.append((res.mode, res.reason))
        assert res.value == ts.analytics_result(op, at).value
    assert modes == [("scratch", Reason.RESTORE_BOUNDARY),
                     ("incremental", "")]


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _reference(*sys.argv[1:4])
