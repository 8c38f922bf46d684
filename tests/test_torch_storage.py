"""Durability of the port (``repro_torch.storage``) against the JAX
package's (``repro.storage``): one on-disk format, one recovery contract.

* WAL: ``encode_record`` is byte-identical across packages; the port's
  tolerant reader gives JAX's records, tail and ``valid_bytes`` at every
  truncation point and after flipped bytes.
* Checkpoints: the same stream through both packages' ``LocalStore``
  gives equal manifests and byte-identical member files (full and delta),
  and each package restores and recovers the other's directory into the
  same state.
* The fault cases of ``tests/test_storage.py`` hold on the port.

Both stores are built from ONE kwargs dict (the port's also gets
``device='cpu'``); inputs are made from numpy seeds. Every comparison is
bit-exact except PageRank across packages (float32 sums in another
order), held to 1e-5 as in the JAX suite.
"""
import shutil

import numpy as np
import pytest

from repro.api import OpBatch as JOp
from repro.api import make_store as jmake
from repro.storage import DurableStore as JDurable
from repro.storage import recover as jrecover
from repro.storage import restore_graph_checkpoint as jrestore
from repro.storage import save_graph_checkpoint as jsave
from repro.storage import checkpoint as jck
from repro.storage import wal as jwal
from repro_torch.api import AnalyticsOp, OpBatch, ReadOp, make_store
from repro_torch.convert import state_to_numpy
from repro_torch.core.radixgraph import clone_state
from repro_torch.core.status import Reason
from repro_torch.storage import (CheckpointError, DurableStore, FaultInjector,
                                 InjectedCrash, checkpoint_ids,
                                 latest_recoverable, read_wal, recover,
                                 restore_graph_checkpoint,
                                 save_graph_checkpoint)
from repro_torch.storage import checkpoint as tck
from repro_torch.storage import wal as twal
from repro_torch.storage.checkpoint import _dir_of
from repro_torch.storage.crash_smoke import assert_states_equal
from repro_torch.storage.faultfs import (corrupt_checkpoint_array,
                                         tear_checkpoint)

from test_torch_core import assert_same_state

KW = dict(n_max=512, pool_blocks=1024, block_size=8, dmax=256, k_max=64,
          batch=128, key_bits=32, expected_n=64, undirected=False,
          m_cap=2048, append_impl="pallas")
PR_TOL = 1e-5


def _jstore():
    return jmake("local", **KW)


def _tstore():
    return make_store("local", device="cpu", **KW)


def _arrays(seed, n_batches=6, size=96, n_ids=48, deletes=True):
    rng = np.random.default_rng(seed)
    ids = rng.choice(2 ** 32, n_ids, replace=False).astype(np.uint64)
    out = []
    for _ in range(n_batches):
        w = rng.uniform(0.5, 2.0, size).astype(np.float32)
        if deletes:
            w[rng.random(size) < 0.1] = 0.0
        out.append((rng.choice(ids, size), rng.choice(ids, size), w))
    return out


def _batches(seed, **kw):
    return [OpBatch.edges(*a) for a in _arrays(seed, **kw)]


def _jbatches(seed, **kw):
    return [JOp.edges(*a) for a in _arrays(seed, **kw)]


def _sig(store):
    snap = store.read(ReadOp("snapshot"))
    return (store.read(ReadOp("num_edges")),
            [x.numpy().copy() for x in snap],
            clone_state(store.graph.state),
            store.analytics(AnalyticsOp("pagerank", {"iters": 8})))


def _assert_same(a, b, where=""):
    """Port against port, on the CPU: everything bit-exact, the pool's
    entry arrays on owned blocks (``crash_smoke.assert_states_equal``)."""
    assert a[0] == b[0], f"{where}: num_edges {a[0]} != {b[0]}"
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        assert np.array_equal(x, y), f"{where}: snapshot leaf {i}"
    assert_states_equal(a[2], b[2], where)
    assert a[3] == b[3], f"{where}: pagerank"


def _assert_cross(jstore, tstore, where=""):
    """JAX store against port store: states leaf for leaf, reads, and
    PageRank within 1e-5."""
    assert_same_state(jstore.graph.state, tstore.graph.state, where)
    assert jstore.read(ReadOp("num_edges")) == \
        tstore.read(ReadOp("num_edges"))
    jsnap = jstore.read(ReadOp("snapshot"))
    tsnap = tstore.read(ReadOp("snapshot"))
    for f in ("indptr", "dst", "weight", "m", "active"):
        np.testing.assert_array_equal(np.asarray(getattr(jsnap, f)),
                                      getattr(tsnap, f).numpy(), f)
    op = AnalyticsOp("pagerank", {"iters": 8})
    jp, tp = jstore.analytics(op), tstore.analytics(op)
    assert jp.keys() == tp.keys()
    for k in jp:
        assert abs(jp[k] - tp[k]) <= PR_TOL, (where, k)


# ---- WAL: the codec and the tolerant reader, byte for byte ----

def _rand_arrays(rng, kind):
    n = int(rng.integers(0, 20))
    if kind == "edges":
        return (rng.integers(0, 2 ** 63, n, dtype=np.uint64),
                rng.integers(0, 2 ** 63, n, dtype=np.uint64),
                rng.uniform(0, 2, n).astype(np.float32))
    return (rng.integers(0, 2 ** 63, n, dtype=np.uint64),)


def _op(mod_op, kind, arrs):
    if kind == "edges":
        return mod_op.edges(*arrs)
    return getattr(mod_op, kind)(*arrs)


def _same_scan(a, b):
    assert a.tail.value == b.tail.value
    assert a.valid_bytes == b.valid_bytes
    assert len(a.records) == len(b.records)
    for x, y in zip(a.records, b.records):
        assert x.seq == y.seq and x.batch.kind == y.batch.kind
        for f in ("src", "dst", "weight", "ids"):
            u, v = getattr(x.batch, f), getattr(y.batch, f)
            assert (u is None) == (v is None)
            if u is not None:
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wal_bytes_and_scans_match_jax(seed, tmp_path):
    """Random batches of all three kinds frame to the same bytes in both
    packages; the port's writer writes JAX's file; every truncation point
    and a flipped byte in every record scan the same in both readers."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["edges", "add_vertices", "delete_vertices"], 6)
    arrs = [_rand_arrays(rng, k) for k in kinds]
    data = b""
    for i, (k, a) in enumerate(zip(kinds, arrs)):
        rj = jwal.encode_record(i, _op(JOp, k, a))
        rt = twal.encode_record(i, _op(OpBatch, k, a))
        assert rj == rt
        data += rt
    data = twal.FILE_MAGIC + data
    for mod, path in ((twal, tmp_path / "t.log"), (jwal, tmp_path / "j.log")):
        op_cls = OpBatch if mod is twal else JOp
        with mod.WalWriter(path, group_commit=3) as w:
            for i, (k, a) in enumerate(zip(kinds, arrs)):
                w.append(i, _op(op_cls, k, a))
        assert path.read_bytes() == data
    _same_scan(twal.read_wal(tmp_path / "j.log"),
               jwal.read_wal(tmp_path / "t.log"))
    for cut in range(len(data) + 1):
        _same_scan(twal._scan(data[:cut]), jwal._scan(data[:cut]))
    for off in range(0, len(data), 7):
        bad = bytearray(data)
        bad[off] ^= 0xFF
        _same_scan(twal._scan(bytes(bad)), jwal._scan(bytes(bad)))


# ---- checkpoint files: byte-identical across packages ----

def _both_checkpointed(tmp_path, seed=2):
    """The same stream through both packages, a full checkpoint after
    four batches and a delta after four more, each into its own dir."""
    jst, tst = _jstore(), _tstore()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    mans = {"jax": [], "port": []}
    head = (_jbatches(seed, n_batches=8), _batches(seed, n_batches=8))
    for lo, hi in ((0, 4), (4, 8)):
        for jb, tb in zip(head[0][lo:hi], head[1][lo:hi]):
            jst.apply(jb)
            tst.apply(tb)
        mans["jax"].append(jsave(jdir, jst, max_delta_frac=0.9, wal_seq=hi))
        mans["port"].append(save_graph_checkpoint(tdir, tst,
                                                  max_delta_frac=0.9,
                                                  wal_seq=hi))
    return jst, tst, jdir, tdir, mans


def test_checkpoint_files_byte_identical_to_jax(tmp_path):
    jst, tst, jdir, tdir, mans = _both_checkpointed(tmp_path)
    assert [m["kind"] for m in mans["port"]] == ["full", "delta"]
    assert mans["jax"] == mans["port"]
    for i in (0, 1):
        jfiles = sorted(p.name for p in _dir_of(jdir, i).iterdir())
        tfiles = sorted(p.name for p in _dir_of(tdir, i).iterdir())
        assert jfiles == tfiles
        for name in jfiles:
            assert (_dir_of(jdir, i) / name).read_bytes() == \
                (_dir_of(tdir, i) / name).read_bytes(), (i, name)
    # the touched-block scan itself, on the same host leaves
    host = dict(tck.flatten_named(state_to_numpy(tst.graph.state)))
    base = mans["port"][0]
    tb = tck._touched_blocks(host, tck._base_small(tdir, base),
                             np.asarray(base["clock"]))
    jb = jck._touched_blocks(host, jck._base_small(jdir, base),
                             np.asarray(base["clock"]))
    np.testing.assert_array_equal(tb, jb)
    assert len(tb) == mans["port"][1]["delta"]["n_blocks"] > 0
    # member names and order are the JAX package's
    named, _ = jck.flatten_named(jst.durable_state()[0])
    assert [n for n, _ in named] == \
        [n for n, _ in tck.flatten_named(tst.durable_state()[0])]
    # CRCs read in place equal the JAX package's over a copy
    for _, leaf in tck.flatten_named(state_to_numpy(tst.graph.state)):
        assert tck._crc(leaf) == jck._crc(leaf)


def test_each_package_restores_the_others_checkpoints(tmp_path):
    """The port restores the JAX chain (full + delta) and JAX restores the
    port's: each equals what the other package restores from the same
    files, leaf for leaf, and the live store on every owned block."""
    jst, tst, jdir, tdir, _ = _both_checkpointed(tmp_path, seed=3)
    t_from_j, t_self = _tstore(), _tstore()
    j_from_t, j_self = _jstore(), _jstore()
    man = restore_graph_checkpoint(jdir, t_from_j)
    assert man["kind"] == "delta"
    restore_graph_checkpoint(tdir, t_self)
    jrestore(tdir, j_from_t)
    jrestore(jdir, j_self)
    _assert_cross(j_self, t_from_j, "port restores JAX")
    _assert_cross(j_from_t, t_self, "JAX restores port")
    assert t_from_j.stats["ops_applied"] == jst.stats["ops_applied"]
    # a delta leaves blocks vacated since its base with the base's bytes
    # (in both packages); every owned block equals the live store's
    assert assert_states_equal(tst.graph.state, t_from_j.graph.state,
                               "restored vs live") > 0
    _assert_same(_sig(tst), _sig(t_from_j), "restored vs live")
    # both keep ingesting in step
    for jb, tb in zip(_jbatches(4, n_batches=2), _batches(4, n_batches=2)):
        j_from_t.apply(jb)
        t_from_j.apply(tb)
    _assert_cross(j_from_t, t_from_j, "after the restore")


def _durable_dir(pkg, directory, seed):
    """A durable store of ``pkg`` writes WAL, a full and a delta
    checkpoint and an unsynced WAL tail, then dies with its last record
    torn. Returns the batches it applied."""
    if pkg == "jax":
        store = JDurable(_jstore(), directory, group_commit=4,
                         checkpoint_every=3, max_delta_frac=0.9)
        batches = _jbatches(seed, n_batches=8)
    else:
        store = DurableStore(_tstore(), directory, group_commit=4,
                             checkpoint_every=3, max_delta_frac=0.9)
        batches = _batches(seed, n_batches=8)
    for b in batches:
        store.apply(b)      # checkpoints after batches 3 and 6
    store.wal._f.flush()    # the unsynced tail reaches the file...
    seg = store.wal.path
    with open(seg, "r+b") as f:     # ...and its last record is torn
        f.truncate(seg.stat().st_size - 5)
    return [m["kind"] for m in (tck._read_manifest(directory, i)
                                for i in checkpoint_ids(directory))]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_recovers_the_others_directory(writer, tmp_path):
    """A durable directory written by one package recovers in both to the
    same report and the same state."""
    src = tmp_path / "src"
    kinds = _durable_dir(writer, src, seed=5)
    assert kinds == ["full", "delta"]
    shutil.copytree(src, tmp_path / "j")
    shutil.copytree(src, tmp_path / "t")
    jdur, jrep = jrecover(tmp_path / "j", _jstore)
    tdur, trep = recover(tmp_path / "t", _tstore)
    assert trep.keys() == jrep.keys()
    for k in jrep:
        want = jrep[k].value if k == "wal_tail" else jrep[k]
        got = trep[k].value if k == "wal_tail" else trep[k]
        assert got == want, k
    assert trep["wal_tail"] is Reason.WAL_TORN
    assert trep["checkpoint_kind"] == "delta" and trep["replayed"] == 1
    _assert_cross(jdur, tdur, f"recovered from {writer}")
    for name in sorted(p.name for p in (tmp_path / "j" / "wal").iterdir()):
        assert (tmp_path / "j" / "wal" / name).read_bytes() == \
            (tmp_path / "t" / "wal" / name).read_bytes(), name


# ---- the fault cases of tests/test_storage.py, on the port ----

def test_full_and_incremental_restore_bit_exact(tmp_path):
    store = _tstore()
    head, tail = _batches(2, n_batches=8)[:4], _batches(2, n_batches=8)[4:]
    for b in head:
        store.apply(b)
    man = save_graph_checkpoint(tmp_path, store, incremental=True)
    assert man["kind"] == "full" and man["why_full"] == "no-base"
    fresh = _tstore()
    restore_graph_checkpoint(tmp_path, fresh)
    _assert_same(_sig(store), _sig(fresh), "full restore")
    for b in tail:
        store.apply(b)
    man = save_graph_checkpoint(tmp_path, store, max_delta_frac=0.9)
    assert man["kind"] == "delta", man["why_full"]
    fresh = _tstore()
    restore_graph_checkpoint(tmp_path, fresh)
    _assert_same(_sig(store), _sig(fresh), "delta restore")
    assert fresh.stats["ops_applied"] == store.stats["ops_applied"]


def test_checkpoint_across_defrag_falls_back_to_full(tmp_path):
    store = _tstore()
    for b in _batches(10, n_batches=4):
        store.apply(b)
    man0 = save_graph_checkpoint(tmp_path, store)
    assert man0["kind"] == "full"
    store.graph.defrag()                    # rows recycled, extents move
    for b in _batches(11, n_batches=2):
        store.apply(b)
    man1 = save_graph_checkpoint(tmp_path, store, max_delta_frac=0.9)
    assert man1["kind"] == "full"
    assert man1["why_full"] == Reason.DEFRAG.value == "defrag"
    assert man1["defrags"] != man0["defrags"]
    fresh = _tstore()
    restore_graph_checkpoint(tmp_path, fresh)
    _assert_same(_sig(store), _sig(fresh), "post-defrag full restore")


def test_checkpoint_rejects_corrupt_members(tmp_path):
    store = _tstore()
    for b in _batches(4):
        store.apply(b)
    man = save_graph_checkpoint(tmp_path, store)
    corrupt_checkpoint_array(_dir_of(tmp_path, man["ckpt_id"]), "pool/dst")
    assert latest_recoverable(tmp_path) is None
    with pytest.raises(CheckpointError) as ei:
        restore_graph_checkpoint(tmp_path, _tstore(), man["ckpt_id"])
    assert ei.value.code is Reason.CKPT_BAD_CRC
    with pytest.raises(CheckpointError) as ei:
        restore_graph_checkpoint(tmp_path, _tstore())
    assert ei.value.code is Reason.CKPT_MISSING


@pytest.mark.parametrize("damage", ["corrupt", "torn-dir"])
def test_recovery_falls_back_to_older_chain(damage, tmp_path):
    """A flipped byte in the newest checkpoint, or its manifest gone:
    recovery falls back to the previous chain, replays the WAL suffix
    and matches the control exactly."""
    batches = _batches(7 if damage == "corrupt" else 8, n_batches=9)
    store = DurableStore(_tstore(), tmp_path, group_commit=1,
                         checkpoint_every=3)
    for b in batches:
        store.apply(b)      # checkpoints at batches 3, 6, 9
    store.close()
    ids = checkpoint_ids(tmp_path)
    assert len(ids) >= 2
    if damage == "corrupt":
        corrupt_checkpoint_array(_dir_of(tmp_path, ids[-1]), "pool/dst")
    else:
        tear_checkpoint(_dir_of(tmp_path, ids[-1]))
    rec, report = recover(tmp_path, _tstore)
    assert report["checkpoint"] == ids[-2]
    if damage == "corrupt":
        assert ids[-1] in report["truncated_ckpts"]
    ctrl = _tstore()
    for b in batches:
        ctrl.apply(b)
    _assert_same(_sig(ctrl), _sig(rec), f"{damage} fallback")


def test_torn_wal_recovery_parity(tmp_path):
    batches = _batches(5, n_batches=8)
    inj = FaultInjector(fail_after_records=5, torn_bytes=13)
    store = DurableStore(_tstore(), tmp_path, group_commit=1, injector=inj)
    with pytest.raises(InjectedCrash):
        for b in batches:
            store.apply(b)
    assert inj.crashed
    rec, report = recover(tmp_path, _tstore)
    assert report["wal_tail"] is Reason.WAL_TORN
    assert report["last_seq"] == 4
    ctrl = _tstore()
    for b in batches[:5]:
        ctrl.apply(b)
    _assert_same(_sig(ctrl), _sig(rec), "torn-WAL recovery")
    for b in batches[5:]:
        rec.apply(b)
        ctrl.apply(b)
    rec.sync()
    rec.close()
    rec2, report2 = recover(tmp_path, _tstore)
    assert report2["gap_at"] is None
    _assert_same(_sig(ctrl), _sig(rec2), "second recovery")


def test_group_commit_tail_loss_is_bounded(tmp_path):
    batches = _batches(6, n_batches=7)
    store = DurableStore(_tstore(), tmp_path, group_commit=4)
    for b in batches:
        store.apply(b)
    store.wal._f.flush()
    seg = store.wal.path
    synced = (len(batches) // 4) * 4
    keep = 8 + sum(len(twal.encode_record(i, b))
                   for i, b in enumerate(batches[:synced]))
    with open(seg, "r+b") as f:
        f.truncate(keep)
    rec, report = recover(tmp_path, _tstore)
    assert report["last_seq"] == synced - 1
    ctrl = _tstore()
    for b in batches[:synced]:
        ctrl.apply(b)
    _assert_same(_sig(ctrl), _sig(rec), "group-commit tail loss")


def test_crash_at_group_commit_boundary(tmp_path):
    batches = _batches(9, n_batches=5)
    inj = FaultInjector(fail_on_sync=True)
    store = DurableStore(_tstore(), tmp_path, group_commit=3, injector=inj)
    with pytest.raises(InjectedCrash):
        for b in batches:
            store.apply(b)
    store.wal._f.close()
    rec, report = recover(tmp_path, _tstore)
    survived = report["last_seq"] + 1
    assert 0 <= survived <= 3
    ctrl = _tstore()
    for b in batches[:survived]:
        ctrl.apply(b)
    _assert_same(_sig(ctrl), _sig(rec), "crash-at-sync recovery")


def test_durable_store_refuses_unsupported_ops_before_logging(tmp_path):
    store = DurableStore(_tstore(), tmp_path)
    store.inner.supported_ops = frozenset(("edges",))
    from repro_torch.api import UnsupportedOpError
    with pytest.raises(UnsupportedOpError):
        store.apply(OpBatch.add_vertices(np.arange(4, dtype=np.uint64)))
    assert store.stats["wal_records"] == 0
    store.sync()
    assert read_wal(store.wal.path).records == []
    assert store.backend == "durable+local"


def test_restore_invalidates_warm_analytics(tmp_path):
    store = _tstore()
    rng = np.random.default_rng(12)
    ids = rng.choice(2 ** 32, 32, replace=False).astype(np.uint64)
    s, d = ids[rng.integers(0, 32, 80)], ids[rng.integers(0, 32, 80)]
    w = rng.uniform(1.0, 2.0, 80).astype(np.float32)
    store.apply(OpBatch.edges(np.concatenate([s, d]), np.concatenate([d, s]),
                              np.concatenate([w, w])))
    op = AnalyticsOp("wcc", {})
    warm = store.analytics_result(op, store.capture())
    save_graph_checkpoint(tmp_path, store)
    restore_graph_checkpoint(tmp_path, store)
    s2, d2 = ids[rng.integers(0, 32, 20)], ids[rng.integers(0, 32, 20)]
    w2 = rng.uniform(1.0, 2.0, 20).astype(np.float32)
    store.apply(OpBatch.edges(np.concatenate([s2, d2]),
                              np.concatenate([d2, s2]),
                              np.concatenate([w2, w2])))
    cur = store.capture()
    ri = store.analytics_advance(op, warm, cur)
    assert (ri.mode, ri.reason) == ("scratch", Reason.RESTORE_BOUNDARY)
    assert ri.value == store.analytics_result(op, cur).value
    warm2 = store.analytics_result(op, cur)
    store.apply(OpBatch.edges(ids[:1], ids[1:2],
                              np.full(1, 1.5, np.float32)))
    ri2 = store.analytics_advance(op, warm2, store.capture())
    assert ri2.mode == "incremental", ri2.reason


# ---- the query service over a durable store ----

def test_service_durable_ack_syncs_before_reads(tmp_path):
    from repro_torch.serve import GraphQueryService
    store = DurableStore(_tstore(), tmp_path, group_commit=64)
    svc = GraphQueryService(store)
    assert svc.durable_ack
    rng = np.random.default_rng(14)
    ids = rng.choice(2 ** 32, 32, replace=False).astype(np.uint64)
    for _ in range(3):
        svc.submit_update(rng.choice(ids, 16), rng.choice(ids, 16),
                          rng.uniform(0.5, 2, 16).astype(np.float32))
        svc.step()
    assert svc.stats["durable_syncs"] == 3
    assert store.stats["wal_syncs"] >= 3
    scan = read_wal(store.wal.path)
    assert scan.tail is Reason.OK and len(scan.records) == 3
    assert GraphQueryService(_tstore()).durable_ack is False


# ---- the subprocess kill harness ----

def test_crash_smoke_subprocess_on_cpu():
    from repro_torch.storage.crash_smoke import main
    assert main(["--seed", "1", "--ops", "2048", "--batch", "256",
                 "--group-commit", "4", "--device", "cpu"]) == 0


def test_crash_smoke_needs_its_device():
    """Asked for the card without one, the smoke raises instead of
    running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.storage.crash_smoke import main
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--ops", "512"])
