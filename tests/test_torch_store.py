"""The slice as a whole: ``make_store('local')`` in both packages.

Both stores are built from ONE kwargs dict (the port's also gets
``device='cpu'``) and driven by the same mixed stream, made from a seed
with numpy: 25% tombstones, directed and undirected, ``pipeline_depth``
flushes with a ragged tail, a vertex delete that dirties the live-edge
counter, and an epoch captured before further applies. Every ``ReadOp``
kind, live and ``at=`` the epoch, is compared; all compared outputs are
integers or copied floats, so the tolerance is bit-exact (atol = 0).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.api import OpBatch as JOp
from repro.api import ReadOp as JRead
from repro.api import make_store as jmake
from repro.core.radixgraph import RadixGraph as JG
from repro_torch.api import (AnalyticsOp, OpBatch, ReadOp, available_backends,
                             make_store)
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import edgepool as TE
from repro_torch.core import sort as TS
from repro_torch.core import vertex_table as TV
from repro_torch.core.keys import pack_keys as tpack_keys
from repro_torch.core.radixgraph import RadixGraph as TG

KW = dict(n_max=2048, key_bits=32, expected_n=256, batch=128,
          pool_blocks=4096, block_size=8, dmax=256, k_max=16, k_big=4,
          probe_width=32, pipeline_depth=3, append_impl="pallas")
KINDS = ("lookup", "degree", "neighbors", "num_vertices", "num_edges",
         "snapshot")
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _stream(seed, n):
    rng = np.random.default_rng(seed)
    ids = rng.choice(2 ** 32, 300, replace=False).astype(np.uint64)
    p = 1.0 / np.arange(1, 301) ** 0.8
    p /= p.sum()
    src = ids[rng.choice(300, n, p=p)]
    dst = ids[rng.choice(300, n, p=p)]
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.random(n) < 0.25] = 0.0
    return ids, src, dst, w


def _read_all(store, ids, at=None):
    return {kind: store.read(ReadOp(kind, ids=ids) if kind in (
        "lookup", "degree", "neighbors") else ReadOp(kind), at=at)
        for kind in KINDS}


def _norm(kind, v):
    """A read answer as plain numpy, JAX and port alike."""
    if kind == "neighbors":
        return [(np.asarray(a), np.asarray(b)) for a, b in v]
    if kind == "snapshot":
        d = {f: np.asarray(getattr(v, f)) for f in v._fields}
        d["ids"] = d["ids"].astype(np.int64)
        return d
    return np.asarray(v)


def _assert_same(kind, a, b):
    a, b = _norm(kind, a), _norm(kind, b)
    if kind == "neighbors":
        assert len(a) == len(b)
        for (ia, wa), (ib, wb) in zip(a, b):
            assert ia.dtype == ib.dtype == np.uint64
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(wa, wb)
    elif kind == "snapshot":
        assert a.keys() == b.keys()
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module", params=[False, True],
                ids=["directed", "undirected"])
def run(request):
    undirected = request.param
    ids, src, dst, w = _stream(7 if undirected else 3, 2000)
    js = jmake("local", undirected=undirected, **KW)
    ts = make_store("local", device="cpu", undirected=undirected, **KW)
    for lo, hi in ((0, 700), (700, 1300)):
        for s in (js, ts):
            s.apply((JOp if s is js else OpBatch).edges(
                src[lo:hi], dst[lo:hi], w[lo:hi]))
    je, te = js.capture(), ts.capture()
    t_before = _read_all(ts, ids, at=te)
    dead = ids[[1, 5, 40]]
    for s in (js, ts):
        s.apply((JOp if s is js else OpBatch).delete_vertices(dead))
        s.apply((JOp if s is js else OpBatch).edges(src[1300:], dst[1300:],
                                                    w[1300:]))
    return dict(js=js, ts=ts, je=je, te=te, ids=ids, t_before=t_before)


@pytest.mark.parametrize("kind", KINDS)
def test_live_reads_match_jax(run, kind):
    ids = run["ids"]
    op = lambda R: R(kind, ids=ids) if kind in (  # noqa: E731
        "lookup", "degree", "neighbors") else R(kind)
    _assert_same(kind, run["js"].read(op(JRead)), run["ts"].read(op(ReadOp)))


@pytest.mark.parametrize("kind", KINDS)
def test_epoch_reads_match_jax_after_further_applies(run, kind):
    """Reads ``at=`` an epoch captured before more applies agree with JAX
    and with what the port answered at capture time: the in-place updates
    never touch a captured state."""
    ids = run["ids"]
    op = lambda R: R(kind, ids=ids) if kind in (  # noqa: E731
        "lookup", "degree", "neighbors") else R(kind)
    t_now = run["ts"].read(op(ReadOp), at=run["te"])
    _assert_same(kind, run["js"].read(op(JRead), at=run["je"]), t_now)
    _assert_same(kind, run["t_before"][kind], t_now)


def test_state_and_counters_match_jax(run):
    js, ts = run["js"], run["ts"]
    a = jax.tree.leaves(jax.tree.map(np.asarray, js.graph.state))
    b = jax.tree.leaves(state_to_numpy(ts.graph.state))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for k in ("ops_applied", "ops_dropped", "defrags", "tiles_scanned",
              "flushes", "super_batches"):
        assert js.stats[k] == ts.stats[k], k
    assert js.clock() == ts.clock() and js.clock(run["je"]) == \
        ts.clock(run["te"])
    assert ts.read(ReadOp("num_edges")) == js.read(JRead("num_edges")) > 0


def test_dirty_counter_recount_matches_jax():
    """A vertex delete dirties ``live_m``; ``num_edges`` recounts from the
    snapshot and writes the exact value back, on both sides."""
    ids, src, dst, w = _stream(11, 600)
    js = jmake("local", **KW)
    ts = make_store("local", device="cpu", **KW)
    for s, Op in ((js, JOp), (ts, OpBatch)):
        s.apply(Op.edges(src, dst, w))
        s.apply(Op.delete_vertices(ids[:3]))
    assert int(ts.graph.state.pool.live_dirty) == 1
    assert ts.read(ReadOp("num_edges")) == js.read(JRead("num_edges"))
    assert int(ts.graph.state.pool.live_dirty) == 0
    assert int(ts.graph.state.pool.live_m) == int(js.graph.state.pool.live_m)


def test_convert_round_trip_and_resume_from_jax_state():
    """``state_from_numpy`` / ``state_to_numpy`` round-trip a JAX state
    exactly, and both packages continue identically from it."""
    ids, src, dst, w = _stream(5, 900)
    kw = {k: v for k, v in KW.items() if k != "pipeline_depth"}
    jg = JG(**kw)
    jg.apply_ops(src[:500], dst[:500], w[:500])
    tree = jax.tree.map(np.asarray, jg.state)
    back = state_to_numpy(state_from_numpy(tree, "cpu"))
    for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    tg = TG(device="cpu", **kw)
    tg.state = state_from_numpy(tree, "cpu")
    jg.apply_ops(src[500:], dst[500:], w[500:])
    tg.apply_ops(src[500:], dst[500:], w[500:])
    for x, y in zip(jax.tree.leaves(jax.tree.map(np.asarray, jg.state)),
                    jax.tree.leaves(state_to_numpy(tg.state))):
        np.testing.assert_array_equal(x, y)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.api import make_store\n"
        "import repro_torch.convert, repro_torch.kernels.ops\n"
        "import repro_torch.analytics, repro_torch.api.registry\n"
        "import repro_torch.core.epoch_delta, repro_torch.serve\n"
        "import repro_torch.analytics.incremental\n"
        "import repro_torch.storage, repro_torch.storage.crash_smoke\n"
        "import repro_torch.dist, repro_torch.dist.graph_engine\n"
        "import repro_torch.baselines, repro_torch.kernels.art\n"
        "import repro_torch.launch, repro_torch.launch.dryrun_graph\n"
        "import repro_torch.models, repro_torch.models.api\n"
        "import repro_torch.configs, repro_torch.serve.engine\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.models.ssm, repro_torch.models.rglru\n"
        "import repro_torch.models.layers, repro_torch.models.lm\n"
        "import repro_torch.train, repro_torch.train.optimizer\n"
        "import repro_torch.train.step, repro_torch.dist.compress\n"
        "import repro_torch.dist.sharding, repro_torch.checkpoint\n"
        "import repro_torch.data, repro_torch.launch.mesh\n"
        "import repro_torch.launch.train, repro_torch.tree\n"
        "import repro_torch.models.moe_a2a, repro_torch.launch.costs\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.dryrun_graph\n"
        "import repro_torch.dist.local_ops, repro_torch.dist.costs_hook\n"
        "for a in repro_torch.configs.ARCH_IDS:\n"
        "    repro_torch.configs.get_arch(a)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = dict(os.environ, REPRO_NO_JAX_SHIM="1", PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_default_device_needs_a_card():
    """The store, the facade and every state factory default to the card
    and raise without one instead of building state on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    tg = TG(device="cpu", n_max=64)
    tree = state_to_numpy(tg.state)
    for build in (lambda: make_store("local", n_max=64),
                  lambda: make_store("sharded", n_shards=2),
                  lambda: TG(n_max=64),
                  lambda: TS.make_sort(tg.sort_spec),
                  lambda: TV.make_vertex_table(64),
                  lambda: TE.make_edge_pool(tg.pool_spec),
                  lambda: tpack_keys([1, 2], 32),
                  lambda: state_from_numpy(tree)):
        with pytest.raises(RuntimeError, match="cuda"):
            build()


def test_later_slices_raise_and_registry(tmp_path):
    """The durability hooks round-trip the state (in memory and through a
    checkpoint directory); analytics answers."""
    kw = dict(device="cpu", n_max=256, expected_n=64, pool_blocks=256,
              batch=64)
    s = make_store("local", **kw)
    assert available_backends() == ["local", "sharded"]
    assert s.supported_ops == frozenset(("edges", "add_vertices",
                                         "delete_vertices"))
    s.apply(OpBatch.edges(np.array([1, 2], np.uint64),
                          np.array([2, 3], np.uint64)))
    state, meta = s.durable_state()
    assert meta == dict(seq=1, dropped_ops=0, seen_defrags=0,
                        ops_applied=2, ops_dropped=0)
    host = state_to_numpy(state)
    assert host.vt.ids.dtype == np.uint32
    for load in (lambda t: t.load_durable_state(host, meta),
                 lambda t: t.load_durable_state(state, meta),
                 lambda t: t.restore(tmp_path)):
        if not any(tmp_path.iterdir()):
            assert s.checkpoint(tmp_path)["kind"] == "full"
        t = make_store("local", **kw)
        e = t.capture()
        load(t)
        for a, b in zip(jax.tree.leaves(host),
                        jax.tree.leaves(state_to_numpy(t.graph.state))):
            np.testing.assert_array_equal(a, b)
        assert t.stats["ops_applied"] == 2 and t._seq == 1
        assert t.capture().cache["gen"] == 1 != e.cache["gen"]
        assert t.read(ReadOp("neighbors", ids=np.array([2], np.uint64)))[
            0][0].tolist() == [3]
        # the installed state is pinned: an apply copies it first
        t.apply(OpBatch.edges(np.array([3], np.uint64),
                              np.array([1], np.uint64)))
        assert t.graph.state_copies == 1
    assert s.analytics(AnalyticsOp("num_edges")) == 2
    assert s.analytics(AnalyticsOp("bfs", dict(source=1))) == {1: 0, 2: 1,
                                                               3: 2}
    e = s.capture()
    assert e.cache["gen"] == 0
    prev = s.analytics_result(AnalyticsOp("degree_map"), e)
    assert s.analytics_advance(AnalyticsOp("degree_map"), prev, e) is prev
    with pytest.raises(KeyError):
        make_store("mesh")          # not a registered backend
    assert make_store("sharded", device="cpu", n_shards=2).n_shards == 2
    e = s.capture()
    s.pin_epoch(e)
    assert s.retained_epochs == 1
    s.release_epoch(e)
    assert s.retained_epochs == 0
