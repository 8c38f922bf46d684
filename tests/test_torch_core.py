"""SORT, vertex table and edge pool of the port against the JAX package.

The same inputs, made from a seed with numpy, go through both packages;
every state leaf is compared after each batch. All compared outputs are
integers or copied floats, so the tolerance is bit-exact (atol = 0).
The JAX side runs as its own tests run it on the CPU: its kernel impls
resolve to the jnp reference there, so ``append_impl='pallas'`` on the
JAX side is ``append_ref`` and the port's fused path runs the plain
version of its kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edgepool as jep
from repro.core import sort as JS
from repro.core import vertex_table as JV
from repro.core.keys import pack_keys as jpack
from repro.core.radixgraph import RadixGraph as JG
from repro.core.sort_optimizer import optimize_sort
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import edgepool as tep
from repro_torch.core import sort as TS
from repro_torch.core import tensor_ops as tops
from repro_torch.core import vertex_table as TV
from repro_torch.core.keys import pack_keys as tpack
from repro_torch.core.radixgraph import RadixGraph as TG


def _named(tree):
    s, vt, pool = tree
    out = {f"sort.pools[{i}]": np.asarray(p) for i, p in enumerate(s.pools)}
    out["sort.counts"] = np.asarray(s.counts)
    out["sort.overflow"] = np.asarray(s.overflow)
    for f in vt._fields:
        out["vt." + f] = np.asarray(getattr(vt, f))
    for f in pool._fields:
        out["pool." + f] = np.asarray(getattr(pool, f))
    return out


def assert_same_state(jstate, tstate, where=""):
    a = _named(jax.tree.map(np.asarray, jstate))
    b = _named(state_to_numpy(tstate))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k, a[k].dtype, b[k].dtype)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where}: {k}")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- SORT ----

def test_sort_insert_delete_reinsert_parity():
    """Random insert / delete / re-insert streams, with node pools sized
    tight enough to overflow: pools, counts, overflow and lookups agree
    after every step."""
    rng = np.random.default_rng(0)
    cfg = optimize_sort(400, 24, 4)
    jspec = JS.SortSpec.from_config(cfg, 600, capacity_factor=0.3)
    tspec = TS.SortSpec.from_config(cfg, 600, capacity_factor=0.3)
    assert jspec.node_caps == tspec.node_caps
    jst, tst = JS.make_sort(jspec), TS.make_sort(tspec, "cpu")
    universe = rng.choice(2 ** 24, 700, replace=False).astype(np.uint64)
    for step in range(8):
        ids = rng.choice(universe, 128)
        mask = rng.random(128) < 0.8
        if step % 3 == 2:
            jst, joff, jfound = JS.delete_keys(jspec, jst, jpack(ids, 24),
                                               jnp.asarray(mask))
            tst, toff, tfound = TS.delete_keys(
                tspec, tst, tpack(ids, 24, "cpu"), _t(mask))
            np.testing.assert_array_equal(np.asarray(jfound), tfound.numpy())
        else:
            # duplicate keys in a batch carry identical offsets
            offs = (np.searchsorted(np.sort(universe), ids) % 97).astype(
                np.int32)
            jst = JS.insert_mappings(jspec, jst, jpack(ids, 24),
                                     jnp.asarray(offs), jnp.asarray(mask))
            tst = TS.insert_mappings(tspec, tst, tpack(ids, 24, "cpu"),
                                     _t(offs), _t(mask))
        for a, b in zip(jst.pools, tst.pools):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(jst.counts),
                                      tst.counts.numpy())
        assert int(jst.overflow) == int(tst.overflow)
        q = rng.choice(universe, 256)
        np.testing.assert_array_equal(
            np.asarray(JS.lookup(jspec, jst, jpack(q, 24))),
            TS.lookup(tspec, tst, tpack(q, 24, "cpu")).numpy())
    assert int(tst.overflow) > 0          # the capacity case was reached
    assert int(TS.materialized_slots(tspec, tst)) == \
        int(JS.materialized_slots(jspec, jst))


def test_vertex_table_parity_with_overflow():
    """ensure_vertices / delete_vertices on both sides, with intra-batch
    duplicates and a table too small for the stream."""
    rng = np.random.default_rng(1)
    n_cap = 96
    cfg = optimize_sort(n_cap, 20, 3)
    jspec = JS.SortSpec.from_config(cfg, n_cap)
    tspec = TS.SortSpec.from_config(cfg, n_cap)
    jst, tst = JS.make_sort(jspec), TS.make_sort(tspec, "cpu")
    jvt = JV.make_vertex_table(n_cap)
    tvt = TV.make_vertex_table(n_cap, "cpu")
    for step in range(6):
        ids = rng.integers(0, 2 ** 20, 64).astype(np.uint64)
        ids[32:48] = ids[:16]                       # duplicates
        mask = rng.random(64) < 0.9
        if step == 3:
            ts = jnp.int32(7)
            jst, jvt, joff, jok = JV.delete_vertices(
                jspec, jst, jvt, jpack(ids, 20), jnp.asarray(mask), ts)
            tst, tvt, toff, tok = TV.delete_vertices(
                tspec, tst, tvt, tpack(ids, 20, "cpu"), _t(mask),
                torch.tensor(7, dtype=torch.int32))
        else:
            jst, jvt, joff, jok = JV.ensure_vertices(
                jspec, jst, jvt, jpack(ids, 20), jnp.asarray(mask))
            tst, tvt, toff, tok = TV.ensure_vertices(
                tspec, tst, tvt, tpack(ids, 20, "cpu"), _t(mask))
        np.testing.assert_array_equal(np.asarray(joff), toff.numpy())
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
        for f in jvt._fields:
            a = np.asarray(getattr(jvt, f))
            b = getattr(tvt, f).numpy()
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=f)
    assert int(tvt.overflow) > 0


# ----------------------------------------------------------- edge pool ----

BASE = dict(n_max=128, key_bits=16, expected_n=64, batch=64,
            pool_blocks=384, block_size=8, dmax=64, k_max=8, k_big=2,
            probe_width=16, pipeline_depth=1)


def _waves(seed=0):
    """Batches that walk every branch: first touch, in-window and
    full-width compaction, a batch with more than k_big wide overflows
    (the streaming rebuild), a hub past dmax (the dense rebuild), vertex
    deletes, re-inserts after the free ring refilled, and tombstones."""
    rng = np.random.default_rng(seed)
    B = BASE["batch"]
    out = []

    def mixed(n_src, n_dst, p_del=0.25, src=None):
        s = rng.integers(0, n_src, B).astype(np.uint64) if src is None \
            else src
        d = rng.integers(0, n_dst, B).astype(np.uint64)
        w = rng.uniform(0.5, 2, B).astype(np.float32)
        w[rng.random(B) < p_del] = 0.0
        return ("edges", s, d, w)

    for _ in range(3):
        out.append(mixed(40, 60))
    for _ in range(5):                  # six medium hubs grow together
        out.append(mixed(0, 100, 0.1,
                         src=np.repeat(np.arange(6), B // 6 + 1)[:B]
                         .astype(np.uint64)))
    out.append(("delete_vertices", np.array([3, 41, 42, 50], np.uint64)))
    out.append(mixed(60, 60))
    out.append(mixed(0, 120, 0.0, src=np.full(B, 7, np.uint64)))  # hub
    out.append(mixed(0, 120, 0.0, src=np.full(B, 7, np.uint64)))
    out.append(("add_vertices", np.array([3, 41, 42, 50, 99], np.uint64)))
    out.append(mixed(80, 80))
    out.append(("add_vertices", np.arange(101, 106, dtype=np.uint64)))
    out.append(mixed(110, 110))
    return out


def _apply(g, op):
    if op[0] == "edges":
        g.apply_ops(*op[1:])
    elif op[0] == "add_vertices":
        g.add_vertices(op[1])
    else:
        g.delete_vertices(op[1])


@pytest.mark.parametrize("policy,append_impl,defrag_impl", [
    ("snaplog", "pallas", "auto"), ("snaplog", "ref", "auto"),
    ("snaplog", "pallas", "dense"), ("grow", "pallas", "auto"),
    ("grow", "ref", "auto"), ("sorted", "pallas", "auto"),
    ("sorted", "ref", "auto")])
def test_graph_state_parity_every_batch(policy, append_impl, defrag_impl):
    """Every GraphState leaf bit-exact after each batch, across the three
    policies, both append branches and both rebuilds, with the host
    branches (defrag vs fast path, streaming chunk skips) exercised."""
    # one config updates the port's state in place; the rest copy before
    # every batch (and JAX then compiles one program instead of two)
    donate = (policy, append_impl, defrag_impl) == ("snaplog", "pallas",
                                                    "auto")
    kw = dict(BASE, policy=policy, append_impl=append_impl,
              defrag_impl=defrag_impl, donate_apply=donate)
    jg, tg = JG(**kw), TG(device="cpu", **kw)
    s0 = dict(tep.SYNCS)
    for i, op in enumerate(_waves()):
        _apply(jg, op)
        _apply(tg, op)
        assert_same_state(jg.state, tg.state, f"batch {i} ({op[0]})")
    assert jg.num_edges == tg.num_edges
    assert int(tg.state.pool.defrags) >= 2
    # one host sync per edge batch (the defrag-vs-fast-path branch) plus
    # one per rebuild
    n_edge_batches = sum(op[0] == "edges" for op in _waves())
    assert tep.SYNCS["host_syncs"] - s0["host_syncs"] >= n_edge_batches
    if defrag_impl == "auto" and policy == "snaplog":
        # the hub past dmax, which sends JAX to its dense rebuild, streams
        # through the port's wide tier
        assert tep.SYNCS["defrag_stream"] > s0["defrag_stream"]
        assert tep.SYNCS["defrag_wide"] > s0["defrag_wide"]
        assert tep.SYNCS["defrag_dense"] == s0["defrag_dense"]
        assert int(tg.state.vt.free_head) > 0     # free-ring reuse
    if defrag_impl == "dense":
        assert tep.SYNCS["defrag_dense"] > s0["defrag_dense"]


def test_large_scatter_path_parity(monkeypatch):
    """Scatters of ``SYNC_ROWS`` rows or more (full-pool rebuilds,
    snapshots) drop masked rows with one host sync instead of redirecting
    them; forcing that path on every scatter leaves the same states."""
    monkeypatch.setattr(tops, "SYNC_ROWS", 1)
    test_graph_state_parity_every_batch("snaplog", "pallas", "auto")


def test_table_and_pool_exhaustion_parity():
    """A vertex table and a pool too small for the stream: drops, overflow
    counters and the rebuild that lays extents past the pool end (whose
    writes JAX drops) agree leaf for leaf."""
    kw = dict(BASE, pool_blocks=24, n_max=48, append_impl="pallas")
    jg, tg = JG(**kw), TG(device="cpu", **kw)
    past_end = False
    for i, op in enumerate(_waves(3)[:9]):
        _apply(jg, op)
        _apply(tg, op)
        assert_same_state(jg.state, tg.state, f"batch {i}")
        past_end |= int(tg.state.pool.next_block) > kw["pool_blocks"]
    assert tg.overflowed and tg.dropped_ops == jg.dropped_ops > 0
    assert past_end


def test_fold_bitmap_matches_jax():
    """The compaction fold: the port's int64 words hold the same uint32
    bit patterns as JAX's bitmap, and pool / table updates agree."""
    kw = dict(BASE, append_impl="pallas")
    jg = JG(**kw)
    for op in _waves()[:5]:
        _apply(jg, op)
    spec_j, n_cap = jg.pool_spec, BASE["n_max"]
    tstate = state_from_numpy(jax.tree.map(np.asarray, jg.state), "cpu")
    spec_t = TG(device="cpu", **kw).pool_spec
    ku = np.array([0, 1, 2, 5, -1], np.int32)
    kmask = ku >= 0
    kinc = np.array([3, 20, 1, 9, 0], np.int32)
    jp, jv, jfk, jbm = jep._compact_vertices(
        spec_j, jg.state.pool, jg.state.vt, jnp.asarray(ku),
        jnp.asarray(kmask), jnp.asarray(kinc), spec_j.dmax, fold=True)
    tp, tv, tfk, tbm = tep._compact_vertices(
        spec_t, tstate.pool, tstate.vt, _t(ku), _t(kmask), _t(kinc),
        spec_t.dmax, fold=True)
    assert np.asarray(jbm).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(jbm).astype(np.int64),
                                  tbm.numpy())
    assert np.asarray(jbm).any()
    np.testing.assert_array_equal(np.asarray(jfk), tfk.numpy())
    assert_same_state(type(jg.state)(jg.state.sort, jv, jp),
                      type(tstate)(tstate.sort, tv, tp), "fold")


def _state_for_rebuild(kind, policy):
    """A JAX graph whose next rebuild JAX runs densely: ``wide`` holds a
    hub past ``dmax``; ``budget`` holds more rows of 9-64 entries than
    that size segment's static budget (64, at n_cap = 256)."""
    if kind == "wide":
        kw = dict(BASE, policy=policy, append_impl="pallas")
        jg = JG(**kw)
        for op in _waves()[:12]:
            _apply(jg, op)
        return kw, jg
    kw = dict(BASE, policy=policy, append_impl="pallas", n_max=256,
              expected_n=200, batch=256, pool_blocks=2048)
    jg = JG(**kw)
    rng = np.random.default_rng(11)
    src = rng.permutation(np.repeat(np.arange(100), 14)).astype(np.uint64)
    dst = rng.integers(0, 200, src.size).astype(np.uint64)
    w = rng.uniform(0.5, 2, src.size).astype(np.float32)
    w[rng.random(src.size) < 0.1] = 0.0
    jg.apply_ops(src, dst, w)
    return kw, jg


@pytest.mark.parametrize("kind", ["wide", "budget"])
@pytest.mark.parametrize("policy", ["snaplog", "grow", "sorted"])
def test_defrag_streams_where_jax_rebuilds_densely(kind, policy):
    """JAX's ``defrag`` takes its dense rebuild on these states; the port's
    auto ``defrag`` streams (the wide tier, or extra chunks past a
    segment's budget) and leaves the same pool and vertex table, leaf for
    leaf, with pending ``incoming`` ops."""
    kw, jg = _state_for_rebuild(kind, policy)
    spec_j = jg.pool_spec
    spec_t = TG(device="cpu", **kw).pool_spec
    tstate = state_from_numpy(jax.tree.map(np.asarray, jg.state), "cpu")
    vt = tstate.vt
    n_cap = vt.size.shape[0]
    live = ((vt.del_time == 0) & (vt.start_block >= 0)).numpy()
    size = vt.size.numpy()
    tiers = tep._defrag_tiers(spec_t, n_cap)
    if kind == "wide":
        assert size[live].max() > tiers[-1][0]
    else:
        (_, _), (W1, B1) = tiers[:2]
        assert (live & (size > tiers[0][0]) & (size <= W1)).sum() > B1
    inc = np.random.default_rng(3).integers(0, 20, n_cap).astype(np.int32)
    jp, jv = jep.defrag(spec_j, jg.state.pool, jg.state.vt, jnp.asarray(inc))
    s0 = dict(tep.SYNCS)
    tp, tv = tep.defrag(spec_t, tstate.pool, tstate.vt, _t(inc))
    assert tep.SYNCS["defrag_stream"] == s0["defrag_stream"] + 1
    assert tep.SYNCS["defrag_dense"] == s0["defrag_dense"]
    assert tep.SYNCS["defrag_wide"] == s0["defrag_wide"] + (kind == "wide")
    if kind == "wide":      # the wide tier it ran: every extent past the
        bs = spec_t.block_size  # top segment, as wide as the widest
        assert tep.DEFRAG_WIDE == dict(
            width=-(-int(size[live].max()) // bs) * bs,
            rows=int((live & (size > tiers[-1][0])).sum()))
    assert_same_state(type(jg.state)(jg.state.sort, jv, jp),
                      type(tstate)(tstate.sort, tv, tp), f"{kind} defrag")
    assert int(tp.live_m) > 0


def test_pipelined_steps_equal_sequential_steps():
    """``fuse_scan`` (one stacked super-batch per flush, a loop of
    ``step_update_edges``) leaves the same state as flat batches."""
    kw = dict(BASE, pipeline_depth=4)
    a = TG(device="cpu", fuse_scan=True, **kw)
    b = TG(device="cpu", fuse_scan=False, **kw)
    rng = np.random.default_rng(5)
    n = 7 * BASE["batch"] + 13                  # ragged tail
    src = rng.integers(0, 50, n).astype(np.uint64)
    dst = rng.integers(0, 50, n).astype(np.uint64)
    w = rng.uniform(0.5, 2, n).astype(np.float32)
    w[rng.random(n) < 0.25] = 0
    a.apply_ops(src, dst, w)
    b.apply_ops(src, dst, w)
    for x, y in zip(jax.tree.leaves(state_to_numpy(a.state)),
                    jax.tree.leaves(state_to_numpy(b.state))):
        np.testing.assert_array_equal(x, y)
    assert a.pipe_super_batches == b.pipe_super_batches == 2


# ------------------------------------- translations that silently diverge --

def test_drop_scatter_ignores_sentinel_targets():
    """``.at[idx].set(v, mode='drop')`` with an out-of-range sentinel:
    the port masks instead of raising or writing."""
    idx = np.array([0, 5, 9, 3, -1, 2], np.int32)       # 9 == len: sentinel
    val = np.arange(6, dtype=np.int32) + 10
    ok = (idx >= 0) & (idx < 9)
    exp = np.asarray(jnp.zeros(9, jnp.int32).at[jnp.asarray(
        np.where(ok, idx, 9))].set(jnp.asarray(val), mode="drop"))
    got = tops.scatter_set_(torch.zeros(9, dtype=torch.int32), _t(idx),
                            _t(val), _t(ok))
    np.testing.assert_array_equal(exp, got.numpy())
    none = tops.scatter_set_(torch.arange(4), _t(np.array([7, 8])),
                             _t(np.array([1, 1])), _t(np.array([0, 0], bool)))
    assert none.tolist() == [0, 1, 2, 3]
    add = tops.scatter_add_(torch.zeros(4, dtype=torch.int32),
                            _t(np.array([1, 1, 4])), 1,
                            _t(np.array([1, 1, 0], bool)))
    assert add.tolist() == [0, 2, 0, 0]


def test_duplicate_targets_with_equal_values():
    """Duplicate targets carrying equal values (vertex-table row init, the
    SORT leaf write) land once, as in JAX."""
    idx = _t(np.array([2, 2, 5, 5, 5], np.int64))
    got = tops.scatter_set_(torch.full((6,), -1), idx,
                            _t(np.array([7, 7, 4, 4, 4])),
                            torch.ones(5, dtype=torch.bool))
    assert got.tolist() == [-1, -1, 7, -1, -1, 4]


def test_clamping_gathers_match_jax():
    """JAX clamps out-of-range gathers; the port clips explicitly. A
    lookup of IDs whose descent walks off populated nodes, and a neighbor
    read of absent vertices (offset -1), agree."""
    kw = dict(BASE, append_impl="pallas")
    jg, tg = JG(**kw), TG(device="cpu", **kw)
    op = _waves()[0]
    _apply(jg, op)
    _apply(tg, op)
    q = np.array([0, 1, 2, 999, 65535, 40000], np.uint64)
    np.testing.assert_array_equal(jg.lookup(q), tg.lookup(q))
    for (a_id, a_w), (b_id, b_w) in zip(jg.neighbors(q), tg.neighbors(q)):
        np.testing.assert_array_equal(a_id, b_id)
        np.testing.assert_array_equal(a_w, b_w)


def test_stable_sorts_and_static_nonzero():
    """``jnp.lexsort`` and ``argsort`` keep ties in input order;
    ``jnp.nonzero(size=, fill_value=)`` pads to a static size."""
    rng = np.random.default_rng(2)
    a, b, c = (rng.integers(0, 4, 200).astype(np.int32) for _ in range(3))
    np.testing.assert_array_equal(
        np.asarray(jnp.lexsort((jnp.asarray(c), jnp.asarray(b),
                                jnp.asarray(a)))),
        tops.lexsort((_t(c), _t(b), _t(a))).numpy())
    np.testing.assert_array_equal(
        np.asarray(jnp.argsort(jnp.asarray(a))),
        torch.argsort(_t(a), stable=True).numpy())
    m = rng.random(50) < 0.3
    for size, fill in ((50, 50), (5, 50), (80, -1)):
        exp = np.asarray(jnp.nonzero(jnp.asarray(m), size=size,
                                     fill_value=fill)[0])
        np.testing.assert_array_equal(
            exp, tops.nonzero_static(_t(m), size, fill).numpy())


def test_elementwise_translations():
    """cummax, searchsorted(side='right'), repeat, and floor division /
    remainder on negative ints."""
    rng = np.random.default_rng(4)
    x = rng.integers(-20, 20, 64).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jax.lax.cummax(jnp.asarray(x))),
        torch.cummax(_t(x), 0).values.numpy())
    ends = np.cumsum(rng.integers(0, 4, 16)).astype(np.int32)
    r = np.arange(70, dtype=np.int32)
    np.testing.assert_array_equal(
        np.asarray(jnp.searchsorted(jnp.asarray(ends), jnp.asarray(r),
                                    side="right")),
        torch.searchsorted(_t(ends), _t(r), right=True).numpy())
    np.testing.assert_array_equal(np.asarray(jnp.repeat(jnp.asarray(x), 3)),
                                  _t(x).repeat_interleave(3).numpy())
    np.testing.assert_array_equal(np.asarray(jnp.asarray(x) // 7),
                                  (_t(x) // 7).numpy())
    np.testing.assert_array_equal(np.asarray(jnp.asarray(x) % 7),
                                  torch.remainder(_t(x), 7).numpy())
    np.testing.assert_array_equal(
        np.asarray(tops.cdiv(jnp.asarray(x), 8)), tops.cdiv(_t(x), 8).numpy())


def test_pinned_state_is_copied_not_mutated():
    """In-place updates vs MVCC: a checkpointed version keeps its contents
    while the live state moves on, and reads at its timestamp agree with
    JAX."""
    kw = dict(BASE, append_impl="pallas")
    jg, tg = JG(**kw), TG(device="cpu", **kw)
    waves = _waves(6)
    for op in waves[:3]:
        _apply(jg, op)
        _apply(tg, op)
    ts_j, ts_t = jg.checkpoint_version(), tg.checkpoint_version()
    assert ts_j == ts_t
    kept = state_to_numpy(tg._versions[0][2])
    copies = tg.state_copies
    for op in waves[3:8]:
        _apply(jg, op)
        _apply(tg, op)
    assert tg.state_copies == copies + 1        # one copy, then in place
    for x, y in zip(jax.tree.leaves(kept),
                    jax.tree.leaves(state_to_numpy(tg._versions[0][2]))):
        np.testing.assert_array_equal(x, y)
    a, b = jg.snapshot_at(ts_j), tg.snapshot_at(ts_t)
    for f in ("indptr", "dst", "weight", "m", "active"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy(), err_msg=f)
