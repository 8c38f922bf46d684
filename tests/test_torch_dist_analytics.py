"""The sharded engine's distributed analytics (``repro_torch.dist.
graph_engine``) against the JAX mesh programs (``repro.dist.graph_engine``)
on the same states.

The JAX side needs 4 devices: one subprocess, started by a module-scoped
fixture with ``--xla_force_host_platform_device_count=4`` set before JAX
touches a device, runs this file as a script. It builds three vertex-synced
4-shard states from one numpy-seeded, hub-heavy stream — ``early`` (one
sparse batch), ``full`` (three more batches, a rebuild among them, 10%
tombstones) and ``later`` (``full`` plus an insert-only batch) — runs every
program on ``early`` and ``full`` with ``frontier_budget`` None and
``BUDGET``, and writes the states' leaves, the answers and the epoch
deltas to one ``.npz``. The port loads the same states on the CPU
(``device="cpu"``: each kernel wrapper runs its plain version) and runs
its programs on them.

Tolerances: integers, depths, labels, SSSP distances and iteration counts
are exact; PageRank within 1e-5 absolute and BC within 1e-5 relative
(floored at 1), since float sums are associated differently. With
``BUDGET`` both the compacted route and its dense fallback run for every
program (the owner route compacts on ``early`` and falls back on
``full``; the level exchanges of BFS and k-hop take both on ``full``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
N = 4
N_PER = 1024
EXPECTED_N = 256
# a small pool whose hub overflows rebuild mid-stream (the refused window)
POOL = dict(n_blocks=1024, block_size=8, k_max=32, dmax=256, probe_width=8,
            k_big=1)
M_CAP = 4096
BUDGET = 16
BUDGETS = {"dense": None, "budget": BUDGET}
STATES = ("early", "full")
Q_BITS = (1, 31, 32, 33, 64)
BC_SOURCES = 8
PR_TOL = 1e-6


def _stream():
    """Batch 0 has 8 valid ops a source shard (sparse: every exchange
    fits ``BUDGET``); batches 1-3 are hub-heavy with 10% tombstones;
    batch 4 inserts only (lighter weights: no weight increase)."""
    rng = np.random.default_rng(17)
    ids = rng.choice(2 ** 32, 160, replace=False).astype(np.uint64)
    B = 128 * N
    src = np.where(rng.random((5, B)) < 0.5, ids[rng.integers(0, 6, (5, B))],
                   ids[rng.integers(0, 160, (5, B))])
    dst = ids[rng.integers(0, 160, (5, B))]
    w = rng.uniform(0.5, 2, (5, B)).astype(np.float32)
    w[1:4][rng.random((3, B)) < 0.1] = 0.0
    w[4] = rng.uniform(0.1, 0.4, B).astype(np.float32)
    mask = np.ones((5, B), bool)
    mask[0] = (np.arange(B) % 128) < 8
    mask[4] = (np.arange(B) % 128) < 16
    return ids, src, dst, w, mask


def _keys32(ids):
    ids = np.asarray(ids, np.uint64)
    return np.stack([ids >> np.uint64(32), ids & np.uint64(0xFFFFFFFF)],
                    -1).astype(np.uint32)


def _queries(ids):
    """60 vertex IDs and 4 the stream never names (64 = 16 a shard)."""
    return np.concatenate([ids[:60], np.array([5, 7, 2 ** 32 - 1, 0],
                                               np.uint64)])


def _qbit_cases():
    rng = np.random.default_rng(5)
    out = {}
    for q in Q_BITS:
        b = rng.random((7, q)) < 0.5
        b[:, min(q, 32) - 1] = True         # bit 31 set where Q >= 32
        out[q] = b
    return out


# program name -> (factory name, static kwargs, dynamic input kind)
PROGRAMS = {
    "bfs": ("make_bfs", dict(max_iters=32), "source"),
    "khop1": ("make_khop_counts", dict(k=1, m_cap=M_CAP), "queries"),
    "khop2": ("make_khop_counts", dict(k=2, m_cap=M_CAP), "queries"),
    "khop3": ("make_khop_counts", dict(k=3, m_cap=M_CAP), "queries"),
    "pagerank": ("make_pagerank", dict(iters=20), "none"),
    "pagerank_tol": ("make_pagerank", dict(iters=100, tol=PR_TOL), "none"),
    "wcc": ("make_wcc", {}, "none"),
    "sssp": ("make_sssp", {}, "source"),
    "bc": ("make_bc", dict(max_depth=8), "sources"),
}
# warm program -> (factory, kwargs, dynamic input, the cold program whose
# ``early`` answer seeds the run on ``full``)
WARM = {
    "pagerank_warm": ("make_pagerank", dict(iters=100, tol=PR_TOL,
                                            warm=True), "none",
                      "pagerank_tol"),
    "wcc_warm": ("make_wcc", dict(warm=True), "none", "wcc"),
    "sssp_warm": ("make_sssp", dict(warm=True), "source", "sssp"),
    "bfs_warm": ("make_bfs_warm", dict(max_iters=32), "source", "bfs"),
}


def _m_cap_kw(factory):
    return {} if factory == "make_khop_counts" else {"m_cap": M_CAP}


# --------------------------------------------------------------------------
# the JAX reference (run as a script in a subprocess)
# --------------------------------------------------------------------------

def _reference(out_path):
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N}"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec
    from repro.core import edgepool as ep
    from repro.core import epoch_delta as ed
    from repro.core.sort import SortSpec
    from repro.core.sort_optimizer import optimize_sort
    from repro.dist import graph_engine as ge

    sspec = SortSpec.from_config(optimize_sort(EXPECTED_N, 32, 5), N_PER)
    pspec = ep.PoolSpec(**POOL)
    mesh = jax.make_mesh((N,), ("data",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:N])
    out = {}
    ids, src, dst, w, mask = _stream()
    apply = jax.jit(ge.make_apply_edges(sspec, pspec, mesh, "data"))
    sync = jax.jit(ge.make_sync_vertices(sspec, pspec, mesh, "data"))
    st = jax.device_put(ge.make_sharded_state(sspec, pspec, N, N_PER),
                        NamedSharding(mesh, PartitionSpec("data")))
    states = {}
    for i in range(5):
        st, d = apply(st, jnp.asarray(_keys32(src[i])),
                      jnp.asarray(_keys32(dst[i])), jnp.asarray(w[i]),
                      jnp.asarray(mask[i]))
        assert int(np.asarray(d).sum()) == 0
        st = sync(st)
        if i in (0, 3, 4):
            states[{0: "early", 3: "full", 4: "later"}[i]] = st
    for name, s in states.items():
        for j, a in enumerate(jax.tree.leaves(s)):
            out[f"state/{name}/{j}"] = np.asarray(a)

    dyn = {"source": [jnp.asarray(_keys32(src[0][:1])[0])],
           "ghost": [jnp.asarray(_keys32(np.array([123456789],
                                                  np.uint64))[0])],
           "queries": [jnp.asarray(_keys32(_queries(ids)))],
           "sources": [jnp.asarray(_keys32(ids[:BC_SOURCES]))],
           "none": []}

    def put(key, res):
        if isinstance(res, tuple):
            out[key] = np.asarray(res[0])
            out[key + "/iters"] = np.asarray(res[1])
        else:
            out[key] = np.asarray(res)

    for bname, budget in BUDGETS.items():
        for prog, (factory, kw, kind) in PROGRAMS.items():
            fn = jax.jit(getattr(ge, factory)(
                sspec, pspec, mesh, "data", frontier_budget=budget,
                **_m_cap_kw(factory), **kw))
            for sname in STATES:
                put(f"{prog}/{bname}/{sname}", fn(states[sname], *dyn[kind]))
            if prog == "bfs":
                put(f"bfs/{bname}/ghost", fn(states["full"], *dyn["ghost"]))
        for prog, (factory, kw, kind, seed) in WARM.items():
            fn = jax.jit(getattr(ge, factory)(
                sspec, pspec, mesh, "data", M_CAP, frontier_budget=budget,
                **kw))
            put(f"{prog}/{bname}/full", fn(
                states["full"], *dyn[kind],
                jnp.asarray(out[f"{seed}/{bname}/early"])))

    for prog in ("bfs", "wcc", "pagerank"):
        d = ge.collect_owner_values(states["full"],
                                    out[f"{prog}/dense/full"], N)
        keys = np.array(sorted(d), np.uint64)
        out[f"collect/{prog}/ids"] = keys
        out[f"collect/{prog}/vals"] = np.array([d[int(k)] for k in keys])

    for q, b in _qbit_cases().items():
        words = ge._pack_qbits(jnp.asarray(b))
        out[f"qbits/{q}/pack"] = np.asarray(words)
        out[f"qbits/{q}/unpack"] = np.asarray(ge._unpack_qbits(words, q))
        out[f"qbits/{q}/popcount"] = np.asarray(ge._popcount_rows(words))

    snap = jax.jit(ge.make_snapshot(sspec, pspec, mesh, "data", M_CAP))

    def csrs(state):
        sn = jax.tree.map(np.asarray, snap(state))
        return [ed.HostCsr(indptr=sn.indptr[s], dst=sn.dst[s],
                           weight=sn.weight[s], active=sn.active[s],
                           ids=sn.ids[s], m=int(sn.m[s])) for s in range(N)]

    for win, (a, b) in {"clean": ("full", "later"),
                        "refused": ("early", "full")}.items():
        deltas, reason = ed.extract_delta_sharded(
            states[a], states[b], csrs(states[a]), csrs(states[b]))
        out[f"delta/{win}/reason"] = np.array(str(reason))
        for s, dl in enumerate(deltas or []):
            for f in ("touched_rows", "new_rows", "e_src", "e_dst",
                      "w_prev", "w_new", "m_prev", "m_cur"):
                out[f"delta/{win}/{s}/{f}"] = np.asarray(getattr(dl, f))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_analytics_ref") / "ref.npz"
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

def _specs():
    from repro_torch.core import edgepool as TE
    from repro_torch.core.sort import SortSpec
    from repro_torch.core.sort_optimizer import optimize_sort
    return (SortSpec.from_config(optimize_sort(EXPECTED_N, 32, 5), N_PER),
            TE.PoolSpec(**POOL))


def _tkeys(keys32):
    return torch.from_numpy(np.asarray(keys32).astype(np.int64))


@pytest.fixture(scope="module")
def states(ref):
    """JAX's three states, loaded into the port on the CPU."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.dist import graph_engine as ge
    sspec, pspec = _specs()
    template = state_to_numpy(ge.make_sharded_state(sspec, pspec, N, N_PER,
                                                    "cpu"))
    out = {}
    for name in ("early", "full", "later"):
        arrays = iter([ref[f"state/{name}/{j}"]
                       for j in range(len(ge._leaves(template)))])
        out[name] = state_from_numpy(
            ge._tmap(lambda _: next(arrays), template), "cpu")
    return out


@pytest.fixture(scope="module")
def port_runs(states):
    """Every program of the port on ``early`` and ``full`` under both
    budgets, with the routes each budgeted program took."""
    from repro_torch.dist import graph_engine as ge
    sspec, pspec = _specs()
    ids, src, _dst, _w, _mask = _stream()
    dyn = {"source": [_tkeys(_keys32(src[0][:1])[0])],
           "ghost": [_tkeys(_keys32(np.array([123456789], np.uint64))[0])],
           "queries": [_tkeys(_keys32(_queries(ids)))],
           "sources": [_tkeys(_keys32(ids[:BC_SOURCES]))],
           "none": []}
    out, routes = {}, {}
    for bname, budget in BUDGETS.items():
        for prog, (factory, kw, kind) in PROGRAMS.items():
            fn = getattr(ge, factory)(sspec, pspec, N,
                                      frontier_budget=budget,
                                      **_m_cap_kw(factory), **kw)
            r0 = dict(ge.ROUTES)
            for sname in STATES:
                out[f"{prog}/{bname}/{sname}"] = fn(states[sname],
                                                    *dyn[kind])
            routes[(prog, bname)] = {k: ge.ROUTES[k] - r0[k] for k in r0}
            if prog == "bfs":
                out[f"bfs/{bname}/ghost"] = fn(states["full"],
                                               *dyn["ghost"])
        for prog, (factory, kw, kind, seed) in WARM.items():
            fn = getattr(ge, factory)(sspec, pspec, N, M_CAP,
                                      frontier_budget=budget, **kw)
            seed_vals = out[f"{seed}/{bname}/early"]
            if isinstance(seed_vals, tuple):
                seed_vals = seed_vals[0]
            out[f"{prog}/{bname}/full"] = fn(states["full"], *dyn[kind],
                                             seed_vals)
    return out, routes


def _assert_answer(ref, key, got):
    if isinstance(got, tuple):
        np.testing.assert_array_equal(got[1].numpy(), ref[key + "/iters"],
                                      err_msg=key)
        got = got[0]
    got, want = got.numpy(), ref[key]
    assert got.shape == want.shape, (key, got.shape, want.shape)
    if key.startswith("pagerank"):
        assert np.abs(got - want).max() <= 1e-5, key
    elif key.startswith("bc"):
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() <= 1e-5, key
    else:                       # wcc: int64 labels against JAX's uint32
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=key)


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_program_matches_jax(ref, port_runs, prog, budget):
    out, routes = port_runs
    for sname in STATES:
        _assert_answer(ref, f"{prog}/{budget}/{sname}",
                       out[f"{prog}/{budget}/{sname}"])
    if prog == "bfs":
        _assert_answer(ref, f"bfs/{budget}/ghost", out[f"bfs/{budget}/ghost"])
        assert (out[f"bfs/{budget}/ghost"] == -1).all()
    r = routes[(prog, budget)]
    if BUDGETS[budget] is None:
        assert r == {"compact": 0, "dense_fallback": 0}, r
    else:                       # both routes ran, and the answers agree
        assert r["compact"] > 0 and r["dense_fallback"] > 0, (prog, r)


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("prog", list(WARM))
def test_warm_program_matches_jax(ref, port_runs, prog, budget):
    out, _routes = port_runs
    _assert_answer(ref, f"{prog}/{budget}/full", out[f"{prog}/{budget}/full"])


def test_answers_are_not_trivial(ref):
    """The reference answers exercise the programs: BFS reaches several
    levels, k-hop counts grow with k, WCC finds more than one label."""
    d = ref["bfs/dense/full"]
    assert d.max() >= 2 and (d == 1).sum() > 4
    k1, k2, k3 = (ref[f"khop{k}/dense/full"] for k in (1, 2, 3))
    assert (k1 <= k2).all() and (k2 <= k3).all() and k3.sum() > k1.sum()
    assert not k1[60:].any()
    assert ref["bc/dense/full"].max() > 1.0


@pytest.mark.parametrize("prog", ["bfs", "wcc", "pagerank"])
def test_collect_owner_values_matches_jax(ref, port_runs, states, prog):
    from repro_torch.dist import graph_engine as ge
    out, _ = port_runs
    got = ge.collect_owner_values(states["full"],
                                  out[f"{prog}/dense/full"], N)
    ids = ref[f"collect/{prog}/ids"]
    assert sorted(got) == ids.tolist()
    vals = np.array([got[int(k)] for k in ids])
    if prog == "pagerank":
        assert np.abs(vals - ref[f"collect/{prog}/vals"]).max() <= 1e-5
    else:
        np.testing.assert_array_equal(vals, ref[f"collect/{prog}/vals"])


@pytest.mark.parametrize("q", Q_BITS)
def test_query_bit_words_match_jax(ref, q):
    from repro_torch.dist import graph_engine as ge
    b = torch.from_numpy(_qbit_cases()[q])
    words = ge._pack_qbits(b)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  ref[f"qbits/{q}/pack"])
    np.testing.assert_array_equal(ge._unpack_qbits(words, q).numpy(),
                                  ref[f"qbits/{q}/unpack"])
    np.testing.assert_array_equal(ge._popcount_rows(words).numpy(),
                                  ref[f"qbits/{q}/popcount"])
    if q >= 32:                 # bit 31 lands as the sign bit
        assert (words[:, 0] < 0).all()


@pytest.mark.parametrize("window", ["clean", "refused"])
def test_extract_delta_sharded_matches_jax(ref, states, window):
    from repro_torch.core import epoch_delta as ted
    from repro_torch.dist import graph_engine as ge
    sspec, pspec = _specs()
    snap = ge.make_snapshot(sspec, pspec, N, M_CAP)
    a, b = {"clean": ("full", "later"), "refused": ("early", "full")}[window]

    def csrs(state):
        sn = snap(state)
        return [ted.host_csr(ge.shard_view(sn, s)) for s in range(N)]

    deltas, reason = ted.extract_delta_sharded(
        states[a], states[b], csrs(states[a]), csrs(states[b]))
    assert str(reason) == str(ref[f"delta/{window}/reason"])
    if window == "refused":
        assert deltas is None and str(reason).startswith("shard")
        assert str(reason).endswith(":defrag")
        return
    assert len(deltas) == N and sum(d.n_changed for d in deltas) > 0
    for s, dl in enumerate(deltas):
        for f in ("touched_rows", "new_rows", "e_src", "e_dst", "w_prev",
                  "w_new", "m_prev", "m_cur"):
            np.testing.assert_array_equal(
                np.asarray(getattr(dl, f)), ref[f"delta/{window}/{s}/{f}"],
                err_msg=f"shard {s} {f}")
    flags = ted.merged_flags(deltas)
    assert not flags["has_deletes"] and not flags["has_weight_increase"]


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _reference(sys.argv[1])
