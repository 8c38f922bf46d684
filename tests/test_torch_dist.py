"""The sharded engine (``repro_torch.dist.graph_engine``) against the JAX
mesh engine (``repro.dist.graph_engine``), bit-exact.

The JAX side needs 2 and 4 devices: one subprocess, started by a
module-scoped fixture with ``--xla_force_host_platform_device_count=4``
set before JAX touches a device, runs this file as a script, computes
every reference case and writes one ``.npz``. The port runs in this
process on the CPU (``device="cpu"``: each kernel wrapper runs its plain
version). Inputs come from numpy seeds. Every compared output is an
integer, an index or a copied float, so every comparison is exact.

Cases: the routing hash at the edges of the uint32 range; the per-batch
engine with n in {2, 4}, the packed and unpacked payloads, the compacted
route and its dense fallback, ``capacity_factor`` 0.5 (route drops), on a
hub-heavy stream whose overflow rebuild fires mid-stream (every shard's
leaves and ``dropped`` after EACH batch); the pipelined engine with a
ragged tail; the vertex sync (full, incremental, budgeted with and
without its fallback); the snapshot, degree map, ``num_edges`` and the
degree body of ``make_khop_counts``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
N_PER = 1024
EXPECTED_N = 256
# the fused append with its exact live-edge probe (the JAX package's TPU
# path, interpreted on the CPU; its CPU default probes an 8-entry window)
POOL = dict(n_blocks=1024, block_size=8, k_max=32, dmax=256, probe_width=8,
            k_big=1, append_impl="pallas")
M_CAP = 1024 * 8
NB = 5
BUDGET = 64
# name -> (n_shards, pack, route_budget, capacity_factor)
CASES = {
    "n2": (2, True, None, 1.0),
    "n2_unpacked": (2, False, None, 1.0),
    "n2_budget": (2, True, BUDGET, 1.0),
    "n4": (4, True, None, 1.0),
    "n4_unpacked_budget": (4, False, BUDGET, 1.0),
    "n4_half_capacity": (4, True, None, 0.5),
}
# name -> (budget, incremental): run on the "n4" case's final state; the
# incremental sync takes the rows as of batch 2 as its watermark
SYNC_CASES = {"full": (None, False), "full_compact": (128, False),
              "full_fallback": (8, False), "incremental": (BUDGET, True)}
ROUTE_KEYS = np.array([0, 1, 2, 3, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000,
                       0x80000001, 0xFFFFFFFD, 0xFFFFFFFE, 0xFFFFFFFF],
                      np.uint64)


def _stream(n):
    """A hub-heavy stream of NB global batches of 128 ops a source shard:
    batches 1 and 3 have only 40 valid ops a slice (the compacted route
    always fits), batch 2 sends every op from one hub (the dense fallback
    always runs, and half capacity drops), 10% tombstones."""
    rng = np.random.default_rng(9 + n)
    ids = rng.choice(2 ** 32, 100, replace=False).astype(np.uint64)
    B = 128 * n
    src = np.where(rng.random((NB, B)) < 0.7,
                   ids[rng.integers(0, 6, (NB, B))],
                   ids[rng.integers(0, 100, (NB, B))])
    src[2] = ids[0]
    dst = ids[rng.integers(0, 100, (NB, B))]
    w = rng.uniform(0.5, 2, (NB, B)).astype(np.float32)
    w[rng.random((NB, B)) < 0.1] = 0.0
    mask = np.ones((NB, B), bool)
    for i in (1, 3):
        mask[i] = (np.arange(B) % 128) < 40
    return ids, src, dst, w, mask


def _keys32(ids):
    ids = np.asarray(ids, np.uint64)
    return np.stack([ids >> np.uint64(32), ids & np.uint64(0xFFFFFFFF)],
                    -1).astype(np.uint32)


def _route_keys():
    hi, lo = np.meshgrid(ROUTE_KEYS, ROUTE_KEYS)
    rng = np.random.default_rng(1)
    rand = rng.integers(0, 2 ** 32, (512, 2), dtype=np.uint64)
    return np.concatenate([np.stack([hi.ravel(), lo.ravel()], -1), rand]
                          ).astype(np.uint32)


# --------------------------------------------------------------------------
# the JAX reference (run as a script in a subprocess)
# --------------------------------------------------------------------------

def _reference(out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec
    from repro.core import edgepool as ep
    from repro.core.sort import SortSpec
    from repro.core.sort_optimizer import optimize_sort
    from repro.dist import graph_engine as ge

    sspec = SortSpec.from_config(optimize_sort(EXPECTED_N, 32, 5), N_PER)
    pspec = ep.PoolSpec(**POOL)
    meshes = {n: jax.make_mesh((n,), ("data",), axis_types=(AxisType.Auto,),
                               devices=jax.devices()[:n]) for n in (2, 4)}
    out = {}

    def put(prefix, tree):
        for j, a in enumerate(jax.tree.leaves(tree)):
            out[f"{prefix}/{j}"] = np.asarray(a)

    rk = _route_keys()
    for n in (1, 2, 3, 4):
        out[f"route/{n}"] = np.asarray(ge.shard_of_keys(jnp.asarray(rk), n))

    states = {}
    for name, (n, pack, budget, cf) in CASES.items():
        _ids, src, dst, w, mask = _stream(n)
        fn = jax.jit(ge.make_apply_edges(sspec, pspec, meshes[n], "data",
                                         pack=pack, capacity_factor=cf,
                                         route_budget=budget))
        # placed as the program's outputs are, so it compiles once
        st = jax.device_put(ge.make_sharded_state(sspec, pspec, n, N_PER),
                            NamedSharding(meshes[n], PartitionSpec("data")))
        for i in range(NB):
            st, d = fn(st, jnp.asarray(_keys32(src[i])),
                       jnp.asarray(_keys32(dst[i])), jnp.asarray(w[i]),
                       jnp.asarray(mask[i]))
            put(f"{name}/{i}", st)
            out[f"{name}/{i}/drop"] = np.asarray(d)
            if name == "n4" and i == 2:
                out["n4/rows2"] = np.asarray(st.vt.num_rows)
        states[name] = st

    mesh = meshes[4]
    base = states["n4"]
    for name, (budget, inc) in SYNC_CASES.items():
        fn = jax.jit(ge.make_sync_vertices(sspec, pspec, mesh, "data",
                                           budget=budget, incremental=inc))
        st = fn(base, jnp.asarray(out["n4/rows2"])) if inc else fn(base)
        put(f"sync/{name}", st)
    synced = jax.jit(ge.make_sync_vertices(sspec, pspec, mesh, "data"))(base)
    put("snapshot", jax.jit(ge.make_snapshot(sspec, pspec, mesh, "data",
                                             M_CAP))(synced))
    out["degree_map"] = np.asarray(jax.jit(ge.make_degree_map(
        sspec, pspec, mesh, "data", M_CAP))(synced))
    out["num_edges"] = np.asarray(jax.jit(ge.make_num_edges(
        sspec, pspec, mesh, "data", M_CAP))(synced))
    ids = _stream(4)[0]
    q = np.concatenate([ids[:60], np.array([5, 7, 2 ** 32 - 1, 0],
                                           np.uint64)])
    out["khop_degree"] = np.asarray(jax.jit(ge.make_khop_counts(
        sspec, pspec, mesh, "data"))(synced, jnp.asarray(_keys32(q))))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_ref") / "ref.npz"
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


def _tkeys(ids):
    from repro_torch.core.keys import pack_keys
    return pack_keys(np.asarray(ids, np.uint64).ravel(), 32, "cpu")


def _host_leaves(state):
    from repro_torch.convert import state_to_numpy
    from repro_torch.dist.graph_engine import _leaves
    return _leaves(state_to_numpy(state))


def _assert_leaves(ref, prefix, leaves):
    n_ref = sum(1 for k in ref if k.startswith(prefix + "/")
                and k[len(prefix) + 1:].isdigit())
    assert n_ref == len(leaves), (prefix, n_ref, len(leaves))
    for j, a in enumerate(leaves):
        r = ref[f"{prefix}/{j}"]
        assert r.dtype == a.dtype, (prefix, j, r.dtype, a.dtype)
        np.testing.assert_array_equal(a, r, err_msg=f"{prefix} leaf {j}")


@pytest.fixture(scope="module")
def port_runs():
    """Every engine case on the port: leaves and drops after each batch,
    the route each compacted batch took, and the final states."""
    from repro_torch.dist import graph_engine as ge
    sspec, pspec = _specs()
    runs = {}
    for name, (n, pack, budget, cf) in CASES.items():
        _ids, src, dst, w, mask = _stream(n)
        fn = ge.make_apply_edges(sspec, pspec, n, pack=pack,
                                 capacity_factor=cf, route_budget=budget)
        st = ge.make_sharded_state(sspec, pspec, n, N_PER, "cpu")
        per, drops, defrags = [], [], []
        for i in range(NB):
            st, d = fn(st, _tkeys(src[i]), _tkeys(dst[i]),
                       torch.from_numpy(w[i]), torch.from_numpy(mask[i]))
            per.append(_host_leaves(st))
            drops.append(d.numpy())
            defrags.append(int(st.pool.defrags.sum()))
        runs[name] = dict(leaves=per, drops=drops, defrags=defrags, state=st)
    return runs


def test_shard_of_keys_matches_jax(ref):
    from repro_torch.dist.graph_engine import shard_of_keys
    keys = torch.from_numpy(_route_keys().astype(np.int64))
    for n in (1, 2, 3, 4):
        got = shard_of_keys(keys, n).numpy()
        assert got.dtype == ref[f"route/{n}"].dtype
        np.testing.assert_array_equal(got, ref[f"route/{n}"], err_msg=str(n))
    assert len(np.unique(ref["route/4"])) == 4


@pytest.mark.parametrize("name", list(CASES))
def test_apply_edges_matches_jax_after_each_batch(ref, port_runs, name):
    run = port_runs[name]
    for i in range(NB):
        _assert_leaves(ref, f"{name}/{i}", run["leaves"][i])
        np.testing.assert_array_equal(run["drops"][i],
                                      ref[f"{name}/{i}/drop"],
                                      err_msg=f"{name} batch {i}")
    # the overflow rebuild fires mid-stream, not only at its end
    assert 0 < run["defrags"][-2] <= run["defrags"][-1], run["defrags"]


def test_cases_cover_both_routes_and_route_drops(ref, port_runs):
    """The compacted route and its dense fallback both run; half capacity
    drops ops at the router and counts them."""
    from repro_torch.dist.graph_engine import shard_of_keys
    for name, (n, _pack, budget, _cf) in CASES.items():
        if budget is None:
            continue
        _ids, src, _dst, _w, mask = _stream(n)
        owner = shard_of_keys(_tkeys(src), n).numpy().reshape(NB, n, -1)
        over = [max(np.bincount(owner[i, s][mask[i].reshape(n, -1)[s]],
                                minlength=n).max() for s in range(n))
                > budget for i in range(NB)]
        assert any(over) and not all(over), (name, over)
    drops = sum(int(ref[f"n4_half_capacity/{i}/drop"].sum())
                for i in range(NB))
    assert drops > 0
    assert sum(int(d.sum()) for d in port_runs["n4_half_capacity"]["drops"]
               ) == drops


@pytest.mark.parametrize("name", ["n2", "n2_budget"])
def test_pipelined_equals_per_batch_with_ragged_tail(ref, name):
    """Super-batches of K = 3 then 2 give the state of the per-batch
    calls (JAX's, after batches 3 and 5) and the summed drops."""
    from repro_torch.dist import graph_engine as ge
    sspec, pspec = _specs()
    n, pack, budget, cf = CASES[name]
    _ids, src, dst, w, mask = _stream(n)
    fn = ge.make_apply_edges_pipelined(sspec, pspec, n, pack=pack,
                                       capacity_factor=cf,
                                       route_budget=budget)
    st = ge.make_sharded_state(sspec, pspec, n, N_PER, "cpu")
    for lo, hi in ((0, 3), (3, 5)):
        k = hi - lo
        st, d = fn(st, _tkeys(src[lo:hi]).reshape(k, -1, 2),
                   _tkeys(dst[lo:hi]).reshape(k, -1, 2),
                   torch.from_numpy(w[lo:hi]), torch.from_numpy(mask[lo:hi]))
        _assert_leaves(ref, f"{name}/{hi - 1}", _host_leaves(st))
        exp = sum(ref[f"{name}/{i}/drop"] for i in range(lo, hi))
        np.testing.assert_array_equal(d.numpy(), exp)


@pytest.mark.parametrize("sync", list(SYNC_CASES))
def test_sync_vertices_matches_jax(ref, port_runs, sync):
    from repro_torch.core.radixgraph import clone_state
    from repro_torch.dist import graph_engine as ge
    sspec, pspec = _specs()
    budget, inc = SYNC_CASES[sync]
    fn = ge.make_sync_vertices(sspec, pspec, 4, budget=budget,
                               incremental=inc)
    base = port_runs["n4"]["state"]
    st = fn(clone_state(base), torch.from_numpy(ref["n4/rows2"])) if inc \
        else fn(clone_state(base))
    _assert_leaves(ref, f"sync/{sync}", _host_leaves(st))
    if inc:
        # the scan bounded by host row counts: the same state
        st = fn(clone_state(base), ref["n4/rows2"].tolist(),
                base.vt.num_rows.tolist())
        _assert_leaves(ref, f"sync/{sync}", _host_leaves(st))


def test_read_programs_match_jax(ref, port_runs):
    from repro_torch.convert import snapshot_to_numpy
    from repro_torch.core.radixgraph import clone_state
    from repro_torch.dist import graph_engine as ge
    sspec, pspec = _specs()
    st = ge.make_sync_vertices(sspec, pspec, 4)(
        clone_state(port_runs["n4"]["state"]))
    snap = snapshot_to_numpy(ge.make_snapshot(sspec, pspec, 4, M_CAP)(st))
    _assert_leaves(ref, "snapshot", [np.asarray(x) for x in snap])
    for name, fn in (("degree_map", ge.make_degree_map),
                     ("num_edges", ge.make_num_edges)):
        got = fn(sspec, pspec, 4, M_CAP)(st).numpy()
        assert got.dtype == ref[name].dtype
        np.testing.assert_array_equal(got, ref[name], err_msg=name)
    ids = _stream(4)[0]
    q = np.concatenate([ids[:60], np.array([5, 7, 2 ** 32 - 1, 0],
                                           np.uint64)])
    got = ge.make_khop_counts(sspec, pspec, 4)(st, _tkeys(q)).numpy()
    np.testing.assert_array_equal(got, ref["khop_degree"])
    assert got[:60].sum() > 0 and not got[60:].any()
    assert int(ref["num_edges"].sum()) == int(ref["degree_map"].sum())
    # the frontier rounds stop at k = 3, and need the CSR pad, as in JAX
    with pytest.raises(NotImplementedError):
        ge.make_khop_counts(sspec, pspec, 4, k=4, m_cap=M_CAP)
    with pytest.raises(ValueError):
        ge.make_khop_counts(sspec, pspec, 4, k=2)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _reference(sys.argv[1])
