"""The port's ``dryrun_graph --mode ingest|analytics`` against the JAX
package's, whose programs are compiled on 2 and 4 placeholder devices
and read with ``repro.launch.hlo.parse_collectives`` (the JAX side runs
once, in a subprocess: this file as a script).

JAX counts a compiled program: every trip of a while loop's bound and
the largest branch of a conditional. The port counts what it ran
(``collective_branch_rule`` "executed"). They are compared where both
take the same branch and the same trips:

* ingest, packed and not, no route budget: one routed batch;
* ingest with a route budget of 1 row, which every batch spills, so the
  port takes the dense fallback, JAX's largest branch;
* BFS with ``max_iters`` 4 from the head of a 12-vertex chain: the port
  runs all 4 levels, each one dense route. ``parse_collectives`` counts
  this loop's body once: its trip count is the largest integer literal
  of the loop's condition, and this condition compares with a loop
  operand, not a literal. So a level is compared: the port's exchanges
  over its 4 levels against JAX's body.

All-to-all elements, bytes and collective counts must be equal. Every
JAX exchange word is 4 bytes (uint32 payloads, uint32 validity), so
JAX's elements are its bytes / 4; the port's words are int32 holding
the same bits (float32 for the unpacked weights). Each mode is run through
``main([...])`` with ``--device cpu``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
N_PER, BPS = 1024, 64
MAX_ITERS, CHAIN = 4, 12
INGEST = {            # name -> (pack, route_budget)
    "packed": (True, None),
    "unpacked": (False, None),
    "route1": (True, 1),
}


def _store_kwargs(n, pack=True, route_budget=None):
    """The dryrun modes' store at a small size (both packages; the SORT
    at its default size, as the port's modes run it)."""
    return dict(n_shards=n, n_per_shard=N_PER, expected_n=N_PER,
                pool_blocks=N_PER // 2,
                block_size=16, k_max=64, dmax=256, batch=BPS * n,
                m_cap=N_PER * 4, pack=pack, route_budget=route_budget)


def _chain_ids():
    return np.arange(1, CHAIN + 1, dtype=np.uint64) * 7919


# --------------------------------------------------------------------------
# the JAX reference (run as a script in a subprocess)
# --------------------------------------------------------------------------

def _reference(out_path, n):
    import jax
    import jax.numpy as jnp
    from repro.api import make_store
    from repro.launch.hlo import parse_collectives

    out = {}
    for name, (pack, budget) in INGEST.items():
        store = make_store("sharded", **_store_kwargs(n, pack, budget))
        B = store.batch
        compiled = store.apply_program(donate=True).lower(
            store.state_struct(),
            jax.ShapeDtypeStruct((B, 2), jnp.uint32),
            jax.ShapeDtypeStruct((B, 2), jnp.uint32),
            jax.ShapeDtypeStruct((B,), jnp.float32),
            jax.ShapeDtypeStruct((B,), bool)).compile()
        out[f"ingest/{name}/{n}"] = parse_collectives(compiled.as_text())
    store = make_store("sharded", **_store_kwargs(n))
    compiled = store.analytics_program("bfs", max_iters=MAX_ITERS).lower(
        store.state_struct(), jax.ShapeDtypeStruct((2,), jnp.uint32)) \
        .compile()
    out[f"bfs/{n}"] = parse_collectives(compiled.as_text())
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX side, one subprocess a mesh size, both at once."""
    tmp = tmp_path_factory.mktemp("dryrun_graph_ref")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {n: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp / f"{n}.json"),
         str(n)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for n in (2, 4)}
    out = {}
    for n, p in procs.items():
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-4000:]
        with open(tmp / f"{n}.json") as f:
            out.update(json.load(f))
    return out


def _main(*argv):
    from repro_torch.launch import dryrun_graph
    return dryrun_graph.main([*argv, "--device", "cpu",
                              "--n-per-shard", str(N_PER),
                              "--batch-per-shard", str(BPS)])


def test_a_4x_sort_finds_no_vertex_in_the_port():
    """The JAX modes' SORT sizing (``sort_capacity_factor`` 4.0), run on
    one batch of 128 chain edges: no read finds a source vertex, in the
    port as in the JAX store (ROADMAP Queue 3; at 65 edges every one is
    found); at the default sizing every one is found."""
    from repro_torch.api import OpBatch, ReadOp, make_store
    ids = np.arange(1, 2 * BPS + 2, dtype=np.uint64) * 7919
    for factor, want in ((4.0, 0), (None, 1)):
        store = make_store("sharded", device="cpu", **dict(
            _store_kwargs(2), sort_capacity_factor=factor))
        store.apply(OpBatch.edges(ids[:-1], ids[1:],
                                  np.ones(len(ids) - 1, np.float32)))
        deg = np.asarray(store.read(ReadOp("degree", ids=ids[:-1])))
        assert (deg == want).all(), factor


def _same_a2a(port, jax_bytes, jax_counts):
    """Equal all-to-all counts, elements and bytes: the port's words are
    int32 holding JAX's uint32 words (float32 for the unpacked route's
    weights)."""
    assert port["collective_counts"]["all-to-all"] == \
        jax_counts["all-to-all"]
    assert port["collective_elements"]["all-to-all"] == \
        jax_bytes["all-to-all"] / 4
    assert port["collective_bytes"]["all-to-all"] == \
        jax_bytes["all-to-all"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(INGEST))
def test_ingest_counts_equal_jax(ref, name, n):
    pack, budget = INGEST[name]
    argv = ["--mode", "ingest", "--shards", str(n)]
    argv += [] if pack else ["--no-pack"]
    argv += [] if budget is None else ["--route-budget", str(budget)]
    rec = _main(*argv)
    assert rec["status"] == "ok" and rec["ops_dropped"] == 0
    jb, jc = ref[f"ingest/{name}/{n}"]
    _same_a2a(rec, jb, jc)
    if budget is not None:
        # the spill decision: JAX's psum of an int32, the port's fetch
        assert rec["routes"] == {"compact": 0, "dense_fallback": 1}
        assert rec["collective_counts"]["all-reduce"] == jc["all-reduce"]
    # the per-shard a2a words from the route buffers' shapes
    B_l = BPS
    assert rec["collective_elements"]["all-to-all"] == n * B_l * 6
    assert rec["batch_per_shard"] == B_l
    state_b = rec["memory"]["argument_size_in_bytes"]
    assert state_b > 0 and rec["memory"]["input_size_in_bytes"] > 0
    assert state_b == rec["state_bytes"] // n
    assert rec["device"] == "cpu"
    assert set(rec["launch_counts"]) >= {"append", "sort_lookup"}


def test_ingest_pipelined_counts_each_batch():
    one = _main("--mode", "ingest", "--shards", "2")
    two = _main("--mode", "ingest", "--shards", "2", "--pipeline-depth",
                "2")
    assert two["pipeline_depth"] == 2 and two["batch_ops"] == 2 * 2 * BPS
    for k in ("collective_counts", "collective_elements"):
        assert two[k]["all-to-all"] == 2 * one[k]["all-to-all"]


@pytest.mark.parametrize("n", [2, 4])
def test_bfs_levels_count_as_jax_loop_bound(ref, n):
    """The chain keeps the BFS going for all ``MAX_ITERS`` levels: one
    dense route a level (ids + validity, 3 words a row), as JAX's loop
    body, times its bound."""
    from repro_torch.api import OpBatch, make_store
    from repro_torch.launch import costs

    store = make_store("sharded", device="cpu", **_store_kwargs(n))
    ids = _chain_ids()
    store.apply(OpBatch.edges(ids[:-1], ids[1:],
                              np.ones(CHAIN - 1, np.float32)))
    state = store._synced(store.state)
    key = store._keys(ids[:1])[0]
    prog = store.analytics_program("bfs", max_iters=MAX_ITERS)
    with costs.CostCounter(per_shard=n) as c:
        depth = prog(state, key)
    rec = c.record()
    owner_depths = sorted(int(d) for d in depth.reshape(-1) if d >= 0)
    assert owner_depths[-1] == MAX_ITERS
    jb, jc = ref[f"bfs/{n}"]
    assert jc["all-to-all"] == 1        # the body, counted once
    per_level = {k: {c: v / MAX_ITERS for c, v in rec[k].items()}
                 for k in ("collective_counts", "collective_elements",
                           "collective_bytes")}
    _same_a2a(per_level, jb, jc)
    n_cap = state.vt.del_time.shape[1]
    assert rec["collective_elements"]["all-to-all"] == \
        MAX_ITERS * n * n_cap * 3


def test_analytics_mode_runs_every_algorithm_and_its_advance():
    rec = _main("--mode", "analytics", "--shards", "2", "--incremental",
                "--algs", "bfs,pagerank,wcc,sssp,bc")
    assert rec["status"] == "ok" and rec["device"] == "cpu"
    assert set(rec["algs"]) == {"bfs", "pagerank", "wcc", "sssp", "bc",
                                "bfs__advance", "pagerank__advance",
                                "wcc__advance", "sssp__advance"}
    for name, r in rec["algs"].items():
        assert r["collective_counts"]["all-to-all"] > 0, name
        assert r["collective_branch_rule"] == "executed"
        assert r["memory"]["argument_size_in_bytes"] == \
            r["state_bytes"] // 2 > 0
    # a BFS level's dense route: (n_dst, n_cap, 3) words a shard
    bfs = rec["algs"]["bfs"]
    assert bfs["collective_elements"]["all-to-all"] == \
        bfs["collective_counts"]["all-to-all"] * 2 * rec["n_cap"] * 3


if __name__ == "__main__":
    _reference(sys.argv[1], int(sys.argv[2]))
