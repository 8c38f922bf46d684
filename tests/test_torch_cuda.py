"""Each CUDA kernel of the port against its plain PyTorch version, on the
card (tests marked ``cuda``; without a card they skip).

The plain versions are held to the JAX oracles by
``tests/test_torch_kernels.py``; this file imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs are made from a seed with numpy. Outputs are integers or copied
floats, so the comparison is bit-exact (``torch.equal``).
"""
import numpy as np
import pytest
import torch

from _kernel_cases import (APPEND_ARGS, APPEND_CASES, COMPACT_CASES,
                           DEFRAG_CASES, WIDE_CASES, append_case,
                           edge_pool_append_calls, rows_case, wide_rows_case,
                           writes_outside_probes)
from repro_torch.core.keys import pack_keys as tpack_keys
from repro_torch.core.sort_optimizer import optimize_sort
from repro_torch.kernels.append import append_edges, append_edges_plain
from repro_torch.kernels.compact import (compact_rows, compact_rows_plain,
                                         defrag_rows, defrag_rows_plain)
from repro_torch.kernels.frontier import (frontier_expand,
                                          frontier_expand_plain)
from repro_torch.kernels.sort_lookup import sort_lookup, sort_lookup_plain


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _rows(seed, K, D, n_cap=64):
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, n_cap, (K, D)).astype(np.int32)
    w = np.round(rng.uniform(0, 2, (K, D))).astype(np.float32)
    ts = rng.permutation(K * D).reshape(K, D).astype(np.int32)
    size = rng.integers(0, D + 1, (K,)).astype(np.int32)
    return dst, w, ts, size


# ---- on the card: each CUDA kernel against its plain version ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cuda(ts, dev):
    return [t.to(dev) for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("K,D", [(1, 8), (3, 16), (5, 64), (256, 256),
                                 (16, 4096)])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_compact_rows_kernel_on_card(cuda_device, K, D, wdtype):
    dst, w, ts, size = _rows(K + D, K, D, n_cap=max(64, D // 2))
    args = _cuda(_t(dst, w, ts, size), cuda_device)
    args[1] = args[1].to(getattr(torch, wdtype))
    for rt in (None, K * D // 2):
        a = compact_rows(*args, read_ts=rt)
        b = compact_rows_plain(*args, read_ts=rt)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("K,D", [(1, 8), (4, 16), (64, 128), (32, 4096),
                                 (2000, 1024)])
@pytest.mark.parametrize("keep_all", [False, True])
def test_defrag_rows_kernel_on_card(cuda_device, K, D, keep_all):
    dst, w, ts, size = _rows(K * 3 + D, K, D, n_cap=max(64, D // 2))
    args = _cuda(_t(dst, w, ts, size), cuda_device)
    a = defrag_rows(*args, keep_all=keep_all)
    b = defrag_rows_plain(*args, keep_all=keep_all)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _append_both(c, dev):
    ka = _cuda(_t(*[c[k] for k in APPEND_ARGS]), dev)
    pa = [t.clone() for t in ka]
    was_k = append_edges(*ka)
    was_p = append_edges_plain(*pa)
    torch.cuda.synchronize()
    assert torch.equal(was_k, was_p)
    for x, y in zip(ka[:3], pa[:3]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_append_kernel_on_card(cuda_device, seed):
    """4096 probes and 4096 ops over about 5000 block rows; write slots lie
    outside every probed extent, as the edge pool's do (the kernel runs
    probes and writes in one launch)."""
    _append_both(append_case("extents", seed, owners=2048, n_probes=4096,
                             n_ops=4096), cuda_device)


@pytest.mark.cuda
def test_append_kernel_on_edge_pool_calls_on_card(cuda_device):
    """The inputs of the edge pool's own append calls on the card: each
    keeps its writes outside the probed extents, and the one-launch kernel
    matches the plain version on it."""
    calls = edge_pool_append_calls("cuda")
    assert len(calls) >= 8
    for c in calls:
        assert writes_outside_probes(c)
        _append_both(c, cuda_device)


# ---- the edge cases of tests/_kernel_cases.py, which
# tests/test_torch_kernels.py holds the plain versions to the oracles on ----

@pytest.mark.cuda
@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_rows_edge_cases_on_card(cuda_device, case):
    """The warp path (lim <= 256), the block path, the sort path (D >
    8192), size > D, one dst, tombstones only, table-size multiples, dst
    2^30 - 1, read_ts, bfloat16."""
    c = rows_case(case)
    args = _cuda(_t(c["dst"], c["w"], c["ts"], c["size"]), cuda_device)
    args[1] = args[1].to(getattr(torch, c["wdtype"]))
    a = compact_rows(*args, read_ts=c["read_ts"])
    b = compact_rows_plain(*args, read_ts=c["read_ts"])
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DEFRAG_CASES)
def test_defrag_rows_edge_cases_on_card(cuda_device, case):
    """With and without ``keep_all`` on the same rows."""
    c = rows_case(case)
    args = _cuda(_t(c["dst"], c["w"], c["ts"], c["size"]), cuda_device)
    for keep_all in (False, True):
        a = defrag_rows(*args, keep_all=keep_all)
        b = defrag_rows_plain(*args, keep_all=keep_all)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_CASES)
@pytest.mark.parametrize("D", [16385, 65536, 2 ** 17])
def test_defrag_rows_wide_rows_on_card(cuda_device, case, D):
    """Launches wider than 4,096: rows past 4,096 entries sorted in runs
    of 4,096, merged (3, 4 and 5 passes), then counted, scanned and
    written; rows of at most 4,096 entries in the same launch done whole
    by one block. With and without ``keep_all``; every kernel of a call is
    counted."""
    from repro_torch.kernels import ops
    c = wide_rows_case(case, D)
    args = _cuda(_t(c["dst"], c["w"], c["ts"], c["size"]), cuda_device)
    args[1] = args[1].to(getattr(torch, c["wdtype"]))
    merges = int(np.ceil(np.log2(-(-D // 4096))))
    for keep_all in (False, True):
        before = ops.launch_counts()["defrag_rows"]
        calls = ops.call_counts()["defrag_rows"]
        a = defrag_rows(*args, keep_all=keep_all)
        assert ops.launch_counts()["defrag_rows"] == before + 4 + merges
        assert ops.call_counts()["defrag_rows"] == calls + 1
        b = defrag_rows_plain(*args, keep_all=keep_all)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_streaming_rebuild_equals_dense_with_wide_hubs_on_card(cuda_device):
    """A card-resident store whose two hubs pass ``dmax`` and 16,384
    entries (a wide launch, sorted runs merged): after every batch, the
    streaming
    rebuild (wide tier through ``defrag_rows``) and the dense reference
    leave the same pool and vertex table, leaf for leaf."""
    from dataclasses import replace
    from repro_torch.api import OpBatch, make_store
    from repro_torch.core import edgepool as ep
    rng = np.random.default_rng(4)
    n, m = 20000, 3 * 4096
    ids = rng.choice(2 ** 32, n, replace=False).astype(np.uint64)
    store = make_store("local", device=cuda_device, n_max=32768,
                       expected_n=n, key_bits=32, pool_blocks=1 << 17,
                       block_size=16, batch=4096, dmax=512, k_max=32,
                       k_big=4, probe_width=64)
    g = store.graph

    def clone(nt):
        return type(nt)(*[x.clone() for x in nt])

    def leaves(pool, vt):
        return [*pool, *vt]

    widest, w0 = 0, ep.SYNCS["defrag_wide"]
    for _ in range(10):
        si = np.where(rng.random(m) < 0.8, rng.integers(0, 2, m),
                      rng.integers(0, n, m))
        w = rng.uniform(0.5, 2, m).astype(np.float32)
        w[rng.random(m) < 0.2] = 0.0
        store.apply(OpBatch.edges(ids[si], ids[rng.integers(0, n, m)], w))
        st = g.state
        live = (st.vt.del_time == 0) & (st.vt.start_block >= 0)
        widest = max(widest, int(st.vt.size[live].max()))
        s0 = dict(ep.SYNCS)
        a = ep.defrag(g.pool_spec, clone(st.pool), clone(st.vt))
        b = ep.defrag(replace(g.pool_spec, defrag_impl="dense"),
                      clone(st.pool), clone(st.vt))
        torch.cuda.synchronize()
        assert ep.SYNCS["defrag_stream"] == s0["defrag_stream"] + 1
        assert ep.SYNCS["defrag_dense"] == s0["defrag_dense"] + 1
        for x, y in zip(leaves(*a), leaves(*b)):
            assert torch.equal(x, y)
    assert widest > 16384
    assert ep.SYNCS["defrag_wide"] > w0


@pytest.mark.cuda
@pytest.mark.parametrize("case", APPEND_CASES)
def test_append_edge_cases_on_card(cuda_device, case):
    _append_both(append_case(case), cuda_device)


@pytest.mark.cuda
def test_wrappers_check_what_the_kernels_assume_on_card(cuda_device):
    """dtype, shape, device and contiguity are checked before a launch."""
    c = rows_case("lims_512")
    d, w, t, z = _cuda(_t(c["dst"], c["w"], c["ts"], c["size"]),
                       cuda_device)
    for bad in ((d.long(), w, t, z), (d, w.double(), t, z),
                (d, w, t[:, :-1], z), (d, w, t, z[:-1]),
                (d, w, t, z.cpu()), (d, w.t().contiguous().t(), t, z)):
        with pytest.raises(ValueError):
            compact_rows(*bad)
    a = _cuda(_t(*[append_case("extents")[k] for k in APPEND_ARGS]),
              cuda_device)
    for i, bad in ((1, a[1].double()), (3, a[3][:-1]), (11, a[11].cpu())):
        with pytest.raises(ValueError):
            append_edges(*a[:i], bad, *a[i + 1:])


@pytest.mark.cuda
def test_append_is_one_kernel_per_call_on_card(cuda_device, tmp_path):
    """One call, one launch: three ``append_edges`` calls captured in a
    CUDA graph make exactly three nodes, each an ``append_kernel`` kernel
    node, and the launch counter counts three launches. The graph holds
    every node the calls launched (read through the driver API), so the
    count cannot drop one, as profiler events can."""
    import ctypes
    import re
    from repro_torch.kernels import ops
    cu = ctypes.CDLL("libcuda.so.1")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (
            ("cuGraphGetNodes", [ptr, ctypes.POINTER(ptr),
                                 ctypes.POINTER(ctypes.c_size_t)]),
            ("cuGraphNodeGetType", [ptr, ctypes.POINTER(i32)]),
            ("cuGraphDebugDotPrint", [ptr, ctypes.c_char_p, ctypes.c_uint])):
        getattr(cu, name).argtypes = argtypes
        getattr(cu, name).restype = i32
    c = append_case("extents")
    args = _cuda(_t(*[c[k] for k in APPEND_ARGS]), cuda_device)
    append_edges(*args)                      # build and load first
    torch.cuda.synchronize()
    before = ops.launch_counts()["append"]
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(3):
            append_edges(*args)
    assert ops.launch_counts()["append"] == before + 3
    raw = ptr(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ptr * n.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = i32(-1)
        assert cu.cuGraphNodeGetType(ptr(node), ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    assert kinds == [0, 0, 0], kinds          # CU_GRAPH_NODE_TYPE_KERNEL
    # the kernels' names, from the graph's verbose DOT description
    dot = tmp_path / "append.dot"
    assert cu.cuGraphDebugDotPrint(raw, str(dot).encode(), 1) == 0
    blocks = re.split(r'^\s*(?="graph_\d+_node_\d+"\s*\[)', dot.read_text(),
                      flags=re.M)
    kernels = [b for b in blocks if "KERNEL" in b]
    assert len(kernels) == 3, dot.read_text()
    assert all("append_kernel" in k for k in kernels), kernels


@pytest.mark.cuda
def test_sort_lookup_kernel_on_card(cuda_device):
    from repro_torch.core.sort import (SortSpec as TSpec, insert_mappings,
                                       make_sort)
    rng = np.random.default_rng(0)
    n = 5000
    spec = TSpec.from_config(optimize_sort(n, 32, 5), 2 * n)
    st = make_sort(spec, cuda_device)
    ids = rng.choice(2 ** 32, n, replace=False).astype(np.uint64)
    st = insert_mappings(spec, st, tpack_keys(ids, 32, cuda_device),
                         torch.arange(n, dtype=torch.int32,
                                      device=cuda_device),
                         torch.ones(n, dtype=torch.bool, device=cuda_device))
    q = tpack_keys(np.concatenate([ids, rng.choice(2 ** 32, 3000).astype(
        np.uint64)]), 32, cuda_device)
    a = sort_lookup(st.pools, q, fanout_bits=spec.fanout_bits,
                    bit_offsets=spec.bit_offsets)
    b = sort_lookup_plain(st.pools, q, fanout_bits=spec.fanout_bits,
                          bit_offsets=spec.bit_offsets)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _frontier_inputs(seed, NB, BS, W, owner_hi=None, dst_hi=None):
    """Random blocks and bitmaps; ids reach past the bitmap and below 0
    (the oracle clips the owner, drops the dst)."""
    rng = np.random.default_rng(seed)
    n = 32 * W
    owner = rng.integers(-1, owner_hi or n + 8, NB).astype(np.int32)
    dst = rng.integers(-1, dst_hi or n + 8, (NB, BS)).astype(np.int32)
    valid = rng.random((NB, BS)) < 0.5
    f = rng.integers(0, 2 ** 32, W, dtype=np.uint32).view(np.int32)
    v = rng.integers(0, 2 ** 32, W, dtype=np.uint32).view(np.int32)
    return owner, dst, valid, f, v


@pytest.mark.cuda
@pytest.mark.parametrize("NB,BS,W", [(32, 8, 4), (1000, 16, 64),
                                     (1 << 22, 1, 1 << 18)])
@pytest.mark.parametrize("seed", [0, 1])
def test_frontier_kernel_on_card(cuda_device, NB, BS, W, seed):
    """The sweep shape of tests/test_kernels.py, a pool-like shape, and
    the analytics path's CSR view at n_cap = 2^23 (W = 2^18)."""
    args = _cuda(_t(*_frontier_inputs(seed, NB, BS, W)), cuda_device)
    a = frontier_expand(*args)
    b = frontier_expand_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_frontier_kernel_hub_destinations_on_card(cuda_device):
    """Every entry ORs into a handful of words: atomic contention must not
    lose a bit."""
    NB, W = 1 << 16, 64
    rng = np.random.default_rng(7)
    owner = np.zeros(NB, np.int32)
    dst = rng.integers(0, 64, (NB, 1)).astype(np.int32)
    valid = np.ones((NB, 1), bool)
    f = np.full(W, -1, np.int32)
    v = np.zeros(W, np.int32)
    args = _cuda(_t(owner, dst, valid, f, v), cuda_device)
    a = frontier_expand(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, frontier_expand_plain(*args))
    assert a[:2].tolist() == [-1, -1] and not a[2:].any()


@pytest.mark.cuda
def test_bfs_and_khop_kernel_vs_plain_on_card(cuda_device):
    """bfs and khop give the same depths and counts through the frontier
    kernel and through its plain version, on a card-resident store."""
    from repro_torch.analytics import bfs, khop
    from repro_torch.api import OpBatch, ReadOp, make_store
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    ids = rng.choice(2 ** 32, 2000, replace=False).astype(np.uint64)
    s = ids[rng.integers(0, 2000, 20000)]
    d = ids[rng.integers(0, 2000, 20000)]
    store = make_store("local", device=cuda_device, n_max=4096,
                       expected_n=2000, pool_blocks=8192, block_size=16,
                       batch=1024, undirected=True, m_cap=1 << 16)
    store.apply(OpBatch.edges(s, d))
    snap = store.read(ReadOp("snapshot"))
    src = int(store.graph.lookup(ids[:1])[0])
    before = ops.launch_counts()["frontier_expand"]
    a = bfs(snap, src)
    srcs = torch.from_numpy(store.graph.lookup(ids[:8])).to(cuda_device)
    ka = khop(snap, srcs, k=2)
    assert ops.launch_counts()["frontier_expand"] > before
    assert torch.equal(a, bfs(snap, src, impl="ref"))
    assert torch.equal(ka, khop(snap, srcs, k=2, impl="ref"))


@pytest.mark.cuda
def test_sharded_analytics_on_card(cuda_device):
    """A small 4-shard store on the card answers bfs, k-hop (k = 1, 2, 3)
    and wcc as the same store on the CPU does, and the card's run went
    through the frontier and SORT lookup kernels."""
    from repro_torch.api import AnalyticsOp, OpBatch, make_store
    from repro_torch.kernels import ops
    rng = np.random.default_rng(4)
    ids = rng.choice(2 ** 32, 3000, replace=False).astype(np.uint64)
    s = ids[rng.integers(0, 3000, 20000)]
    d = ids[rng.integers(0, 3000, 20000)]
    w = rng.uniform(0.5, 2.0, 20000).astype(np.float32)
    w[rng.random(20000) < 0.1] = 0.0
    kw = dict(n_shards=4, n_per_shard=8192, expected_n=3000,
              pool_blocks=4096, block_size=16, dmax=512, k_max=64,
              batch=1024, query_batch=64, m_cap=1 << 15, frontier_budget=64)
    queries = [AnalyticsOp("bfs", {"source": int(s[0])}),
               AnalyticsOp("wcc")]
    queries += [AnalyticsOp("khop", {"sources": ids[:40], "k": k})
                for k in (1, 2, 3)]
    answers = []
    for dev in ("cpu", cuda_device):
        store = make_store("sharded", device=dev, **kw)
        assert store.apply(OpBatch.edges(s, d, w)).dropped == 0
        before = ops.launch_counts()
        answers.append([store.analytics(op) for op in queries])
        after = ops.launch_counts()
    for k in ("frontier_expand", "sort_lookup"):
        assert after[k] > before[k], k
    cpu, card = answers
    for op, a, b in zip(queries, cpu, card):
        if isinstance(a, dict):
            assert a == b, op.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=op.name)
    assert max(cpu[0].values()) >= 2 and cpu[4].sum() > cpu[2].sum()


# ---- durability on the card ----

DUR_KW = dict(n_max=512, expected_n=64, pool_blocks=1024, block_size=8,
              batch=128, dmax=256, k_max=64, m_cap=2048)


def _dur_batches(seed, n_batches=8, size=96):
    from repro_torch.api import OpBatch
    rng = np.random.default_rng(seed)
    ids = rng.choice(2 ** 32, 48, replace=False).astype(np.uint64)
    out = []
    for _ in range(n_batches):
        w = rng.uniform(0.5, 2.0, size).astype(np.float32)
        w[rng.random(size) < 0.1] = 0.0
        out.append(OpBatch.edges(rng.choice(ids, size), rng.choice(ids, size),
                                 w))
    return out


def _leaves_equal(a, b):
    from repro_torch.storage.checkpoint import flatten_named
    for (name, x), (_, y) in zip(flatten_named(a), flatten_named(b)):
        assert torch.equal(x.cpu(), y.cpu()), name


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A full checkpoint of a card-resident store restores on the card
    equal in every leaf; a delta on top equal on every owned block."""
    from repro_torch.api import make_store
    from repro_torch.storage.crash_smoke import assert_states_equal
    s = make_store("local", device=cuda_device, **DUR_KW)
    batches = _dur_batches(0)
    for b in batches[:4]:
        s.apply(b)
    assert s.checkpoint(tmp_path)["kind"] == "full"
    f = make_store("local", device=cuda_device, **DUR_KW)
    f.restore(tmp_path)
    assert f.graph.state.pool.dst.device == s.graph.state.pool.dst.device
    _leaves_equal(s.graph.state, f.graph.state)
    for b in batches[4:]:
        s.apply(b)
    assert s.checkpoint(tmp_path, max_delta_frac=0.9)["kind"] == "delta"
    f = make_store("local", device=cuda_device, **DUR_KW)
    f.restore(tmp_path)
    assert_states_equal(s.graph.state, f.graph.state, "delta on the card")


@pytest.mark.cuda
def test_recover_on_card_from_cpu_directory(cuda_device, tmp_path):
    """A durable directory written on the CPU recovers on the card into
    the state the CPU recovers, leaf for leaf, through the kernels."""
    import shutil
    from repro_torch.api import make_store
    from repro_torch.kernels import ops
    from repro_torch.storage import DurableStore, recover
    store = DurableStore(make_store("local", device="cpu", **DUR_KW),
                         tmp_path / "w", group_commit=1, checkpoint_every=3,
                         max_delta_frac=0.9)
    for b in _dur_batches(1):
        store.apply(b)
    store.close()
    shutil.copytree(tmp_path / "w", tmp_path / "c")
    cpu, rc = recover(tmp_path / "c",
                      lambda: make_store("local", device="cpu", **DUR_KW))
    before = ops.launch_counts()["append"]
    card, rg = recover(tmp_path / "w", lambda: make_store(
        "local", device=cuda_device, **DUR_KW))
    assert rg == rc and rg["replayed"] == 2
    assert ops.launch_counts()["append"] > before
    _leaves_equal(cpu.graph.state, card.graph.state)


# ---- the vertex-index baselines on the card ----

def _art_ids(case, rng):
    """(key_bits, n_max, dense_frac, ids): random 32-bit IDs; IDs under 40
    16-bit prefixes (nodes metamorphose to dense); more 24-bit IDs than the
    tree's node and dense-row capacity (both overflow)."""
    if case == "random32":
        return 32, 4100, 0.25, rng.choice(2 ** 32, 4000, replace=False)
    if case == "clustered":
        pre = rng.choice(2 ** 16, 40, replace=False).astype(np.uint64)
        ids = (pre[rng.integers(0, 40, 4000)] << np.uint64(16)) | \
            rng.integers(0, 2 ** 16, 4000).astype(np.uint64)
        ids = np.unique(ids)
        return 32, len(ids) + 8, 0.25, ids
    return 24, 6000, 0.001, rng.choice(2 ** 24, 20000, replace=False)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random32", "clustered", "overflow"])
def test_art_insert_kernel_on_card(cuda_device, case):
    """``art_insert`` (one launch a batch) against its plain per-key loop
    on the CPU, from the same state: every ``ArtState`` tensor
    bit-exact after each of two batches, and equal lookups."""
    from repro_torch.baselines import TorchART
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    bits, n_max, frac, ids = _art_ids(case, rng)
    ids = np.asarray(ids, np.uint64)
    card = TorchART(n_max=n_max, key_bits=bits, dense_frac=frac,
                    device=cuda_device)
    host = TorchART(n_max=n_max, key_bits=bits, dense_frac=frac,
                    device="cpu")
    half = len(ids) // 2
    for lo, hi in ((0, half), (half // 2, len(ids))):
        off = np.arange(lo, hi, dtype=np.int32)
        before = ops.launch_counts()["art_insert"]
        card.insert(ids[lo:hi], off)
        torch.cuda.synchronize()
        assert ops.launch_counts()["art_insert"] == before + 1
        host.insert(ids[lo:hi], off)
        for name in ("skeys", "schild", "dense_of", "dchild"):
            for i, (a, b) in enumerate(zip(getattr(card.state, name),
                                           getattr(host.state, name))):
                assert torch.equal(a.cpu(), b), (case, name, i)
        for name in ("scount", "dcount", "overflow"):
            assert torch.equal(getattr(card.state, name).cpu(),
                               getattr(host.state, name)), (case, name)
    if case == "overflow":
        assert int(host.state.overflow) > 0
        assert host.state.dcount.tolist()[1] == 64      # cap_d reached
    if case == "clustered":
        assert host.state.dcount.tolist()[2] == 40
    q = np.concatenate([ids, rng.choice(2 ** bits, 2000).astype(np.uint64)])
    np.testing.assert_array_equal(card.lookup(q), host.lookup(q))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [24, 32])
def test_hash_index_winner_rule_on_card(cuda_device, bits):
    """``HashIndex`` on the card against its CPU run, on a batch whose
    keys repeat and collide (table at load 0.75, four probe rounds):
    claims and value writes pick the same winners, every slot holds a
    whole key, and the counters agree."""
    from repro_torch.baselines import HashIndex
    rng = np.random.default_rng(bits)
    ids = rng.choice(2 ** bits, 1536, replace=False).astype(np.uint64)
    batch = np.concatenate([ids, rng.choice(ids[:64], 512)])
    perm = rng.permutation(len(batch))
    off = np.arange(len(batch), dtype=np.int32)[perm]
    idx = [HashIndex(n_max=1024, key_bits=bits, rounds=4, device=d)
           for d in (cuda_device, "cpu")]
    for h in idx:
        h.insert(batch[perm], off)
    torch.cuda.synchronize()
    for name in ("khi", "klo", "val", "used", "overflow"):
        assert torch.equal(getattr(idx[0].state, name).cpu(),
                           getattr(idx[1].state, name)), name
    assert int(idx[1].state.overflow) > 0
    np.testing.assert_array_equal(idx[0].lookup(ids), idx[1].lookup(ids))
