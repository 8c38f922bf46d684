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


def _append_inputs(seed, NB, BS, B):
    """Random pools and ops with distinct write slots (the edge pool never
    lands two ops on one slot)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, 16, (NB, BS)).astype(np.int32)
    w = np.round(rng.uniform(0, 2, (NB, BS))).astype(np.float32)
    ts = (rng.permutation(NB * BS).reshape(NB, BS) + 1).astype(np.int32)
    flat = rng.choice(NB * BS, B, replace=False)
    return (dst, w, ts, (flat // BS).astype(np.int32),
            (flat % BS).astype(np.int32), rng.random(B) < 0.7,
            rng.integers(0, 16, B).astype(np.int32),
            np.round(rng.uniform(0, 2, B)).astype(np.float32),
            (rng.permutation(B) + NB * BS + 1).astype(np.int32),
            rng.integers(-1, NB, B).astype(np.int32),
            rng.integers(0, 3 * BS, B).astype(np.int32),
            rng.integers(-1, 16, B).astype(np.int32))


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
@pytest.mark.parametrize("K,D", [(1, 8), (4, 16), (64, 128), (32, 4096)])
@pytest.mark.parametrize("keep_all", [False, True])
def test_defrag_rows_kernel_on_card(cuda_device, K, D, keep_all):
    dst, w, ts, size = _rows(K * 3 + D, K, D, n_cap=max(64, D // 2))
    args = _cuda(_t(dst, w, ts, size), cuda_device)
    a = defrag_rows(*args, keep_all=keep_all)
    b = defrag_rows_plain(*args, keep_all=keep_all)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_append_kernel_on_card(cuda_device, seed):
    args = _t(*_append_inputs(seed, NB=4096, BS=16, B=4096))
    ka = _cuda(args, cuda_device)
    pa = [t.clone() for t in ka]
    was_k = append_edges(*ka)
    was_p = append_edges_plain(*pa)
    torch.cuda.synchronize()
    assert torch.equal(was_k, was_p)
    for x, y in zip(ka[:3], pa[:3]):
        assert torch.equal(x, y)


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
