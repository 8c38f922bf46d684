"""Edge cases of the row compactors and the fused append, made from a
numpy seed.

One generator for two test files: ``tests/test_torch_kernels.py`` holds
the plain PyTorch versions to the JAX oracles on these cases (CPU), and
``tests/test_torch_cuda.py`` holds the CUDA kernels to the plain versions
on the same cases (card). So the edge cases the card sees are the ones
the oracle has checked. This module imports no JAX (the card's machine
has none), and torch only inside ``edge_pool_append_calls``.

Every case is a dict of numpy arrays (and a few scalars) named as the
functions' arguments.
"""
import numpy as np

# row occupancies around the warp width, the one-warp limit (256) and the
# hash table's smallest sizes; the row width D and size > D are added
LIMS = (0, 1, 31, 32, 33, 255, 256, 257)
BIG_DST = 2 ** 30 - 1           # the largest valid destination offset

COMPACT_CASES = ("lims_512", "lims_4096", "one_dst", "tombstones",
                 "collide", "big_dst", "read_ts", "bf16", "bf16_read_ts",
                 "width_8192", "max_width")
DEFRAG_CASES = ("lims_512", "lims_4096", "one_dst", "tombstones", "collide",
                "big_dst", "max_width")
APPEND_CASES = ("extents", "extents_bs6", "no_probes", "no_ops", "empty",
                "out_of_range", "pool_end")
# defrag_rows launches wider than 4,096: rows past 4,096 entries are
# sorted in runs of 4,096 in device memory and merged
WIDE_CASES = ("hub", "tombstones", "sparse", "keep_all_dups", "bf16")
WIDE_WIDTHS = (20000, 2 ** 15)


def _rows(rng, sizes, D, n_dst):
    K = len(sizes)
    dst = rng.integers(-1, n_dst, (K, D)).astype(np.int32)
    w = np.round(rng.uniform(0, 2, (K, D))).astype(np.float32)
    ts = rng.permutation(K * D).reshape(K, D).astype(np.int32)
    return dict(dst=dst, w=w, ts=ts, size=np.asarray(sizes, np.int32),
                read_ts=None, wdtype="float32")


def rows_case(name: str, seed: int = 0) -> dict:
    """(K, D) rows for ``compact_rows`` / ``defrag_rows``: one row per
    occupancy of interest (``size`` > D clamps to D)."""
    rng = np.random.default_rng([seed, COMPACT_CASES.index(name)])

    def lims(D):
        return [*[x for x in LIMS if x <= D], D, D + 100]

    if name == "lims_512":
        return _rows(rng, lims(512), 512, 256)
    if name == "lims_4096":
        return _rows(rng, lims(4096) + [1000, 3000], 4096, 2048)
    if name == "one_dst":           # one destination, repeated
        c = _rows(rng, lims(512), 512, 1)
        c["dst"][:] = 7
        return c
    if name == "tombstones":        # only tombstones: nothing survives
        c = _rows(rng, lims(512), 512, 64)
        c["w"][:] = 0.0
        return c
    if name == "collide":           # multiples of the table sizes
        c = _rows(rng, lims(4096), 4096, 64)
        mult = rng.choice([64, 512, 8192], c["dst"].shape)
        c["dst"] = np.where(c["dst"] >= 0, c["dst"] * mult, -1).astype(
            np.int32)
        return c
    if name == "big_dst":           # 2^30 - 1 is valid; 2^30 and up empty
        c = _rows(rng, lims(512), 512, 8)
        pick = rng.choice([BIG_DST, BIG_DST - 1, 2 ** 30, 2 ** 31 - 1, 3],
                          c["dst"].shape)
        c["dst"] = np.where(c["dst"] >= 0, pick, -1).astype(np.int32)
        return c
    if name in ("read_ts", "bf16", "bf16_read_ts"):
        c = _rows(rng, lims(512), 512, 256)
        if "read_ts" in name:
            c["read_ts"] = int(c["ts"].size // 2)
        if "bf16" in name:
            c["wdtype"] = "bfloat16"
            c["w"] = (c["w"] * rng.choice([0.5, 1.5], c["w"].shape)).astype(
                np.float32)         # exact in bfloat16
        return c
    if name == "width_8192":        # the widest rows of the hash path
        return _rows(rng, [0, 100, 257, 5000, 8192, 9000], 8192, 4096)
    if name == "max_width":         # MAX_ROW_WIDTH: the sort path
        return _rows(rng, [0, 300, 9000, 16384], 16384, 8192)
    raise KeyError(name)


def wide_rows_case(name: str, D: int, seed: int = 0) -> dict:
    """Three (K = 3) rows of width ``D`` > 16,384 for ``defrag_rows``:

    * ``hub``: one destination rewritten thousands of times among others
      (size > D clamps), a row of that one destination only, a row of
      16,385 entries;
    * ``tombstones``: only tombstones, so nothing survives;
    * ``sparse``: occupancies far below D, around the run of 4,096 (5,
      4,096: one block each; 4,097: two runs, one of one entry);
    * ``keep_all_dups``: few destinations, each repeated, for ``keep_all``;
    * ``bf16``: bfloat16 weights (values exact in bfloat16)."""
    rng = np.random.default_rng([seed, D, WIDE_CASES.index(name)])
    sizes = {"hub": [D + 100, D - 7, 16385], "tombstones": [D, D // 2, 17000],
             "sparse": [5, 4096, 4097], "keep_all_dups": [D, 16390, D - 1],
             "bf16": [D, D // 2 + 3, 700]}[name]
    n_dst = {"keep_all_dups": 50}.get(name, 8 * D)
    c = _rows(rng, sizes, D, n_dst)
    if name == "hub":
        hub = rng.random((3, D)) < 0.5
        c["dst"][0] = np.where(hub[0], 7, c["dst"][0])
        c["dst"][1] = 7
    elif name == "tombstones":
        c["w"][:] = 0.0
    elif name == "bf16":
        c["wdtype"] = "bfloat16"
        c["w"] = (c["w"] * rng.choice([0.5, 1.5], c["w"].shape)).astype(
            np.float32)
    return c


def append_case(name: str, seed: int = 0, owners: int = 24,
                n_probes: int = 40, n_ops: int = 32) -> dict:
    """Pools and ops laid out as the edge pool lays them out: ``owners``
    hold extents of whole block rows, end to end up to the pool's last
    block; each probe scans its owner's occupied prefix, and every write
    slot lies in an owner's free tail, outside every probed range (the
    kernel runs probes and writes in one launch, in no order)."""
    rng = np.random.default_rng([seed, APPEND_CASES.index(name)])
    BS = 6 if name == "extents_bs6" else 16
    caps = rng.integers(1, 5, owners)             # blocks per owner
    NB = int(caps.sum())
    starts = np.concatenate([[0], np.cumsum(caps)[:-1]])
    sizes = rng.integers(0, caps * BS + 1)
    if name == "pool_end":                        # the last extent is full
        sizes[-1] = caps[-1] * BS
    dst = rng.integers(-1, 12, (NB, BS)).astype(np.int32)
    w = np.round(rng.uniform(0, 2, (NB, BS))).astype(np.float32)
    ts = (rng.permutation(NB * BS).reshape(NB, BS) + 1).astype(np.int32)
    ts.reshape(-1)[rng.random(NB * BS) < 0.1] = 7  # equal ts: lowest pos
    P = 0 if name in ("no_probes", "empty") else n_probes
    own = rng.integers(0, len(caps), P)
    if name == "pool_end":
        own[:8] = len(caps) - 1
    pstart = np.where(rng.random(P) < 0.9, starts[own], -1).astype(np.int32)
    psize = sizes[own].astype(np.int32)
    if name == "pool_end":                        # past the pool's end
        psize[:4] += 3 * BS
    pv = rng.integers(-1, 12, P).astype(np.int32)
    free = np.concatenate([s * BS + np.arange(z, c * BS) for s, z, c in
                           zip(starts, sizes, caps)]).astype(np.int64)
    B = 0 if name in ("no_ops", "empty") else min(n_ops, free.size)
    flat = rng.choice(free, B, replace=False)
    wblk = (flat // BS).astype(np.int32)
    wlane = (flat % BS).astype(np.int32)
    if name == "out_of_range":      # JAX drop mode: wrap [-n, 0), drop rest
        k = B // 6
        wblk[:k] = NB + rng.integers(0, 3, k)
        wlane[k:2 * k] = BS + rng.integers(0, 3, k)
        wblk[2 * k:3 * k] = -NB - 1 - rng.integers(0, 3, k)
        wlane[3 * k:4 * k] = -BS - 1
        # a negative index counts from the end: point it at a free slot
        wlane[4 * k:5 * k] -= BS
        wblk[5 * k:6 * k] -= NB
    return dict(dst=dst, w=w, ts=ts, wblk=wblk, wlane=wlane,
                wval=rng.random(B) < 0.8,
                wd=rng.integers(0, 12, B).astype(np.int32),
                ww=np.round(rng.uniform(0, 2, B)).astype(np.float32),
                wts=(rng.permutation(B) + NB * BS + 1).astype(np.int32),
                pstart=pstart, psize=psize, pv=pv)


APPEND_ARGS = ("dst", "w", "ts", "wblk", "wlane", "wval", "wd", "ww", "wts",
               "pstart", "psize", "pv")


def writes_outside_probes(c: dict) -> bool:
    """Whether no write of append case ``c`` that lands (``wval``, inside
    the pool after JAX's wrap of negative indices) hits an entry some
    enabled probe scans: what lets the kernel run probes and writes in
    one launch, in no order."""
    NB, BS = c["dst"].shape
    N = NB * BS
    scanned = np.zeros(N + 1, np.int64)
    on = (c["pstart"] >= 0) & (c["pv"] >= 0) & (c["psize"] > 0)
    lo = np.minimum(c["pstart"][on].astype(np.int64) * BS, N)
    hi = np.minimum(lo + c["psize"][on], N)
    np.add.at(scanned, lo, 1)
    np.add.at(scanned, hi, -1)
    scanned = np.cumsum(scanned[:N]) > 0
    b = c["wblk"].astype(np.int64)
    ln = c["wlane"].astype(np.int64)
    lands = c["wval"] & (b >= -NB) & (b < NB) & (ln >= -BS) & (ln < BS)
    flat = np.where(b < 0, b + NB, b) * BS + np.where(ln < 0, ln + BS, ln)
    return not scanned[flat[lands]].any()


def edge_pool_append_calls(device: str, seed: int = 0) -> list:
    """The inputs of every ``append_edges`` call the port's edge pool makes
    on a small powerlaw stream with tombstones, a burst of medium hubs
    (both compaction tiers) and an explicit rebuild, on ``device``: the
    append cases of the real caller, taken before each call."""
    import torch
    from repro_torch.api import OpBatch, make_store
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    n, m = 600, 9000
    ids = rng.choice(2 ** 32, n, replace=False).astype(np.uint64)
    p = 1.0 / np.arange(1, n + 1) ** 0.8
    si = rng.choice(n, m, p=p / p.sum())
    di = rng.choice(n, m, p=p / p.sum())
    si[3000:4200] = np.arange(1200) % 12          # 12 medium hubs at once
    w = rng.uniform(0.5, 2.0, m).astype(np.float32)
    w[rng.random(m) < 0.25] = 0.0
    store = make_store("local", device=device, n_max=2048, expected_n=n,
                       key_bits=32, pool_blocks=2048, block_size=16,
                       batch=1024, dmax=256, k_max=32, k_big=4,
                       probe_width=32)
    calls, real = [], ops.append_edges

    def spy(*args, **kw):
        calls.append({k: t.detach().cpu().numpy().copy()
                      for k, t in zip(APPEND_ARGS, args)})
        return real(*args, **kw)
    ops.append_edges = spy
    try:
        for lo in range(0, m, 1024):
            store.apply(OpBatch.edges(ids[si[lo:lo + 1024]],
                                      ids[di[lo:lo + 1024]],
                                      w[lo:lo + 1024]))
            if lo == 4096:
                store.graph.defrag()
    finally:
        ops.append_edges = real
    if device != "cpu":
        torch.cuda.synchronize()
    return calls
