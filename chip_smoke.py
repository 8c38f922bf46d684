#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of RadixGraph on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--ingest-ops 4194304] [--mixed-ops 1048576]

Phases (any failure raises and the script exits non-zero):

1. card: print the card's name and power limit; require CUDA;
2. build: compile every kernel of ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and check each on a tiny input;
3. main path, through ``make_store("local", device="cuda")``, with state
   sized for SNAP soc-LiveJournal1 (4,847,571 vertices; n_max = 2^23, 2^23
   pool blocks of 16 entries): a powerlaw ingest stream, a mixed stream
   with 25% tombstones, one explicit rebuild, lookup / degree / neighbors
   for 4096 IDs and one snapshot. Launch counters are zeroed just before
   and read just after; a host numpy last-writer-wins oracle over the
   same stream checks the answers;
4. kernels: each kernel against its plain PyTorch version on inputs taken
   from the main path's final state at main-path shapes (bit-exact), timed
   with CUDA events;
   then ``torch.profiler`` over a few more batches (host ops, device
   busy share) and one rebuild and one snapshot timed alone;
5. whole-path parity at small size: the same stream with every kernel, and
   with every impl forced to its plain version, gives identical state.

The last two lines are the ``kernels`` JSON object and the ``ok`` object.
Nothing here imports JAX or the ``repro`` package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

LJ_VERTICES = 4_847_571          # SNAP soc-LiveJournal1
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # H100 SXM, non-tensor float32
TPU_KERNELS = {
    "append": ("src/repro_torch/kernels/csrc/append.cu",
               "src/repro/kernels/append.py:137"),
    "compact_rows": ("src/repro_torch/kernels/csrc/compact.cu",
                     "src/repro/kernels/compact.py:85"),
    "defrag_rows": ("src/repro_torch/kernels/csrc/compact.cu",
                    "src/repro/kernels/compact.py:230"),
    "sort_lookup": ("src/repro_torch/kernels/csrc/sort_lookup.cu",
                    "src/repro/kernels/sort_lookup.py:66"),
}


def say(tag, **kw):
    print(json.dumps({"phase": tag, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# stream and oracle (host, numpy)
# --------------------------------------------------------------------------

def powerlaw_stream(rng, n_vertices, n_ops, ids=None):
    """``benchmarks/common.edge_stream`` shape: IDs drawn from 2^32 without
    replacement, endpoints chosen with p ~ rank^-0.8. Returns endpoint
    INDICES into ``ids`` (the oracle works on indices)."""
    if ids is None:
        ids = rng.choice(2 ** 32, size=n_vertices, replace=False).astype(
            np.uint64)
    p = 1.0 / np.arange(1, n_vertices + 1) ** 0.8
    p /= p.sum()
    si = rng.choice(n_vertices, n_ops, p=p)
    di = rng.choice(n_vertices, n_ops, p=p)
    return ids, si, di


def oracle(n_vertices, si, di, w):
    """Last writer wins per (src, dst); tombstones (w == 0) delete.
    Returns the live pairs (src idx, dst idx, weight)."""
    key = si.astype(np.int64) * n_vertices + di.astype(np.int64)
    rev = key[::-1]
    uk, first_rev = np.unique(rev, return_index=True)
    last = len(key) - 1 - first_rev
    lw = w[last]
    live = lw != 0
    return si[last][live], di[last][live], lw[live]


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------

def leaves(tree):
    """Tensors of a (nested) NamedTuple state, in order."""
    out = []
    for x in tree:
        out.extend(leaves(x) if isinstance(x, tuple) else [x])
    return out


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def cuda_ms(fn, reps=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(xs, ys):
    import torch
    err = 0.0
    for x, y in zip(xs, ys):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, float((x.double() - y.double()).abs().max()))
        if not torch.equal(x, y):
            raise AssertionError(f"kernel and plain version differ "
                                 f"(max abs err {err})")
    return err


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_build():
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import append as ka, compact as kc, \
        sort_lookup as ks
    t0 = time.perf_counter()
    secs = _build.build()
    say("build", seconds=round(time.perf_counter() - t0, 3),
        per_source={k: round(v, 3) for k, v in secs.items()},
        build_dir=str(_build.build_dir()))
    for name in _build.SOURCES:
        log = (_build.build_dir() / f"{name}.ptxas.txt")
        if log.exists():
            lines = [ln for ln in log.read_text().splitlines()
                     if "registers" in ln or "spill" in ln]
            say("ptxas", source=name, report=lines[:12])
    # tiny first launch of each kernel, held against its plain version
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    d = torch.randint(-1, 20, (3, 40), generator=g, dtype=torch.int32)
    w = torch.randint(0, 3, (3, 40), generator=g).float()
    t = torch.randperm(120, generator=g).reshape(3, 40).to(torch.int32)
    z = torch.tensor([40, 17, 0], dtype=torch.int32)
    args = [x.to(dev) for x in (d, w, t, z)]
    max_abs_err(kc.compact_rows(*args), kc.compact_rows_plain(*args))
    max_abs_err(kc.defrag_rows(*args), kc.defrag_rows_plain(*args))
    max_abs_err(kc.defrag_rows(*args, keep_all=True),
                kc.defrag_rows_plain(*args, keep_all=True))
    pools = [torch.tensor([0, -1, 1, -1], dtype=torch.int32, device=dev),
             torch.tensor([5, 6, -1, 7], dtype=torch.int32, device=dev)]
    keys = torch.tensor([[0, 0], [0, 1], [0, 2], [0, 3]], dtype=torch.int64,
                        device=dev)
    kw = dict(fanout_bits=(1, 1), bit_offsets=(1, 0))
    max_abs_err([ks.sort_lookup(pools, keys, **kw)],
                [ks.sort_lookup_plain(pools, keys, **kw)])
    pd = torch.full((8, 4), -1, dtype=torch.int32, device=dev)
    pd[0, :3] = torch.tensor([2, 3, 2], dtype=torch.int32)
    pw = torch.ones((8, 4), device=dev)
    pt = torch.arange(32, dtype=torch.int32, device=dev).reshape(8, 4) + 1
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    ops = (i32([0, 1]), i32([3, 0]), torch.tensor([True, True], device=dev),
           i32([2, 9]), torch.tensor([0.0, 2.0], device=dev), i32([50, 51]),
           i32([0, 0, -1]), i32([3, 3, 0]), i32([2, 4, 1]))
    a = [x.clone() for x in (pd, pw, pt)]
    b = [x.clone() for x in (pd, pw, pt)]
    wa = ka.append_edges(*a, *ops)
    wb = ka.append_edges_plain(*b, *ops)
    max_abs_err([wa, *a], [wb, *b])
    torch.cuda.synchronize()
    say("build_check", ok=True)


def phase_main(args, torch):
    from repro_torch.api import OpBatch, ReadOp, make_store
    from repro_torch.core import edgepool as ep
    from repro_torch.kernels import ops as kops

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    ids, si, di = powerlaw_stream(rng, LJ_VERTICES, args.ingest_ops)
    _, msi, mdi = powerlaw_stream(rng, LJ_VERTICES, args.mixed_ops, ids)
    w_in = rng.uniform(0.5, 2.0, args.ingest_ops).astype(np.float32)
    w_mx = rng.uniform(0.5, 2.0, args.mixed_ops).astype(np.float32)
    w_mx[rng.random(args.mixed_ops) < 0.25] = 0.0
    say("stream", seconds=round(time.perf_counter() - t0, 3),
        ingest_ops=args.ingest_ops, mixed_ops=args.mixed_ops,
        vertices=LJ_VERTICES, seed=args.seed)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = make_store("local", device="cuda", n_max=2 ** 23,
                       expected_n=LJ_VERTICES, key_bits=32,
                       pool_blocks=2 ** 23, block_size=16)
    g = store.graph
    torch.cuda.synchronize()
    say("store", seconds=round(time.perf_counter() - t0, 3),
        fanout_bits=list(g.sort_spec.fanout_bits),
        sort_pool_bytes=nbytes(g.state.sort),
        vertex_table_bytes=nbytes(g.state.vt),
        edge_pool_bytes=nbytes(g.state.pool),
        batch=g.batch, dmax=g.dmax, k_max=g.k_max, k_big=g.k_big,
        pipeline_depth=g.pipeline_depth)

    B = g.batch
    kops.reset_launch_counts()
    s0 = dict(ep.SYNCS)
    lat = []
    rebuild_ms = {"defrag_stream": 0.0, "defrag_dense": 0.0}

    def timed_rebuilds(fn):
        """Run ``fn`` and add the rebuild time it paid (the facade's
        ``defrag_ms``) to the bucket of the rebuild path it took."""
        before, ms0 = dict(ep.SYNCS), g.defrag_ms
        out = fn()
        for path in rebuild_ms:
            if ep.SYNCS[path] > before[path]:
                rebuild_ms[path] += g.defrag_ms - ms0
        return out

    def run(si_, di_, w_, tag, rebuild_after=None):
        t_start = time.perf_counter()
        for lo in range(0, len(si_), B):
            hi = min(lo + B, len(si_))
            t = time.perf_counter()
            res = timed_rebuilds(lambda: store.apply(OpBatch.edges(
                ids[si_[lo:hi]], ids[di_[lo:hi]], w_[lo:hi])))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
            if res.dropped:
                raise AssertionError(f"{tag}: {res.dropped} ops dropped")
            if rebuild_after is not None and hi == rebuild_after:
                # one maintenance rebuild while every extent still fits
                # dmax: the streaming (defrag_rows) path
                before = ep.SYNCS["defrag_stream"]
                timed_rebuilds(g.defrag)
                if ep.SYNCS["defrag_stream"] == before:
                    raise AssertionError("explicit rebuild did not stream")
        return time.perf_counter() - t_start

    t_ing = run(si, di, w_in, "ingest", rebuild_after=min(8 * B,
                                                          args.ingest_ops))
    t_mix = run(msi, mdi, w_mx, "mixed")

    # reads for 4096 distinct source IDs of the stream, drawn uniformly
    sample = np.sort(rng.choice(np.unique(np.concatenate([si, msi])), 4096,
                                replace=False))
    q = ids[sample]
    t0 = time.perf_counter()
    found = store.read(ReadOp("lookup", ids=q))
    deg = store.read(ReadOp("degree", ids=q))
    nbrs = store.read(ReadOp("neighbors", ids=q))
    torch.cuda.synchronize()
    t_reads = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = store.read(ReadOp("snapshot"))
    m_snap = int(snap.m)
    t_snap = time.perf_counter() - t0
    n_edges = store.read(ReadOp("num_edges"))
    torch.cuda.synchronize()
    launches = kops.launch_counts()
    syncs = {k: ep.SYNCS[k] - s0[k] for k in s0}
    peak = torch.cuda.max_memory_allocated()

    # ---- checks against the host oracle ----
    t0 = time.perf_counter()
    osrc, odst, ow = oracle(LJ_VERTICES, np.concatenate([si, msi]),
                            np.concatenate([di, mdi]),
                            np.concatenate([w_in, w_mx]))
    m = len(osrc)
    if not (n_edges == m_snap == m):
        raise AssertionError(f"edge count: num_edges {n_edges}, snapshot "
                             f"{m_snap}, oracle {m}")
    odeg = np.bincount(osrc, minlength=LJ_VERTICES)
    if not found.all():
        raise AssertionError("a sampled source vertex is missing")
    # reads scan at most ``dmax`` entries of an edge array (the JAX
    # package's read width); a vertex whose array is longer is answered
    # from its first dmax entries, so only those within it are checked
    offs = torch.from_numpy(g.lookup(q)).to(g.device).long()
    within = (g.state.vt.size[offs] <= g.dmax).cpu().numpy()
    if within.mean() < 0.9:
        raise AssertionError("too few sampled vertices within the read width")
    if not np.array_equal(deg[within], odeg[sample][within]):
        raise AssertionError("degree disagrees with the oracle")
    order = np.argsort(osrc, kind="stable")
    starts = np.searchsorted(osrc[order], sample)
    for j, v in enumerate(sample):
        if not within[j]:
            continue
        e = order[starts[j]:starts[j] + odeg[v]]
        exp = dict(zip(ids[odst[e]].tolist(), ow[e].tolist()))
        got = dict(zip(nbrs[j][0].tolist(), nbrs[j][1].tolist()))
        if got != exp:
            raise AssertionError(f"neighbors of {int(q[j])} disagree")
    t_oracle = time.perf_counter() - t0
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 "main path")
    n_batches = len(lat)
    total_ops = args.ingest_ops + args.mixed_ops
    say("main_path", card=card_line(), live_edges=m,
        vertices=int(store.read(ReadOp("num_vertices"))),
        updates_per_s=total_ops / (t_ing + t_mix),
        ingest_updates_per_s=args.ingest_ops / t_ing,
        mixed_updates_per_s=args.mixed_ops / t_mix,
        batch_p50_ms=float(np.percentile(lat, 50)),
        batch_p99_ms=float(np.percentile(lat, 99)),
        batches=n_batches, defrags=g.num_defrags,
        defrag_ms=g.defrag_ms, defrag_stream=syncs["defrag_stream"],
        defrag_dense=syncs["defrag_dense"],
        defrag_stream_ms=rebuild_ms["defrag_stream"],
        defrag_dense_ms=rebuild_ms["defrag_dense"],
        host_branch_syncs_per_batch=syncs["host_syncs"] / n_batches,
        reads_checked=int(within.sum()),
        reads_4096_s=t_reads, snapshot_s=t_snap,
        peak_memory_bytes=peak, oracle_check_s=t_oracle,
        launches=launches, oracle="agrees")
    return store, ids, sample, launches


def phase_kernels(store, ids, sample, launches, torch):
    """Each kernel against its plain version at main-path shapes, on
    inputs taken from the main path's final state."""
    from repro_torch.core import edgepool as ep
    from repro_torch.core.keys import pack_keys
    from repro_torch.kernels import append as ka, compact as kc, \
        sort_lookup as ks

    g = store.graph
    st, spec = g.state, g.pool_spec
    dev = g.device
    rng = np.random.default_rng(1)
    rows, shapes = {}, []

    def record(name, shape, kern, plain, check, nbytes, nops, library=None):
        out_k, out_p = check()
        match = len(out_k) == len(out_p) and all(
            torch.equal(x, y) for x, y in zip(out_k, out_p))
        err = max_abs_err(out_k, out_p)   # raises when they differ
        ms, pms = cuda_ms(kern), cuda_ms(plain, reps=5, warm=1)
        bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
        entry = dict(name=name, shape=shape, match=match,
                     max_abs_err=err, ms=ms,
                     plain_ms=pms, bound_ms=bound,
                     bound_by="bytes" if nbytes / HBM_BYTES_PER_S >=
                     nops / F32_OPS_PER_S else "operations",
                     bytes=int(nbytes), library_ms=library)
        shapes.append(entry)
        rows.setdefault(name, entry)

    # ---- sort_lookup: 2 x batch keys (the ingest shape) ----
    keys = pack_keys(ids[rng.choice(len(ids), 2 * g.batch)], 32, dev)
    keys[::7, 1] ^= 1                      # some absent IDs
    sspec = g.sort_spec
    kw = dict(fanout_bits=sspec.fanout_bits, bit_offsets=sspec.bit_offsets)
    pools = st.sort.pools
    # loads this data needs: one per layer the descent reaches
    node = torch.zeros(keys.shape[0], dtype=torch.int32, device=dev)
    alive = torch.ones(keys.shape[0], dtype=torch.bool, device=dev)
    loads = 0
    from repro_torch.core.keys import extract_bits
    for pool, a, boff in zip(pools, *kw.values()):
        loads += int(alive.sum())
        slot = node * (1 << a) + extract_bits(keys, boff, a)
        child = pool[slot.clamp(0, pool.shape[0] - 1).long()]
        alive = alive & (child >= 0)
        node = child.clamp_min(0)
    record("sort_lookup", [keys.shape[0], 2],
           lambda: ks.sort_lookup(pools, keys, **kw),
           lambda: ks.sort_lookup_plain(pools, keys, **kw),
           lambda: ([ks.sort_lookup(pools, keys, **kw)],
                    [ks.sort_lookup_plain(pools, keys, **kw)]),
           keys.numel() * 8 + loads * 4 + keys.shape[0] * 4,
           loads * 4)

    # ---- append: one op per distinct vertex at its next free slot, a
    # probe of each vertex's whole extent for one of its own dsts ----
    vt = st.vt
    off = torch.from_numpy(g.lookup(ids[sample])).to(dev).long()
    off = off[off >= 0][:g.batch]
    P = off.shape[0]
    pstart = vt.start_block[off].contiguous()
    psize = vt.size[off].contiguous()
    cap = vt.cap[off]
    pick = (torch.rand(P, device=dev, generator=torch.Generator(
        device=dev).manual_seed(2)) * psize.clamp_min(1)).long()
    flat = pstart.long() * spec.block_size + pick
    pv = st.pool.dst.view(-1)[flat.clamp(0, spec.capacity_entries - 1)]
    pv = torch.where(psize > 0, pv, -1).to(torch.int32).contiguous()
    wval = (psize < cap) & (pstart >= 0)
    wblk = (pstart + psize // spec.block_size).to(torch.int32).contiguous()
    wlane = (psize % spec.block_size).to(torch.int32).contiguous()
    wd = pv.clamp_min(0).contiguous()
    ww = torch.full((P,), 1.5, device=dev)
    wts = (st.pool.clock + torch.arange(P, device=dev,
                                        dtype=torch.int32)).contiguous()
    ops = (wblk, wlane, wval, wd, ww, wts, pstart, psize, pv)
    pk = [t.clone() for t in (st.pool.dst, st.pool.weight, st.pool.ts)]
    pp = [t.clone() for t in pk]
    was_k = ka.append_edges(*pk, *ops)
    was_p = ka.append_edges_plain(*pp, *ops)
    probed = int(psize[(pstart >= 0) & (pv >= 0)].sum())
    nv = int(wval.sum())
    record("append", [spec.n_blocks, spec.block_size, P],
           lambda: ka.append_edges(*pk, *ops),
           lambda: ka.append_edges_plain(*pp, *ops),
           lambda: ([was_k, *pk], [was_p, *pp]),
           probed * 8 + P * 4 + nv * 12 + P * (6 * 4 + 1) + P * 13,
           probed)
    del pk, pp

    # ---- compact_rows: the three main-path shapes, from real rows ----
    live = (vt.del_time == 0) & (vt.start_block >= 0)
    sz = torch.where(live, vt.size, 0)

    def rows_of(lo, hi, k):
        cand = torch.nonzero((sz > lo) & (sz <= hi)).flatten()
        cand = cand[torch.randperm(cand.numel(), device=dev)[:k]]
        u = torch.full((k,), -1, dtype=torch.int32, device=dev)
        u[:cand.numel()] = cand.to(torch.int32)
        return u

    def compact_case(u, width, name="compact_rows", defrag=False):
        d, w, t, s = ep._gather_vertex_entries(spec, st.pool, vt, u, width)
        d, w, t, s = (x.contiguous() for x in (d, w, t, s))
        occupied = int(s.clamp(max=width).sum())
        nbytes = occupied * 12 + d.numel() * 12 + s.numel() * 8
        nops = occupied * max(1, int(np.log2(max(width, 2))))
        if defrag:
            f, fp = kc.defrag_rows, kc.defrag_rows_plain
        else:
            f, fp = kc.compact_rows, kc.compact_rows_plain
        record(name, [u.shape[0], width], lambda: f(d, w, t, s),
               lambda: fp(d, w, t, s),
               lambda: (list(f(d, w, t, s)), list(fp(d, w, t, s))),
               nbytes, nops)

    compact_case(off.to(torch.int32)[:g.batch].contiguous(), spec.dmax)
    compact_case(rows_of(0, spec.probe_width, spec.k_max), spec.probe_width)
    compact_case(rows_of(spec.probe_width, spec.dmax, spec.k_big), spec.dmax)
    for W, budget in ep._defrag_tiers(spec, g.n_max):
        C = ep._defrag_chunks(W, budget)[0][1]
        compact_case(rows_of(W // 8 if W > spec.block_size else 0, W, C), W,
                     "defrag_rows", defrag=True)
    torch.cuda.synchronize()
    say("kernel_shapes", card=card_line(), shapes=shapes)
    out = []
    for name, (src, replaces) in TPU_KERNELS.items():
        r = rows[name]
        out.append(dict(name=name, route="cuda", source=src,
                        replaces=replaces, launches=launches[name],
                        match=r["match"], max_abs_err=r["max_abs_err"],
                        ms=r["ms"], kernel_ms=r["ms"],
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None,
                        shape=r["shape"]))
    return out


def _ev_attr(e, *names):
    for n in names:
        if hasattr(e, n):
            return getattr(e, n)
    return 0.0


def phase_profile(store, ids, torch, n_batches=16):
    """Where a steady-state batch's time goes: ``n_batches`` mixed batches
    under ``torch.profiler`` (host ops by self CPU time, device busy
    share), then one explicit rebuild and one snapshot, timed alone."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import OpBatch, ReadOp
    from repro_torch.core import edgepool as ep
    g = store.graph
    rng = np.random.default_rng(3)
    _, si, di = powerlaw_stream(rng, LJ_VERTICES, (n_batches + 2) * g.batch,
                                ids)
    w = rng.uniform(0.5, 2.0, len(si)).astype(np.float32)
    w[rng.random(len(si)) < 0.25] = 0.0
    B = g.batch

    def batch(i):
        sl = slice(i * B, (i + 1) * B)
        store.apply(OpBatch.edges(ids[si[sl]], ids[di[sl]], w[sl]))

    batch(0)
    batch(1)
    torch.cuda.synchronize()
    d0 = g.num_defrags
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, n_batches + 2):
            batch(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = sum(_ev_attr(e, "self_device_time_total", "self_cuda_time_total")
                 for e in ka)
    top = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:14]
    say("profile_batches", card=card_line(), batches=n_batches,
        defrags_in_window=g.num_defrags - d0,
        batch_ms=wall * 1e3 / n_batches,
        device_busy_share=dev_us / (wall * 1e6),
        host_ops_per_batch=sum(e.count for e in ka
                               if e.key.startswith("aten::")) / n_batches,
        top_host_ops=[dict(op=e.key, calls=e.count,
                           self_cpu_ms=e.self_cpu_time_total / 1e3,
                           device_ms=_ev_attr(e, "self_device_time_total",
                                              "self_cuda_time_total") / 1e3)
                      for e in top])
    s0 = dict(ep.SYNCS)
    t0 = time.perf_counter()
    g.defrag()
    torch.cuda.synchronize()
    t_defrag = time.perf_counter() - t0
    path = "stream" if ep.SYNCS["defrag_stream"] > s0["defrag_stream"] \
        else "dense"
    t0 = time.perf_counter()
    m = int(store.read(ReadOp("snapshot")).m)
    torch.cuda.synchronize()
    say("profile_rebuild", card=card_line(), defrag_s=t_defrag,
        defrag_path=path, snapshot_s=time.perf_counter() - t0,
        snapshot_m=m)


def phase_parity(torch):
    """The same small stream through every kernel and through every plain
    version: identical state, leaf for leaf."""
    from repro_torch.api import OpBatch, ReadOp, make_store
    from repro_torch.kernels import ops as kops
    rng = np.random.default_rng(5)
    ids, si, di = powerlaw_stream(rng, 3000, 60_000)
    w = rng.uniform(0.5, 2.0, len(si)).astype(np.float32)
    w[rng.random(len(si)) < 0.25] = 0.0
    si[20_000:24_000] = np.arange(4000) % 40   # 40 medium hubs at once
    base = dict(n_max=8192, expected_n=3000, key_bits=32, pool_blocks=16384,
                block_size=16, batch=1024, dmax=512, k_max=32, k_big=4,
                probe_width=64, device="cuda")
    states, counts, reads = [], [], []
    for impl in ({}, dict(append_impl="plain", compact_impl="ref",
                          lookup_impl="ref")):
        kops.reset_launch_counts()
        s = make_store("local", **base, **impl)
        for lo in range(0, len(si), 10_000):
            s.apply(OpBatch.edges(ids[si[lo:lo + 10_000]],
                                  ids[di[lo:lo + 10_000]],
                                  w[lo:lo + 10_000]))
        s.graph.defrag()
        s.apply(OpBatch.edges(ids[si[:3000]], ids[di[:3000]], w[:3000]))
        torch.cuda.synchronize()
        states.append(s.graph.state)
        counts.append(kops.launch_counts())
        reads.append(s.read(ReadOp("neighbors", ids=ids[:500])))
    la, lb = leaves(states[0]), leaves(states[1])
    if len(la) != len(lb):
        raise AssertionError("state structures differ")
    for a, b in zip(la, lb):
        if not torch.equal(a, b):
            raise AssertionError("kernel path and plain path states differ")
    for (ia, wa), (ib, wb) in zip(*reads):
        if not (np.array_equal(ia, ib) and np.array_equal(wa, wb)):
            raise AssertionError("kernel path and plain path reads differ")
    if min(counts[0].values()) <= 0 or max(counts[1].values()) != 0:
        raise AssertionError(f"launch counts {counts}")
    say("parity", identical=True, leaves=len(la),
        defrags=int(states[0].pool.defrags), kernel_launches=counts[0],
        plain_launches=counts[1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ingest-ops", type=int, default=1 << 22)
    ap.add_argument("--mixed-ops", type=int, default=1 << 20)
    args = ap.parse_args(argv)

    print(card_line(), flush=True)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    import repro_torch  # noqa: F401  (fails outside a checkout)
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    if args.ingest_ops < (1 << 22) or args.mixed_ops < (1 << 20):
        say("reduced", ingest_ops=args.ingest_ops, mixed_ops=args.mixed_ops)

    t0 = time.perf_counter()
    phase_build()
    store, ids, sample, launches = phase_main(args, torch)
    kernels = phase_kernels(store, ids, sample, launches, torch)
    phase_profile(store, ids, torch)
    del store
    torch.cuda.empty_cache()
    phase_parity(torch)
    say("done", seconds=round(time.perf_counter() - t0, 3))
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
