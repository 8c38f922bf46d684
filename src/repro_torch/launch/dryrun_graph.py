"""The sharded store's run modes at pod scale (port of
``repro.launch.dryrun_graph``), through the ``repro_torch.api.GraphStore``
front door, every shard stacked on one device:

* ``--mode ingest`` (default): RUNS one routed op batch (``--batch-per-
  shard`` ops a shard; ``--pipeline-depth`` K batches through
  ``make_apply_edges_pipelined``) on a state of ``--n-per-shard`` rows a
  shard, under the cost counter (``launch.costs``);
* ``--mode analytics``: RUNS each registered mesh program of ``--algs``
  (default bfs,pagerank) on a vertex-synced state that one ingest batch
  filled, and with ``--incremental`` each algorithm's warm-advance
  program (``<alg>__advance``) seeded from its scratch values;
* ``--mode serve``: RUNS a small mixed read/write workload through
  ``serve.graph_service`` and records write ops/s and reads/s;
* ``--mode persist``: RUNS a durable ingest (WAL + epoch checkpoints via
  ``repro_torch.storage``) on a sharded store, drops the store object,
  recovers from disk, and records throughput, checkpoint / WAL footprint,
  recovery time and bit-exactness (asserted).

The JAX package's ingest and analytics modes lower each program to XLA
HLO on placeholder devices and read its cost; the port has no lowering,
so these modes run the program once at the JAX modes' per-shard sizes
and count what it ran (``launch.costs``): FLOPs and bytes of its aten
ops divided by the shard count, each exchange per shard (elements and
bytes: the port's int32 words hold JAX's uint32 ones), only the
branch taken and each loop trip made (``collective_branch_rule``
``executed``), and the kernels' launches (``launch_counts``).
``memory.argument_size_in_bytes`` is the state's bytes a shard; the op
batch or query keys are ``input_size_in_bytes``.

  python -m repro_torch.launch.dryrun_graph --mode ingest|analytics|
      serve|persist [--shards 256] [--device cuda]

Records go to ``benchmarks/results/dryrun/torch-radixgraph-<mode>__<n>
shards*.json`` with the JAX records' keys, plus the device they ran on.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import tempfile
import time

import numpy as np
import torch

from ..api import OpBatch, ReadOp, make_store
from ..core.radixgraph import GraphState
from ..dist import graph_engine as ge
from ..kernels import ops
from . import costs

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "benchmarks" / \
    "results" / "dryrun"
N_VERTICES, N_OPS = 1024, 8192      # the JAX modes' stream


def _record(name: str, rec: dict):
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / name).write_text(json.dumps(rec, indent=1))


def _device_name(device: str) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _graph_store(n: int, device: str):
    """The serve / persist modes' store: the JAX modes' sizes."""
    return make_store(
        "sharded", n_shards=n, n_per_shard=8192, expected_n=4096,
        pool_blocks=16384, block_size=16, dmax=2048, k_max=128,
        batch=512 * n, query_batch=128 * n, device=device)


def _stream():
    rng = np.random.default_rng(0)
    ids = rng.choice(2 ** 32, N_VERTICES, replace=False).astype(np.uint64)
    src, dst = rng.choice(ids, N_OPS), rng.choice(ids, N_OPS)
    w = rng.uniform(0.5, 2, N_OPS).astype(np.float32)
    return ids, src, dst, w


def _mode_serve(args, n: int) -> dict:
    from ..serve.graph_service import GraphQueryService, drive_mixed_workload
    ids, src, dst, w = _stream()
    svc = GraphQueryService(_graph_store(n, args.device))
    dt, reads = drive_mixed_workload(svc, src, dst, w, ids[:128 * n])
    tb = svc.submit_query("bfs", source=int(src[0]))
    svc.run()
    bfs_answer = svc.claim(tb)
    rec = {
        "arch": "radixgraph-serve", "shape": f"ops{N_OPS}",
        "mesh": f"graph{n}", "chips": n, "status": "ok", "kind": "graph",
        "write_ops_per_s": round(N_OPS / dt, 1),
        "read_q_per_s": round(reads / dt, 1),
        "epochs_sealed": svc.stats["epochs_sealed"],
        "ops_dropped": svc.stats["ops_dropped"],
        "bfs_reached": sum(1 for v in bfs_answer.values() if v >= 0),
        "device": _device_name(args.device),
    }
    _record(f"torch-radixgraph-serve__{n}shards.json", rec)
    print(f"[OK] graph-serve x {n} shards: {rec['write_ops_per_s']:.0f} "
          f"write ops/s, {rec['read_q_per_s']:.0f} reads/s, "
          f"{rec['epochs_sealed']} epochs, dropped {rec['ops_dropped']}")
    return rec


def _compute_store(args, n: int):
    """The ingest / analytics modes' store: the JAX modes' sizes, but for
    the SORT's capacity. The JAX modes size it 4x (``sort_capacity_factor
    4.0``), a store they only compile; run, such a store (in either
    package) finds none of the vertices it was given (ROADMAP Queue 3),
    so the analytics would run on nothing. The SORT here is sized from
    ``expected_n`` as in every other store."""
    return make_store(
        "sharded", n_shards=n, n_per_shard=args.n_per_shard,
        expected_n=args.n_per_shard,
        pool_blocks=args.n_per_shard // 2, block_size=16, k_max=256,
        dmax=4096, batch=args.batch_per_shard * n,
        m_cap=args.n_per_shard * 4, pack=not args.no_pack,
        route_budget=args.route_budget,
        frontier_budget=args.frontier_budget, device=args.device)


def _ops(store, K: int, seed: int = 0):
    """K global batches of ``store.batch`` edge inserts among n_shards x
    n_per_shard / 4 random IDs: (src IDs, dst IDs, keys (K, B, 2) of
    each, weights (K, B), mask (K, B))."""
    rng = np.random.default_rng(seed)
    B = store.batch
    n_v = store.n_shards * store.n_per_shard // 4
    ids = rng.choice(2 ** 32, n_v, replace=False).astype(np.uint64)
    src, dst = rng.choice(ids, (2, K * B))
    sk = store._keys(src).reshape(K, B, 2)
    dk = store._keys(dst).reshape(K, B, 2)
    w = torch.as_tensor(rng.uniform(0.5, 2, (K, B)).astype(np.float32),
                        device=store.device)
    mask = torch.ones((K, B), dtype=torch.bool, device=store.device)
    return src, dst, sk, dk, w, mask


def _tensor_bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in costs._tensors(x)
               if isinstance(t, torch.Tensor))


def _state_bytes(state: GraphState) -> int:
    return sum(t.numel() * t.element_size() for t in ge._leaves(state))


def _sync(device: str):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counted(args, n: int, state, inputs, fn):
    """Run ``fn()`` once under the cost counter; the record's cost keys
    (per shard) with the launches it made."""
    ops.reset_launch_counts()
    routes0 = dict(ge.ROUTES)
    _sync(args.device)
    t0 = time.perf_counter()
    with costs.CostCounter(per_shard=n) as c:
        out = fn()
        _sync(args.device)
    dt = time.perf_counter() - t0
    rec = {"status": "ok", "kind": "graph", **c.record()}
    sb = _state_bytes(state)
    rec["state_bytes"] = sb
    rec["memory"] = {
        "argument_size_in_bytes": sb // n,
        "input_size_in_bytes": _tensor_bytes(inputs) // n,
        "temp_size_in_bytes": c.peak // n,
        "output_size_in_bytes": _tensor_bytes(out) // n,
        "alias_size_in_bytes": sum(
            t.numel() * t.element_size() for t in costs._tensors(out)
            if any(t.untyped_storage().data_ptr() ==
                   s.untyped_storage().data_ptr()
                   for s in ge._leaves(state))) // n,
    }
    rec["memory_rule"] = ("per shard: argument = the state's tensor bytes "
                          "/ shards; input = the op batch or query keys; "
                          "temp = " + costs.TEMP_RULE)
    rec["launch_counts"] = ops.launch_counts()
    rec["routes"] = {k: ge.ROUTES[k] - routes0[k] for k in ge.ROUTES}
    rec["run_s"] = round(dt, 3)
    return rec, out


def _mode_ingest(args, n: int) -> dict:
    store = _compute_store(args, n)
    K = args.pipeline_depth
    _src, _dst, sk, dk, w, mask = _ops(store, K)
    state = store.state
    if K > 1:
        fn = ge.make_apply_edges_pipelined(
            store.sspec, store.pspec, n, pack=not args.no_pack,
            route_budget=args.route_budget)
        inputs = (sk, dk, w, mask)
    else:
        fn = store.apply_program()
        inputs = (sk[0], dk[0], w[0], mask[0])
    rec, (state, dropped) = _counted(args, n, state, inputs,
                                     lambda: fn(state, *inputs))
    B = store.batch
    tag = ("" if not args.no_pack else "+nopack") + \
        ("" if args.route_budget is None else f"+route{args.route_budget}") \
        + ("" if K == 1 else f"+pipe{K}")
    rec = {
        "arch": "radixgraph-ingest", "shape": f"ops{K * B}",
        "mesh": f"graph{n}" + tag, "chips": n, "batch_ops": K * B,
        "pipeline_depth": K, "batch_per_shard": args.batch_per_shard,
        **rec,
        "ops_dropped": int(dropped.sum()),
        "device": _device_name(args.device),
    }
    name = f"torch-radixgraph-ingest__{n}shards" + \
        tag.replace("+", "__") + ".json"
    _record(name, rec)
    a2a = rec["collective_elements"]["all-to-all"]
    print(f"[OK] graph-ingest x {n} shards (pack={not args.no_pack}, "
          f"K={K}): {K * B} ops in {rec['run_s']:.3f}s, a2a "
          f"{a2a:.0f} elements/shard "
          f"({sum(rec['collective_counts'].values()):.0f} collectives), "
          f"state {rec['memory']['argument_size_in_bytes'] / 2**20:.1f} "
          f"MiB/shard, launches {rec['launch_counts']}")
    return rec


# per algorithm: static knobs (the JAX mode's), whether it takes a source
# key / a (16, 2) key set; the warm form's knobs and per-row value dtype
_CATALOG = {
    "bfs": (dict(max_iters=16), "key"),
    "pagerank": (dict(iters=8), None),
    "wcc": (dict(max_iters=16), None),
    "sssp": (dict(max_iters=16), "key"),
    "bc": (dict(max_depth=8), "keys"),
}
_WARM = {
    "bfs": (dict(max_iters=16), torch.int32),
    "pagerank": (dict(iters=8, damping=0.85, tol=1e-6), torch.float32),
    "wcc": (dict(max_iters=16), torch.int64),
    "sssp": (dict(max_iters=16), torch.float32),
}


def _mode_analytics(args, n: int) -> dict:
    store = _compute_store(args, n)
    src, dst, _sk, _dk, w, _mask = _ops(store, 1)
    store.apply(OpBatch.edges(src, dst, w[0].cpu().numpy()))
    state = store._synced(store.state)
    key = store._keys(np.asarray([src[0]], np.uint64))[0]
    keys = store._keys(np.asarray(src[:16], np.uint64))
    recs = {}
    for alg in args.algs.split(","):
        static, dyn = _CATALOG[alg]
        extra = {"key": (key,), "keys": (keys,), None: ()}[dyn]
        prog = store.analytics_program(alg, **static)
        recs[alg], vals = _counted(args, n, state, extra,
                                   lambda: prog(state, *extra))
        if not args.incremental or alg not in _WARM:
            continue
        wstatic, vdt = _WARM[alg]
        # seeded from the scratch run's per-row values
        prev = (vals[0] if isinstance(vals, tuple) else vals).to(vdt)
        wprog = store.warm_program(alg, **wstatic)
        recs[alg + "__advance"], _ = _counted(
            args, n, state, extra + (prev,),
            lambda: wprog(state, *extra, prev))
    fb = args.frontier_budget
    tag = ("" if fb is None else f"__frontier{fb}") + \
        ("__incremental" if args.incremental else "")
    rec = {
        "arch": "radixgraph-analytics", "shape": f"mcap{store.m_cap}",
        "mesh": f"graph{n}" + ("" if fb is None else f"+frontier{fb}"),
        "chips": n, "m_cap": store.m_cap,
        "n_cap": store.state.vt.del_time.shape[1], "frontier_budget": fb,
        "status": "ok", "kind": "graph", "algs": recs,
        "collective_branch_rule": costs.BRANCH_RULE,
        "device": _device_name(args.device),
    }
    _record(f"torch-radixgraph-analytics__{n}shards{tag}.json", rec)
    for a, r in recs.items():
        print(f"[OK] graph-{a} x {n} shards: {r['run_s']:.3f}s, a2a "
              f"{r['collective_elements']['all-to-all']:.0f} "
              f"elements/shard "
              f"({sum(r['collective_counts'].values()):.0f} collectives), "
              f"launches {r['launch_counts']}")
    return rec


def _snapshot_leaves(store):
    return [t.cpu().numpy() for t in store.read(ReadOp("snapshot"))]


def _mode_persist(args, n: int) -> dict:
    from ..storage import DurableStore, recover
    ids, src, dst, w = _stream()
    B = 512 * n

    # WAL-off reference load of the same stream (the durability tax's
    # denominator at this scale)
    t0 = time.perf_counter()
    ref = _graph_store(n, args.device)
    for lo in range(0, N_OPS, B):
        ref.apply(OpBatch.edges(src[lo:lo + B], dst[lo:lo + B],
                                w[lo:lo + B]))
    bulk_s = time.perf_counter() - t0
    live_edges = ref.read(ReadOp("num_edges"))
    del ref

    workdir = tempfile.mkdtemp(prefix="dryrun_persist_")
    try:
        store = DurableStore(_graph_store(n, args.device), workdir,
                             group_commit=32, checkpoint_every=3)
        t0 = time.perf_counter()
        for lo in range(0, N_OPS, B):
            store.apply(OpBatch.edges(src[lo:lo + B], dst[lo:lo + B],
                                      w[lo:lo + B]))
        store.sync()          # durable-ack boundary, in the timed region
        dt = time.perf_counter() - t0
        stats = dict(store.stats)
        live = _snapshot_leaves(store)
        store.close()
        del store

        t0 = time.perf_counter()
        rec_store, report = recover(
            workdir, lambda: _graph_store(n, args.device))
        recover_s = time.perf_counter() - t0
        bit_exact = (rec_store.read(ReadOp("num_edges")) == live_edges and
                     all(np.array_equal(a, b) for a, b in
                         zip(live, _snapshot_leaves(rec_store))))
        rec_store.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    rec = {
        "arch": "radixgraph-persist", "shape": f"ops{N_OPS}",
        "mesh": f"graph{n}", "chips": n, "status": "ok", "kind": "graph",
        "write_ops_per_s": round(N_OPS / dt, 1),
        "checkpoints_written": stats["checkpoints"],
        "last_checkpoint_kind": stats["last_checkpoint_kind"],
        "checkpoint_bytes": stats["checkpoint_bytes"],
        "wal_records": stats["wal_records"],
        "wal_bytes": stats["wal_bytes"],
        "recover_s": round(recover_s, 2),
        "recovered_checkpoint_kind": report["checkpoint_kind"],
        "replayed_records": report["replayed"],
        "recovery_bit_exact": bool(bit_exact),
        "bulk_load_s": round(bulk_s, 2),
        "bulk_edges_live": int(live_edges),
        "durable_vs_bulk": round(bulk_s / dt, 2),
        "device": _device_name(args.device),
    }
    _record(f"torch-radixgraph-persist__{n}shards.json", rec)
    print(f"[OK] graph-persist x {n} shards: {rec['write_ops_per_s']:.0f} "
          f"write ops/s ({rec['durable_vs_bulk']:.2f}x of WAL-off), "
          f"{rec['checkpoints_written']} ckpts "
          f"(last {rec['last_checkpoint_kind']}, "
          f"{rec['checkpoint_bytes']} B), recover {rec['recover_s']}s "
          f"({rec['recovered_checkpoint_kind']} + "
          f"{rec['replayed_records']} replayed), "
          f"bit_exact={rec['recovery_bit_exact']}")
    if not bit_exact:
        raise AssertionError(
            "persist dryrun: recovery diverged from live state")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=256)
    ap.add_argument("--mode",
                    choices=("ingest", "analytics", "serve", "persist"),
                    default="ingest")
    ap.add_argument("--device", default="cuda",
                    help="device holding every shard (default: the card; "
                         "'cpu' to run without one)")
    ap.add_argument("--batch-per-shard", type=int, default=4096)
    ap.add_argument("--n-per-shard", type=int, default=1 << 17)
    ap.add_argument("--no-pack", action="store_true")
    ap.add_argument("--route-budget", type=int, default=None,
                    help="compacted op-router budget (ingest mode)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="ingest mode: K batches through the pipelined "
                         "entry (make_apply_edges_pipelined)")
    ap.add_argument("--frontier-budget", type=int, default=None,
                    help="compacted frontier/inflow exchange budget "
                         "(analytics mode)")
    ap.add_argument("--algs", default="bfs,pagerank",
                    help="analytics mode: comma list from the registry "
                         "(bfs,pagerank,wcc,sssp,bc)")
    ap.add_argument("--incremental", action="store_true",
                    help="analytics mode: also run each algorithm's "
                         "warm-advance program, recorded as "
                         "<alg>__advance")
    args = ap.parse_args(argv)
    mode = {"ingest": _mode_ingest, "analytics": _mode_analytics,
            "serve": _mode_serve, "persist": _mode_persist}[args.mode]
    return mode(args, args.shards)


if __name__ == "__main__":
    main()
