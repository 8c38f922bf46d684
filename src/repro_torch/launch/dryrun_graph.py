"""The sharded store's run modes at pod scale (port of the ``serve`` and
``persist`` modes of ``repro.launch.dryrun_graph``), through the
``repro_torch.api.GraphStore`` front door, every shard on one device:

* ``--mode serve``: RUNS a small mixed read/write workload through
  ``serve.graph_service`` and records write ops/s and reads/s;
* ``--mode persist``: RUNS a durable ingest (WAL + epoch checkpoints via
  ``repro_torch.storage``) on a sharded store, drops the store object,
  recovers from disk, and records throughput, checkpoint / WAL footprint,
  recovery time and bit-exactness (asserted).

The JAX package's ``ingest`` and ``analytics`` modes lower XLA HLO on
placeholder devices for a cost model; they have no counterpart here yet
and exit with a message instead of a record.

  python -m repro_torch.launch.dryrun_graph --mode serve|persist
      [--shards 256] [--device cuda]

Records go to ``benchmarks/results/dryrun/torch-radixgraph-<mode>__<n>shards
.json`` with the JAX records' keys, plus the device they ran on.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..api import OpBatch, ReadOp, make_store

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
    args = ap.parse_args(argv)
    if args.mode in ("ingest", "analytics"):
        sys.exit(f"dryrun_graph --mode {args.mode} lowers XLA HLO for a "
                 "cost model in the JAX package; its port is queued "
                 "(ROADMAP Queue 1, item 3). Run --mode serve or persist.")
    mode = _mode_serve if args.mode == "serve" else _mode_persist
    return mode(args, args.shards)


if __name__ == "__main__":
    main()
