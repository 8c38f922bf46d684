"""Crash-recovery smoke of the port: kill a real ingest subprocess,
recover, and check parity against an uninterrupted control run (port of
``repro.storage.crash_smoke``).

Protocol:

1. the parent builds a deterministic edge stream (seeded) and picks a
   kill batch;
2. a CHILD process ingests the stream through a ``DurableStore``
   (group-commit WAL + incremental checkpoints, one every third of the
   stream) on ``--device``
   and SIGKILLs itself right after applying the kill batch — unsynced
   group-commit tail and all, exactly like a power cut;
3. the parent recovers from the directory on the same device, derives
   how many batches survived (the recovery report's ``last_seq``),
   replays a control store to that same prefix, and compares signatures:
   every state leaf (``assert_states_equal``), every snapshot leaf and
   ``num_edges`` bit-exact, and a PageRank run — equal on the CPU, within
   ``PAGERANK_TOL`` on a card, where the float scatter-add of its
   iterations sums in no fixed order;
4. the parent then finishes the stream on the RECOVERED store and checks
   final parity with the full control run — restart + replay loses
   nothing but the unsynced tail.

    PYTHONPATH=src python -m repro_torch.storage.crash_smoke --device cpu
    PYTHONPATH=src python -m repro_torch.storage.crash_smoke --device cuda \\
        --scale lj --ops 262144 --batch 4096

``--scale small`` is the JAX package's smoke state; ``--scale lj`` the
LiveJournal-sized state of ``chip_smoke.py``'s main path. The device is
never swapped: ``--device cuda`` without a card raises. On a card the
kernels are built before the child starts, and the child loads those
builds. Exit code 0 = every check held; ``--json`` prints the summary
record.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Tuple

import numpy as np

CAPS = dict(n_max=4096, expected_n=2048, pool_blocks=8192, block_size=16,
            k_max=128, dmax=1024, batch=512)
# chip_smoke.py's main-path state: SNAP soc-LiveJournal1 (4,847,571
# vertices) in n_max = 2^23 rows and 2^23 pool blocks of 16 entries
LJ_CAPS = dict(n_max=2 ** 23, expected_n=4_847_571, key_bits=32,
               pool_blocks=2 ** 23, block_size=16)
SCALES = {"small": CAPS, "lj": LJ_CAPS}
PAGERANK_TOL = 1e-5
SRC = pathlib.Path(__file__).resolve().parents[2]


def assert_states_equal(a, b, where: str) -> int:
    """Raise unless the ``GraphState``s ``a`` and ``b`` are equal leaf for
    leaf, bit-exact, with one exception: the pool's entry arrays (``dst``,
    ``weight``, ``ts``) are held equal on the blocks some row owns
    (``owner >= 0``, itself compared exactly). A delta checkpoint stores
    the blocks of current extents and leaves a block vacated since its
    base with the base's bytes (the JAX package's block selection, kept
    for one format); no read, append or rebuild reads an unowned block,
    and the next rebuild rewrites it. Returns the unowned blocks that
    differ."""
    import torch
    from .checkpoint import _BIG, flatten_named
    own = a.pool.owner >= 0
    dead = torch.zeros_like(own)
    for (name, x), (_, y) in zip(flatten_named(a), flatten_named(b)):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{where}: state leaf {name}: {x.dtype} "
                                 f"{tuple(x.shape)} vs {y.dtype} "
                                 f"{tuple(y.shape)}")
        if name in _BIG:
            # one flag a block, on the shard axis too: (S, n_blocks)
            diff = (x != y).reshape(*own.shape, -1).any(-1)
            if bool((diff & own).any()):
                raise AssertionError(f"{where}: state leaf {name} differs "
                                     "in an owned block")
            dead |= diff
        elif not torch.equal(x, y):
            raise AssertionError(f"{where}: state leaf {name} differs")
    return int(dead.sum())


def _caps(args) -> dict:
    caps = dict(SCALES[args.scale], device=args.device)
    if args.scale == "lj":
        # the CSR pad of snapshots and PageRank: every edge of the stream
        caps["m_cap"] = 1 << max(10, (args.ops - 1).bit_length())
    return caps


def _stream(seed: int, n_ops: int, batch: int, n_max: int):
    """Deterministic mixed insert/delete batches (shared parent/child)."""
    from ..api import OpBatch
    rng = np.random.default_rng(seed)
    ids = rng.choice(2 ** 24, n_max // 2, replace=False).astype(np.uint64)
    out = []
    for lo in range(0, n_ops, batch):
        n = min(batch, n_ops - lo)
        w = rng.uniform(0.5, 2.0, n).astype(np.float32)
        w[rng.random(n) < 0.05] = 0.0        # tombstones ride along
        out.append(OpBatch.edges(rng.choice(ids, n), rng.choice(ids, n),
                                 w))
    return out


def _mk_store(args):
    from ..api import make_store
    return make_store("local", **_caps(args))


def _child(args) -> int:
    from . import DurableStore
    batches = _stream(args.seed, args.ops, args.batch,
                      SCALES[args.scale]["n_max"])
    store = DurableStore(_mk_store(args), args.dir,
                         group_commit=args.group_commit,
                         checkpoint_every=max(2, len(batches) // 3))
    for i, b in enumerate(batches):
        store.apply(b)
        if i == args.kill_batch:
            os.kill(os.getpid(), signal.SIGKILL)   # no flush, no goodbye
    return 0


def _snapshot_sig(store) -> dict:
    from ..api import AnalyticsOp, ReadOp
    snap = store.read(ReadOp("snapshot"))
    return dict(num_edges=store.read(ReadOp("num_edges")),
                state=store.graph.state,
                snapshot=list(zip(snap._fields, snap)),
                pagerank=store.analytics(AnalyticsOp("pagerank",
                                                     {"iters": 10})))


def _assert_sig_equal(a: dict, b: dict, where: str,
                      exact: bool) -> Tuple[float, int]:
    """Raise unless the signatures agree (see the module docstring);
    returns the largest PageRank difference and the unowned pool blocks
    that differ."""
    import torch
    if a["num_edges"] != b["num_edges"]:
        raise AssertionError(f"{where}: num_edges {a['num_edges']} != "
                             f"{b['num_edges']}")
    dead = assert_states_equal(a["state"], b["state"], where)
    for (name, x), (_, y) in zip(a["snapshot"], b["snapshot"]):
        if not torch.equal(x, y):
            raise AssertionError(f"{where}: snapshot leaf {name} differs")
    pa, pb = a["pagerank"], b["pagerank"]
    if pa.keys() != pb.keys():
        raise AssertionError(f"{where}: pagerank vertex sets differ")
    diff = max((abs(pa[k] - pb[k]) for k in pa), default=0.0)
    if (pa != pb) if exact else diff > PAGERANK_TOL:
        raise AssertionError(f"{where}: pagerank differs (max {diff})")
    return diff, dead


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ops", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--group-commit", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", choices=sorted(SCALES), default="small")
    ap.add_argument("--dir", default=None)
    ap.add_argument("--kill-batch", type=int, default=None)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--_child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    n_batches = (args.ops + args.batch - 1) // args.batch
    if args._child:
        return _child(args)

    from .. import resolve_device
    from . import recover
    device = resolve_device(args.device)      # raises without a card
    if device.type == "cuda":
        from ..kernels import _build
        _build.build()
    rng = np.random.default_rng(args.seed + 1000)
    kill = args.kill_batch if args.kill_batch is not None else int(
        rng.integers(n_batches // 4, max(n_batches // 4 + 1,
                                         3 * n_batches // 4)))
    own_dir = args.dir is None
    workdir = args.dir or tempfile.mkdtemp(prefix="crash_smoke_")
    pathlib.Path(workdir).mkdir(parents=True, exist_ok=True)
    try:
        rec = _run(args, kill, n_batches, workdir, recover)
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
    if args.json:
        print(json.dumps(rec, indent=1))
    else:
        print(f"[OK] crash smoke on {rec['device']}: killed at batch "
              f"{kill}/{n_batches}, {rec['survived_batches']} batches "
              f"durable (ckpt {rec['checkpoint']} {rec['checkpoint_kind']} "
              f"+ {rec['replayed']} WAL records replayed, "
              f"tail={rec['wal_tail']}), prefix and resumed-stream parity")
    return 0


def _run(args, kill: int, n_batches: int, workdir: str, recover) -> dict:
    cmd = [sys.executable, "-m", "repro_torch.storage.crash_smoke",
           "--_child", "--seed", str(args.seed), "--ops", str(args.ops),
           "--batch", str(args.batch),
           "--group-commit", str(args.group_commit),
           "--device", args.device, "--scale", args.scale,
           "--dir", workdir, "--kill-batch", str(kill)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=1200)
    child_s = time.perf_counter() - t0
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"child should die by SIGKILL, got "
                             f"rc={proc.returncode}\n{proc.stderr[-2000:]}")

    t0 = time.perf_counter()
    store, report = recover(workdir, lambda: _mk_store(args))
    recover_s = time.perf_counter() - t0
    batches = _stream(args.seed, args.ops, args.batch,
                      SCALES[args.scale]["n_max"])
    survived = report["last_seq"] + 1          # seqs are batch-aligned
    if not 0 <= survived <= kill + 1:
        raise AssertionError(f"survived {survived}, killed at {kill}")

    exact = store.graph.device.type == "cpu"
    ctrl = _mk_store(args)
    for b in batches[:survived]:
        ctrl.apply(b)
    d_prefix, dead = _assert_sig_equal(_snapshot_sig(ctrl),
                                       _snapshot_sig(store),
                                       "recovered prefix", exact)

    # restart semantics: finish the stream on the recovered store
    for b in batches[survived:]:
        store.apply(b)
    store.checkpoint()
    store.close()
    for b in batches[survived:]:
        ctrl.apply(b)
    d_final, dead_final = _assert_sig_equal(_snapshot_sig(ctrl),
                                            _snapshot_sig(store),
                                            "resumed stream", exact)
    return dict(status="ok", device=str(store.graph.device),
                scale=args.scale, seed=args.seed, ops=args.ops,
                batches=n_batches, kill_batch=kill,
                child_rc=proc.returncode, survived_batches=survived,
                lost_tail_batches=kill + 1 - survived,
                checkpoint=report["checkpoint"],
                checkpoint_kind=report["checkpoint_kind"],
                replayed=report["replayed"],
                wal_tail=str(report["wal_tail"]),
                pagerank_max_diff=max(d_prefix, d_final),
                pagerank_exact=exact, unowned_blocks_differing=[
                    dead, dead_final],
                child_s=child_s, recover_s=recover_s)


if __name__ == "__main__":
    sys.exit(main())
