"""Training entry point of the port (counterpart of ``repro.launch.train``,
the same flags and loop plus ``--device``).

  python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \\
      --steps 20 [--batch 8 --seq 128 --accum 1] [--ckpt-dir DIR] \\
      [--data synthetic|graph] [--device cuda]

Random weights from seed 0; AdamW (Adafactor for a full-size ``moe``
config) on a cosine schedule; micro-batch accumulation; checkpoint and
restart (atomic, async, a SIGTERM hook) with the data stream's state in
the metadata, so a resumed run replays the same batches; a straggler
watchdog; ``--data graph`` trains on random walks over a live
``RadixGraph`` on the same device (its ingest runs the graph kernels).
The default device is the card; without one the run raises (pass
``--device cpu`` to train on the CPU). ``--production-mesh`` (256 chips)
exits with a message: the port trains on one card.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import Checkpointer, latest_step, restore_checkpoint, \
    save_checkpoint
from ..configs import get_arch
from ..data import GraphWalkStream, Prefetcher, TokenStream, shard_batch
from ..dist.sharding import TRAIN_RULES, set_rules
from ..launch.mesh import make_local_mesh
from ..models.api import build_model
from ..train import adafactor, adamw, cosine_schedule, init_train_state, \
    make_train_step


def graph_corpus(device):
    """The launcher's graph: 2,048 random IDs of 2^31, 16,384 undirected
    edges between them, in a ``RadixGraph`` of 4,096 vertex rows on
    ``device`` (the JAX launcher's, draw for draw)."""
    from ..core.radixgraph import RadixGraph
    g = RadixGraph(n_max=4096, expected_n=2048, batch=1024,
                   pool_blocks=8192, undirected=True, device=device)
    rng = np.random.default_rng(0)
    ids = rng.choice(2**31, 2048, replace=False).astype(np.uint64)
    g.add_edges(rng.choice(ids, 16384), rng.choice(ids, 16384))
    return g


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule-total", type=int, default=None,
                    help="cosine schedule horizon (default: --steps)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", choices=("synthetic", "graph"),
                    default="synthetic")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--step-timeout", type=float, default=300.0,
                    help="straggler watchdog: warn if a step exceeds this")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: the card; 'cpu' to "
                         "run without one)")
    args = ap.parse_args(argv)
    if args.production_mesh:
        sys.exit("launch.train --production-mesh needs the 256-chip mesh of "
                 "the JAX package; the port trains on one card. Run without "
                 "--production-mesh.")

    device = resolve_device(args.device)
    mod = get_arch(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    model = build_model(cfg)
    mesh = make_local_mesh(device=device)

    horizon = args.schedule_total or max(args.steps, 21)
    opt = adamw(cosine_schedule(args.lr, 20, horizon))
    if cfg.family == "moe" and not args.smoke:
        opt = adafactor(cosine_schedule(args.lr, 20, horizon))
    train_step = make_train_step(model, opt, accum=args.accum)

    with set_rules(TRAIN_RULES, mesh):
        state = init_train_state(model, opt, 0, device)

        # ---- data ----
        if args.data == "graph":
            stream = GraphWalkStream(graph_corpus(device), cfg.vocab,
                                     args.batch, args.seq)
        else:
            stream = TokenStream(cfg.vocab, args.batch, args.seq)

        # ---- restore ----
        start = 0
        ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
        if ckpt and latest_step(args.ckpt_dir) is not None:
            state, start, meta = restore_checkpoint(args.ckpt_dir, state)
            stream.restore(meta["stream"])
            print(f"[train] restored step {start}")
        if ckpt:
            ckpt.install_sigterm_hook(lambda: (state, int(state.step)))

        if start >= args.steps:
            print(f"[train] checkpoint step {start} >= --steps {args.steps}; "
                  "nothing to do")
            return []
        it = Prefetcher(stream, depth=2)
        losses = []
        for i in range(start, args.steps):
            batch = next(it)
            if args.accum > 1:
                batch = {k: v.reshape((args.accum, v.shape[0] // args.accum)
                                      + v.shape[1:])
                         for k, v in batch.items()}
            batch = shard_batch(batch, mesh)
            t0 = time.time()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if dt > args.step_timeout:
                print(f"[watchdog] step {i} took {dt:.1f}s "
                      f"(> {args.step_timeout}s) — straggler suspected")
            losses.append(loss)
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            if ckpt and (i + 1) % args.ckpt_every == 0:
                ckpt.save_async(state, i + 1,
                                {"stream": stream.state_for(i + 1)})
        if ckpt:
            ckpt.wait()
            save_checkpoint(args.ckpt_dir, state, args.steps,
                            {"stream": stream.state_for(args.steps)})
        it.close()
        print(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        return losses


if __name__ == "__main__":
    main()
