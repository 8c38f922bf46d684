"""Serving entry point of the port: batched requests through the
continuous-batching engine with the RadixKV (snapshot-log) block manager
(counterpart of ``repro.launch.serve``, the same flags plus ``--device``).

  python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke \\
      --requests 16 --max-new 12 [--device cuda]

The default device is the card; without one the run raises (pass
``--device cpu`` to serve on the CPU). Weights are random, from seed 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_arch
from ..models.api import build_model
from ..serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--smax", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mod = get_arch(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    model = build_model(cfg)
    params = model.init(0, device=device)
    eng = ServeEngine(model, params, slots=args.slots, smax=args.smax)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 17)).astype(np.int32)
               for _ in range(args.requests)]
    t0 = time.time()
    results = eng.run(prompts, max_new=args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    tokens = sum(len(v) for v in results.values())
    print(f"[serve] {len(results)}/{args.requests} requests, {tokens} tokens "
          f"in {dt:.2f}s ({tokens/dt:.1f} tok/s); kv defrags: "
          f"{eng.kv.defrags}, utilization: {eng.kv.utilization:.2f}")
    if len(results) != args.requests:
        raise RuntimeError(f"served {len(results)} of {args.requests} "
                           "requests")
    return results


if __name__ == "__main__":
    main()
