"""Paper Table 5 on the port: SORT vs ART — insert / query throughput and
memory across the (n, u) grid of ``benchmarks/table5_sort_vs_art.py``
(n = 1e4 and 5e4 times ``--scale``; 24- and 32-bit universes), through
``repro_torch.core.sort`` and ``repro_torch.baselines.TorchART`` on
``--device`` (default the card).

    PYTHONPATH=src python -m benchmarks.torch_table5_sort_vs_art \
        [--scale 1] [--device cuda] [--seed 0]

Each structure is built empty outside the timed region, then the n IDs
are inserted in one batch (SORT: ``insert_mappings``; ART: the
``art_insert`` kernel, keys in batch order) and 2n IDs (the n present,
n drawn from the universe) looked up. On the card every time is taken
between CUDA events after a synchronise (median of 3 runs, one warm-up
run first); on the CPU with the host clock. ``memory_kb`` is
the structures' own accounting: SORT's materialized slots x 4 B, ART's
C-equivalent node sizes (unodb Node16 / Node256). The rows are printed
as CSV and written, with the device's name, to
``benchmarks/results/torch_table5_sort_vs_art.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.baselines import TorchART  # noqa: E402
from repro_torch.core import sort as sort_mod  # noqa: E402
from repro_torch.core.keys import pack_keys  # noqa: E402
from repro_torch.core.sort import SortSpec  # noqa: E402
from repro_torch.core.sort_optimizer import optimize_sort  # noqa: E402

HEADER = ("table5", "n", "u_bits", "structure", "insert_ops_s",
          "query_ops_s", "memory_kb")
RESULT = ROOT / "benchmarks" / "results" / "torch_table5_sort_vs_art.json"
ITERS = 3


def timed(dev: torch.device, setup, fn) -> float:
    """Median seconds of ``fn(setup())`` (one warm-up first): CUDA events
    around the call on the card, the host clock on the CPU; ``setup``
    runs outside the timed region."""
    out = []
    for r in range(ITERS + 1):
        arg = setup()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(arg)
            t1.record()
            torch.cuda.synchronize(dev)
            dt = t0.elapsed_time(t1) / 1e3
        else:
            t = time.perf_counter()
            fn(arg)
            dt = time.perf_counter() - t
        if r:
            out.append(dt)
    return float(np.median(out))


def sort_row(n, xb, ids, qs, dev):
    """SORT's (insert_ops_s, query_ops_s, memory_kb) on ``ids``."""
    spec = SortSpec.from_config(optimize_sort(n, xb, 5), n + 8)
    keys = pack_keys(ids, xb, dev)
    qkeys = pack_keys(qs, xb, dev)
    offs = torch.arange(n, dtype=torch.int32, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    held = {}

    def insert(st):
        held["st"] = sort_mod.insert_mappings(spec, st, keys, offs, mask)
    t_i = timed(dev, lambda: sort_mod.make_sort(spec, dev), insert)
    st = held["st"]
    t_q = timed(dev, lambda: None,
                lambda _: sort_mod.lookup(spec, st, qkeys))
    slots = int(sort_mod.materialized_slots(spec, st))
    return int(n / t_i), int(len(qs) / t_q), slots * 4 // 1024


def art_row(n, xb, ids, qs, dev):
    """ART's (insert_ops_s, query_ops_s, memory_kb) on ``ids``."""
    offs = np.arange(n, dtype=np.int32)
    held = {}

    def insert(art):
        art.insert(ids, offs)
        held["art"] = art
    t_i = timed(dev, lambda: TorchART(n_max=n + 8, key_bits=xb, device=dev),
                insert)
    art = held["art"]
    t_q = timed(dev, lambda: None, lambda _: art.lookup(qs))
    return int(n / t_i), int(len(qs) / t_q), art.memory_bytes() // 1024


def run(scale: float = 1.0, device="cuda", seed: int = 0):
    dev = resolve_device(device)
    rows = [HEADER]
    rng = np.random.default_rng(seed)
    for n in (int(1e4 * scale), int(5e4 * scale)):
        for xb in (24, 32):
            ids = rng.choice(2 ** xb, n, replace=False).astype(np.uint64)
            qs = np.concatenate([ids, rng.choice(2 ** xb, n).astype(
                np.uint64)])
            rows.append(("table5", n, xb, "sort",
                         *sort_row(n, xb, ids, qs, dev)))
            rows.append(("table5", n, xb, "art",
                         *art_row(n, xb, ids, qs, dev)))
    for r in rows:
        print(",".join(str(x) for x in r))
    RESULT.parent.mkdir(parents=True, exist_ok=True)
    RESULT.write_text(json.dumps(dict(
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        scale=scale, seed=seed, iters=ITERS, header=list(HEADER),
        rows=[list(r) for r in rows[1:]]), indent=1))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.scale, args.device, args.seed)


if __name__ == "__main__":
    main()
