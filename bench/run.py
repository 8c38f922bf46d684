"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root. The last line of standard output is the result
object; the last lines of standard error are the numbers compared with
the reference, each beside its limit. Exits non-zero, with no result,
without enough CUDA devices, or when JAX or the JAX package was loaded.
``--control`` puts the reference, at bfloat16 weights, in the program's
place: its runs must come out not correct.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def say(msg: str):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    # the build of the program's kernels (build/repro_torch) and any
    # Triton cache stay inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    import torch
    from bench.spec import load_cell
    cell = load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"torch sees {have}")
        return 3
    from bench.cell import run
    out = run(cell, args.seed, args.seconds, bool(args.trace),
              control=args.control, t_start=T_START, log=say)
    rec = out.pop("rec")
    say(json.dumps({"window": {k: v for k, v in rec["window"].items()
                               if k != "flush_s"},
                    "cycles": rec["cycles"], "check_s": rec["check_s"],
                    "counters": rec["counters"]}))
    bad = forbidden_modules()
    if bad:
        say(f"loaded in this process: {bad}; the benchmark may load none of "
            f"{list(FORBIDDEN)}")
        return 4
    for name, c in out["checks"].items():
        say(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if forbidden_modules() and not os.environ.get("REPRO_NO_JAX_SHIM"):
        # a site hook of the repository loaded JAX at start-up: start again
        # without it
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "REPRO_NO_JAX_SHIM": "1"})
    # the script's own folder is not a package root: put the checkout's
    # root and its ``src`` there instead
    sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]
    sys.exit(main())
