"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes. Builds happen at
first use, from the sources in this package only, into
``<repo>/build/repro_torch/`` (listed in ``.gitignore``); the library
name carries a hash of its source, so an edited source rebuilds.
``build()`` starts one ``nvcc`` per source, all at once.

``LAUNCHES`` holds one plain launch counter per kernel wrapper: each
wrapper adds one for each kernel it launches (``launch``), and nowhere
else. ``CALLS`` counts the wrapper calls that launched (a wide
``defrag_rows`` call launches several kernels), and ``HOST_NS`` sums,
over the same calls, the wrapper's host time from its entry to the
return of the launch: checks, allocations and the ctypes call, not the
kernels' run on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time
from typing import Dict, Iterable, Optional

import torch

__all__ = ["SOURCES", "LAUNCHES", "CALLS", "HOST_NS", "build_dir", "build",
           "load", "check_rc", "check_tensor", "launch"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = {"append": "append.cu", "compact": "compact.cu",
           "sort_lookup": "sort_lookup.cu", "frontier": "frontier.cu",
           "art": "art.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"append": 0, "compact_rows": 0,
                            "defrag_rows": 0, "sort_lookup": 0,
                            "frontier_expand": 0, "art_insert": 0}
CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
HOST_NS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    """``<repo>/build/repro_torch`` for the repository's ``src`` layout."""
    return CSRC.parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _lib_path(name: str) -> pathlib.Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` process each, all started together. Returns the seconds
    each build took (0.0 when already built). Raises with ``nvcc``'s
    output when a build fails; the ``-Xptxas -v`` report of each build is
    kept beside its library as ``<name>.ptxas.txt``."""
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {n: 0.0 for n in names}
    for n in names:
        path = _lib_path(n)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path, time.perf_counter())
    errors = []
    for n, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        (out_dir / f"{n}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]} "
                          f"(rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def check_tensor(t, dtypes, shape: tuple, name: str, device, what: str):
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes`` with
    ``shape`` (a tuple or ``torch.Size``) on ``device`` — what a kernel's
    C entry point assumes."""
    if t.dtype not in dtypes or t.shape != shape or t.device != device or \
            not t.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous {dtypes} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}")


def check_rc(rc: int, what: str):
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def launch(what: str, fn, device, args, t0: int, count=1):
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream, raise when it reports a CUDA error, then count the launches
    (``count``: an int, or a ``ctypes.c_int`` the entry point set to the
    kernels it launched), the call, and the wrapper's host time since
    ``t0`` (its ``time.perf_counter_ns()`` at entry). The device is
    entered only when it is not current."""
    idx = device.index
    if idx == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    check_rc(rc, what)
    LAUNCHES[what] += count if isinstance(count, int) else count.value
    CALLS[what] += 1
    HOST_NS[what] += time.perf_counter_ns() - t0
