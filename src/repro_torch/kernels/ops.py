"""Dispatch to the port's kernels, and their launch counters.

``impl`` values keep the JAX package's names so one kwargs dict builds
both packages:

* ``'auto'`` / ``'pallas'`` — the fused kernel path: the wrapper, which
  launches the CUDA kernel on CUDA tensors (or raises) and runs the plain
  PyTorch version on CPU tensors. ``'pallas'`` names the TPU kernel the
  CUDA kernel replaces; no Pallas runs here.
* ``'ref'`` — the plain PyTorch version on any device. ``append_edges``
  takes ``'plain'`` instead: the edge pool's ``append_impl='ref'`` is the
  windowed-probe scatter path, which never calls this function.

There is no fallback: the device of the tensors picks the implementation,
and a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import Dict

from . import _build
from . import append as _append
from . import compact as _compact
from . import frontier as _frontier
from . import sort_lookup as _sort_lookup

__all__ = ["append_edges", "compact_rows", "defrag_rows", "sort_lookup",
           "frontier_expand", "append_tile_rows", "launch_counts",
           "call_counts", "host_ns", "reset_launch_counts"]

append_tile_rows = _append.append_tile_rows
_KERNEL = ("auto", "pallas")


def _use_kernel(impl: str, allowed=_KERNEL + ("ref",)) -> bool:
    if impl not in allowed:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of "
                         f"{allowed}")
    return impl in _KERNEL


def append_edges(dst, w, ts, wblk, wlane, wval, wd, ww, wts,
                 pstart, psize, pv, impl: str = "auto"):
    """Fused edge append (in place on the pools); returns ``was_live``."""
    fn = (_append.append_edges
          if _use_kernel(impl, _KERNEL + ("plain",))
          else _append.append_edges_plain)
    return fn(dst, w, ts, wblk, wlane, wval, wd, ww, wts, pstart, psize, pv)


def compact_rows(dst, w, ts, size, read_ts=None, impl: str = "auto"):
    """Batched log compaction (paper Alg. 2): (dst', w', ts', count)."""
    fn = _compact.compact_rows if _use_kernel(impl) \
        else _compact.compact_rows_plain
    return fn(dst, w, ts, size, read_ts)


def defrag_rows(dst, w, ts, size, keep_all: bool = False,
                impl: str = "auto"):
    """Defrag row compactor: (dst', w', ts', count, live)."""
    fn = _compact.defrag_rows if _use_kernel(impl) \
        else _compact.defrag_rows_plain
    return fn(dst, w, ts, size, keep_all)


def sort_lookup(pools, keys, *, fanout_bits, bit_offsets,
                impl: str = "auto"):
    """SORT descent: (B, 2) keys -> int32 offsets (-1 absent)."""
    fn = _sort_lookup.sort_lookup if _use_kernel(impl) \
        else _sort_lookup.sort_lookup_plain
    return fn(pools, keys, fanout_bits=fanout_bits, bit_offsets=bit_offsets)


def frontier_expand(owner, dst, valid, frontier_bits, visited_bits,
                    impl: str = "auto"):
    """One BFS level on int32 bitmap words: next-frontier minus visited."""
    fn = _frontier.frontier_expand if _use_kernel(impl) \
        else _frontier.frontier_expand_plain
    return fn(owner, dst, valid, frontier_bits, visited_bits)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_build.LAUNCHES)


def call_counts() -> Dict[str, int]:
    """Wrapper calls that launched, per wrapper, since the last reset."""
    return dict(_build.CALLS)


def host_ns() -> Dict[str, int]:
    """Host nanoseconds per wrapper, summed over its calls since the last
    reset (checks, allocations and the ctypes call)."""
    return dict(_build.HOST_NS)


def reset_launch_counts():
    """Zero the launch and call counts and their host time."""
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
        _build.CALLS[k] = 0
        _build.HOST_NS[k] = 0
