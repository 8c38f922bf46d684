"""Row compactors: log compaction (paper Alg. 2) and the defrag row pass.

``compact_rows`` and ``defrag_rows`` are the wrappers: on CUDA tensors
they launch the kernel of ``csrc/compact.cu`` (port of the TPU kernels
``compact_rows_pallas`` and ``defrag_rows_pallas``) or raise; on CPU
tensors they run ``compact_rows_plain`` / ``defrag_rows_plain``, plain
PyTorch versions of the same functions (translations of
``repro.kernels.ref.compact_rows_ref`` / ``defrag_rows_ref``).

Inputs are (K, D) rows — destination offsets (-1 empty), weights (0 =
NULL tombstone, float32 or bfloat16), timestamps — with ``size`` (K,)
the occupied prefix. An entry whose destination offset is 2^30 or more
counts as empty, as in the oracles.
"""
from __future__ import annotations

import ctypes
import time

import torch

from ..core.tensor_ops import I32, shift_next
from . import _build

__all__ = ["compact_rows", "compact_rows_plain", "defrag_rows",
           "defrag_rows_plain", "MAX_ROW_WIDTH"]

BIGD = 2 ** 30
# compact_rows rows up to 8192 wide take the kernel's hash-table path;
# wider ones, and defrag_rows, its sort path (12 bytes of shared memory per
# padded entry)
MAX_ROW_WIDTH = 16384


def _sorted_rows(dst, w, ts, size, read_ts=None):
    K, D = dst.shape
    pos = torch.arange(D, dtype=I32, device=dst.device).expand(K, D)
    valid = (pos < size[:, None]) & (dst >= 0)
    if read_ts is not None:
        valid = valid & (ts <= int(read_ts))
    dkey = torch.where(valid, dst, BIGD)
    order = torch.argsort(dkey, dim=-1, stable=True)   # (dst asc, pos asc)
    ds = dkey.gather(-1, order)
    ws = w.gather(-1, order)
    tss = ts.gather(-1, order)
    is_last = (ds != shift_next(ds, -2)) & (ds < BIGD)
    return order.to(I32), ds, ws, tss, is_last


def compact_rows_plain(dst, w, ts, size, read_ts=None):
    """Plain version: the highest occupied position per destination wins,
    tombstones drop, survivors front-packed by DESCENDING position.
    Returns (dst', w', ts', count)."""
    K, D = dst.shape
    ps, ds, ws, tss, is_last = _sorted_rows(dst, w, ts, size, read_ts)
    keep = is_last & (ws != 0)
    emit_key = torch.where(keep, D - ps, BIGD)
    o3 = torch.argsort(emit_key, dim=-1, stable=True)
    dso = torch.where(keep, ds, -1).gather(-1, o3)
    wso = torch.where(keep, ws, torch.zeros_like(ws)).gather(-1, o3)
    tso = torch.where(keep, tss, 0).gather(-1, o3)
    count = keep.to(I32).sum(-1, dtype=I32)
    return dso, wso, tso, count


def defrag_rows_plain(dst, w, ts, size, keep_all: bool = False):
    """Plain version: dedup as ``compact_rows_plain`` but survivors come out
    by destination ASCENDING; ``keep_all`` keeps every occupied entry by
    (dst, position). Returns (dst', w', ts', count, live)."""
    K, D = dst.shape
    _, ds, ws, tss, is_last = _sorted_rows(dst, w, ts, size)
    live = (is_last & (ws != 0)).to(I32).sum(-1, dtype=I32)
    keep = (ds < BIGD) if keep_all else (is_last & (ws != 0))
    kpos = torch.cumsum(keep.to(I32), -1, dtype=I32) - 1
    tgt = torch.where(keep, kpos, D).to(torch.int64)
    outs = []
    for src, fill in ((ds, -1), (ws, 0), (tss, 0)):
        o = torch.full((K, D + 1), fill, dtype=src.dtype, device=src.device)
        o.scatter_(-1, tgt, torch.where(keep, src, torch.full_like(src,
                                                                   fill)))
        outs.append(o[:, :D].contiguous())
    count = keep.to(I32).sum(-1, dtype=I32)
    return outs[0], outs[1], outs[2], count, live


def _lib():
    fn = _build.load("compact").rows_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


_WDTYPE = {torch.float32: 0, torch.bfloat16: 1}
_WDTYPES = tuple(_WDTYPE)


def _launch(mode: int, dst, w, ts, size, read_ts, keep_all: bool):
    t0 = time.perf_counter_ns()
    name = "compact_rows" if mode == 0 else "defrag_rows"
    dev = dst.device
    if dst.dim() != 2:
        raise ValueError(f"{name}: rows must be 2-D, got {tuple(dst.shape)}")
    shape = dst.shape
    K, D = shape
    _build.check_tensor(dst, (I32,), shape, "dst", dev, name)
    _build.check_tensor(w, _WDTYPES, shape, "w", dev, name)
    _build.check_tensor(ts, (I32,), shape, "ts", dev, name)
    _build.check_tensor(size, (I32,), (K,), "size", dev, name)
    if D > MAX_ROW_WIDTH:
        raise ValueError(f"{name}: row width {D} > {MAX_ROW_WIDTH}")
    odst, ow, ots = (torch.empty_like(dst), torch.empty_like(w),
                     torch.empty_like(ts))
    ocnt = torch.empty_like(size)
    olive = torch.empty_like(size) if mode == 1 else None
    if K == 0 or D == 0:
        ocnt.zero_()
        return odst, ow, ots, ocnt, None if olive is None else olive.zero_()
    rt = 0 if read_ts is None else int(read_ts)
    _build.launch(name, _lib(), dev, (
        mode, _WDTYPE[w.dtype], dst.data_ptr(), w.data_ptr(), ts.data_ptr(),
        size.data_ptr(), K, D, int(read_ts is not None), rt, int(keep_all),
        odst.data_ptr(), ow.data_ptr(), ots.data_ptr(), ocnt.data_ptr(),
        None if olive is None else olive.data_ptr()), t0)
    return odst, ow, ots, ocnt, olive


def compact_rows(dst, w, ts, size, read_ts=None):
    """Kernel wrapper: CUDA kernel on CUDA tensors, plain version on CPU
    tensors. ``read_ts`` (a host int) keeps only entries with ts <= it."""
    if not dst.is_cuda:
        return compact_rows_plain(dst, w, ts, size, read_ts)
    return _launch(0, dst, w, ts, size, read_ts, False)[:4]


def defrag_rows(dst, w, ts, size, keep_all: bool = False):
    """Kernel wrapper: CUDA kernel on CUDA tensors (``keep_all`` included),
    plain version on CPU tensors."""
    if not dst.is_cuda:
        return defrag_rows_plain(dst, w, ts, size, keep_all)
    return _launch(1, dst, w, ts, size, None, keep_all)
