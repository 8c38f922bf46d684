"""Row compactors: log compaction (paper Alg. 2) and the defrag row pass.

``compact_rows`` and ``defrag_rows`` are the wrappers: on CUDA tensors
they launch the kernels of ``csrc/compact.cu`` (port of the TPU kernels
``compact_rows_pallas`` and ``defrag_rows_pallas``) or raise; on CPU
tensors they run ``compact_rows_plain`` / ``defrag_rows_plain``, plain
PyTorch versions of the same functions (translations of
``repro.kernels.ref.compact_rows_ref`` / ``defrag_rows_ref``).

Inputs are (K, D) rows — destination offsets (-1 empty), weights (0 =
NULL tombstone, float32 or bfloat16), timestamps — with ``size`` (K,)
the occupied prefix. An entry whose destination offset is 2^30 or more
counts as empty, as in the oracles. ``compact_rows`` takes rows up to
``MAX_ROW_WIDTH`` wide, ``defrag_rows`` rows of any width.
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
# wider ones its sort path (12 bytes of shared memory per padded entry).
# defrag_rows takes rows of any width.
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


_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn(name: str, argtypes):
    fn = getattr(_build.load("compact"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _scratch_sizes():
    """The C function that sizes a ``defrag_rows`` launch's scratch (int64
    keys and int32 tile counts, none when the rows fit one block)."""
    fn = _build.load("compact").defrag_scratch
    if fn.argtypes is None:
        fn.argtypes = [_i, _i, ctypes.POINTER(_ll), ctypes.POINTER(_ll)]
        fn.restype = None
    return fn


_COMPACT_ARGS = [_i, _p, _p, _p, _p, _i, _i, _i, _i, _p, _p, _p, _p, _p]
_DEFRAG_ARGS = [_i, _p, _p, _p, _p, _i, _i, _i, _p, _p, _p, _p, _p, _p, _ll,
                _p, _ll, ctypes.POINTER(_i), _p]
_WDTYPE = {torch.float32: 0, torch.bfloat16: 1}
_WDTYPES = tuple(_WDTYPE)


def _check(name, dst, w, ts, size):
    if dst.dim() != 2:
        raise ValueError(f"{name}: rows must be 2-D, got {tuple(dst.shape)}")
    shape, dev = dst.shape, dst.device
    _build.check_tensor(dst, (I32,), shape, "dst", dev, name)
    _build.check_tensor(w, _WDTYPES, shape, "w", dev, name)
    _build.check_tensor(ts, (I32,), shape, "ts", dev, name)
    _build.check_tensor(size, (I32,), (shape[0],), "size", dev, name)
    return shape


def compact_rows(dst, w, ts, size, read_ts=None):
    """Kernel wrapper: CUDA kernel on CUDA tensors, plain version on CPU
    tensors. ``read_ts`` (a host int) keeps only entries with ts <= it."""
    if not dst.is_cuda:
        return compact_rows_plain(dst, w, ts, size, read_ts)
    t0 = time.perf_counter_ns()
    K, D = _check("compact_rows", dst, w, ts, size)
    if D > MAX_ROW_WIDTH:
        raise ValueError(f"compact_rows: row width {D} > {MAX_ROW_WIDTH}")
    odst, ow, ots = (torch.empty_like(dst), torch.empty_like(w),
                     torch.empty_like(ts))
    ocnt = torch.empty_like(size)
    if K == 0 or D == 0:
        return odst, ow, ots, ocnt.zero_()
    rt = 0 if read_ts is None else int(read_ts)
    _build.launch("compact_rows", _fn("compact_launch", _COMPACT_ARGS),
                  dst.device, (
                      _WDTYPE[w.dtype], dst.data_ptr(), w.data_ptr(),
                      ts.data_ptr(), size.data_ptr(), K, D,
                      int(read_ts is not None), rt, odst.data_ptr(),
                      ow.data_ptr(), ots.data_ptr(), ocnt.data_ptr()), t0)
    return odst, ow, ots, ocnt


def defrag_rows(dst, w, ts, size, keep_all: bool = False):
    """Kernel wrapper: CUDA kernels on CUDA tensors (any row width,
    ``keep_all`` included), plain version on CPU tensors. Rows wider than
    the kernel's in-block sort take scratch from ``torch.empty``; every
    kernel of a call counts as a launch."""
    if not dst.is_cuda:
        return defrag_rows_plain(dst, w, ts, size, keep_all)
    t0 = time.perf_counter_ns()
    K, D = _check("defrag_rows", dst, w, ts, size)
    dev = dst.device
    odst, ow, ots = (torch.empty_like(dst), torch.empty_like(w),
                     torch.empty_like(ts))
    ocnt, olive = torch.empty_like(size), torch.empty_like(size)
    if K == 0 or D == 0:
        return odst, ow, ots, ocnt.zero_(), olive.zero_()
    nk, nt = _ll(0), _ll(0)
    _scratch_sizes()(K, D, ctypes.byref(nk), ctypes.byref(nt))
    keys = torch.empty((nk.value,), dtype=torch.int64, device=dev) \
        if nk.value else None
    tiles = torch.empty((nt.value,), dtype=I32, device=dev) \
        if nt.value else None
    launches = _i(0)
    _build.launch("defrag_rows", _fn("defrag_launch", _DEFRAG_ARGS), dev, (
        _WDTYPE[w.dtype], dst.data_ptr(), w.data_ptr(), ts.data_ptr(),
        size.data_ptr(), K, D, int(keep_all), odst.data_ptr(), ow.data_ptr(),
        ots.data_ptr(), ocnt.data_ptr(), olive.data_ptr(),
        None if keys is None else keys.data_ptr(), nk.value,
        None if tiles is None else tiles.data_ptr(), nt.value,
        ctypes.byref(launches)), t0, count=launches)
    return odst, ow, ots, ocnt, olive
