"""Fused edge-pool append: slot scatter + pre-append pair-liveness probe.

``append_edges`` is the wrapper: on CUDA tensors it launches the kernel of
``csrc/append.cu`` (port of the TPU kernel ``append_pallas``) or raises; on
CPU tensors it runs ``append_edges_plain``, the plain PyTorch version of
the same function. Both update the three pool tensors IN PLACE and return
``was_live``.

Semantics (``repro.kernels.ref.append_ref``): per op j, when ``wval[j]``
write (wd, ww, wts)[j] at pool[wblk[j], wlane[j]] (JAX's drop mode: a
negative index counts from the end, one outside [-n, n) drops the op);
per probe q, scan the owner extent (flat entries ``pstart[q]*BS + e`` for
``e < psize[q]``) for destination ``pv[q]`` and report whether the
highest-timestamp match carries a non-NULL weight, before any append
lands. ``pv < 0`` or ``pstart < 0`` disables a probe.
"""
from __future__ import annotations

import ctypes
import time

import torch

from ..core.tensor_ops import scatter_set_
from . import _build

__all__ = ["append_edges", "append_edges_plain", "append_tile_rows"]

_I32, _F32, _BOOL = (torch.int32,), (torch.float32,), (torch.bool,)


def append_tile_rows(nb: int, tile: int = 128) -> int:
    """Pool block rows per tile of the TPU append kernel's grid. The port's
    kernel needs no tiles, but ``tiles_scanned`` — compared state — counts
    touched tiles of this height, exactly as the JAX package does."""
    tile = min(tile, nb)
    while nb % tile:
        tile //= 2
    return tile


def append_edges_plain(dst, w, ts, wblk, wlane, wval, wd, ww, wts,
                       pstart, psize, pv):
    """Plain PyTorch version. Gathers each probe's extent up to the
    largest ``psize`` — a (B, max psize) slab, never ``append_ref``'s dense
    (B, NB*BS) match matrix."""
    NB, BS = dst.shape
    N = NB * BS
    P = pstart.shape[0]
    dev = dst.device
    maxp = int(psize.max().clamp_min(0)) if P else 0
    if maxp == 0:
        was_live = torch.zeros((P,), dtype=torch.bool, device=dev)
    else:
        e = torch.arange(maxp, dtype=torch.int64, device=dev)[None, :]
        flat = pstart.to(torch.int64)[:, None] * BS + e
        belongs = ((pstart >= 0) & (pv >= 0))[:, None] & \
            (e < psize.to(torch.int64)[:, None]) & (flat < N)
        fc = flat.clamp(0, N - 1)
        match = belongs & (dst.reshape(-1)[fc] == pv[:, None])
        tm = torch.where(match, ts.reshape(-1)[fc], 0)
        best = torch.argmax(tm, dim=1)          # first maximum, as argmax
        best_t = tm.gather(1, best[:, None])[:, 0]
        best_flat = fc.gather(1, best[:, None])[:, 0]
        was_live = (best_t > 0) & (w.reshape(-1)[best_flat] != 0)
    # JAX's ``.at[].set(mode="drop")``: a negative index counts from the
    # end; one outside [-n, n) is dropped
    b, ln = wblk.to(torch.int64), wlane.to(torch.int64)
    ok = wval & (b >= -NB) & (b < NB) & (ln >= -BS) & (ln < BS)
    flat_w = torch.where(b < 0, b + NB, b) * BS + torch.where(ln < 0, ln + BS,
                                                              ln)
    for pool, val in ((dst, wd), (w, ww), (ts, wts)):
        scatter_set_(pool.view(-1), flat_w, val, ok)
    return was_live


def _lib():
    fn = _build.load("append").append_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, p, p, p, p, p, p, i, p, p, p, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def append_edges(dst, w, ts, wblk, wlane, wval, wd, ww, wts,
                 pstart, psize, pv):
    """Kernel wrapper: CUDA kernel on CUDA tensors, plain version on CPU
    tensors. Updates the pools in place; returns ``was_live`` (P,) bool.

    The kernel runs probes and writes in one launch, in no order: every
    write slot must lie outside every probed extent, as the edge pool's
    slots (claimed at or after each owner's pre-batch size) do."""
    if not dst.is_cuda:
        return append_edges_plain(dst, w, ts, wblk, wlane, wval, wd, ww, wts,
                                  pstart, psize, pv)
    t0 = time.perf_counter_ns()
    dev = dst.device
    pool = dst.shape
    NB, BS = pool
    ops, probes = (wblk.shape[0],), (pstart.shape[0],)
    for t, dt, shape, nm in (
            (dst, _I32, pool, "dst"), (w, _F32, pool, "w"),
            (ts, _I32, pool, "ts"), (wblk, _I32, ops, "wblk"),
            (wlane, _I32, ops, "wlane"), (wval, _BOOL, ops, "wval"),
            (wd, _I32, ops, "wd"), (ww, _F32, ops, "ww"),
            (wts, _I32, ops, "wts"), (pstart, _I32, probes, "pstart"),
            (psize, _I32, probes, "psize"), (pv, _I32, probes, "pv")):
        _build.check_tensor(t, dt, shape, nm, dev, "append")
    if NB * BS >= 2 ** 62:
        raise ValueError("append: pool too large")
    was_live = torch.empty(probes, dtype=torch.bool, device=dev)
    if ops[0] == 0 and probes[0] == 0:
        return was_live
    _build.launch("append", _lib(), dev, (
        dst.data_ptr(), w.data_ptr(), ts.data_ptr(), NB, BS,
        wblk.data_ptr(), wlane.data_ptr(), wval.data_ptr(), wd.data_ptr(),
        ww.data_ptr(), wts.data_ptr(), ops[0], pstart.data_ptr(),
        psize.data_ptr(), pv.data_ptr(), probes[0], was_live.data_ptr()), t0)
    return was_live
