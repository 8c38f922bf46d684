"""The yardstick of the kernels' rooflines: the chip's peaks, and what a
kernel call needs from its inputs, whatever implements it.

``probe_work`` and ``row_work`` are frozen copies of ``chip_smoke.py``'s
functions of the same names; ``append_bound`` and ``compact_rows_bound``
are the byte and operation counts ``chip_smoke.append_case`` and
``chip_smoke.compact_case`` derived from them. Each takes a kernel
wrapper's arguments before the call (``append_edges`` updates the pool in
place) and returns the call's least time on the chip in seconds.
"""
from __future__ import annotations

import torch

__all__ = ["PEAKS", "probe_work", "row_work", "append_bound",
           "compact_rows_bound"]

# one NVIDIA H100 SXM, NVIDIA's data sheet (dense rates, 700 W)
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}


def probe_work(dst, pstart, psize, pv):
    """What the append probes of this data read: the entries probed (each
    enabled probe's extent, inside the pool), those matching their probe's
    destination, and the probes with a match (a winner each)."""
    flat_dst = dst.reshape(-1)
    on = torch.nonzero((pstart >= 0) & (pv >= 0) & (psize > 0)).flatten()
    reps = psize[on].long()
    q = torch.repeat_interleave(on, reps)
    first = torch.repeat_interleave(torch.cumsum(reps, 0) - reps, reps)
    e = torch.arange(q.numel(), device=dst.device) - first
    flat = pstart[q].long() * dst.shape[1] + e
    inside = flat < flat_dst.numel()
    hit = inside & (flat_dst[flat.clamp(max=flat_dst.numel() - 1)] == pv[q])
    return (int(inside.sum()), int(hit.sum()),
            int(torch.unique(q[hit]).numel()))


def row_work(dst, size, w):
    """What a row compactor needs of these rows: the occupied entries
    (positions below size, up to the width), the last writers (one per
    distinct valid dst of a row) and the survivors (last writers with a
    non-zero weight); also the most entries one dst holds in one row (the
    hash path's contention)."""
    K, D = dst.shape
    pos = torch.arange(D, device=dst.device)
    occ = pos[None, :] < size.clamp(0, D)[:, None]
    valid = occ & (dst >= 0) & (dst < 2 ** 30)
    key = torch.arange(K, device=dst.device)[:, None] * 2 ** 30 + dst
    key = torch.where(valid, key, -1)
    # the last writer of a (row, dst) is its highest valid position
    flat, fpos = key.reshape(-1), pos.expand(K, D).reshape(-1)
    uk, inv, reps = torch.unique(flat, return_inverse=True,
                                 return_counts=True)
    top = torch.full((uk.numel(),), -1, dtype=torch.long,
                     device=dst.device)
    top.scatter_reduce_(0, inv, fpos, "amax")
    is_last = valid.reshape(-1) & (fpos == top[inv])
    alive = is_last & (w.reshape(-1) != 0)
    most = int(reps[uk >= 0].max()) if bool((uk >= 0).any()) else 0
    return int(occ.sum()), int(is_last.sum()), int(alive.sum()), most


def _bound(nbytes: int, nops: int) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               nops / PEAKS["f32_ops_per_s"])


def append_bound(dst, w, ts, wblk, wlane, wval, wd, ww, wts, pstart, psize,
                 pv, **_):
    """``append_edges``: the dst of every probed entry, the ts of each
    match, the weight of each probe's winner; pstart, psize, pv and the
    was_live byte per probe; wval per op, (wblk, wlane) per valid op, and
    (wd, ww, wts) read and written per landed op."""
    probed, matches, winners = probe_work(dst, pstart, psize, pv)
    P = int(pstart.shape[0])
    valid = int(wval.sum())
    landed = int((wval & (wblk >= 0) & (wblk < dst.shape[0])).sum())
    nbytes = 4 * (probed + matches + winners) + 13 * P + \
        int(wval.shape[0]) + 8 * valid + 24 * landed
    return _bound(nbytes, probed)


def compact_rows_bound(dst, w, ts, size, read_ts=None, **_):
    """``compact_rows``: the dst of every occupied entry, the weight of
    each dst's last writer, the ts of each survivor, size; the (dst, w,
    ts) output rows in full and count. One table insert per occupied
    entry."""
    occupied, last, kept, _most = row_work(dst, size, w)
    K = int(dst.shape[0])
    nbytes = 4 * occupied + w.element_size() * last + 4 * kept + 4 * K + \
        dst.numel() * (8 + w.element_size()) + 4 * K
    return _bound(nbytes, occupied)
