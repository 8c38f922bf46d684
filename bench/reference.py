"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch (and NumPy); imports nothing of the program. From the ops
that the benchmark generated (the same arrays the store was given) it
works out what a store holding them must answer: which vertex IDs
resolve, how many vertices and live edges there are, and every live
(src, dst) pair with its weight, last writer winning and tombstones
deleting. It runs on the card once the store is freed (on the CPU in the
tests). ``compare`` holds the store's answers to that; every number it
returns is an exact count, so each limit is 0.

Pair keys are ``src_id << 32 | dst_id`` held in int64 (the bit pattern of
the unsigned key); both sides sort them the same way.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["oracle", "Answers", "pair_keys", "touched", "expected",
           "compare", "LIMITS", "PRECISIONS"]

# the configuration's weights are float32; the control keeps them one
# precision step below
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def oracle(n_vertices, si, di, w):
    """Last writer wins per (src, dst); tombstones (w == 0) delete.
    Returns the live pairs (src idx, dst idx, weight).
    Frozen copy of ``chip_smoke.oracle`` (NumPy), kept only as the
    yardstick that the tests hold ``expected`` to. A run uses
    ``expected``, the same semantics in PyTorch on the card: this NumPy
    copy took tens of seconds at a cycle's size on the host."""
    key = si.astype(np.int64) * n_vertices + di.astype(np.int64)
    rev = key[::-1]
    uk, first_rev = np.unique(rev, return_index=True)
    last = len(key) - 1 - first_rev
    lw = w[last]
    live = lw != 0
    return si[last][live], di[last][live], lw[live]


@dataclass
class Answers:
    """What a store answers, in one form: ``found`` per queried vertex ID,
    the two counts, and the live pairs as int64 pair keys with their
    float32 weights (tensors, in any order)."""

    found: torch.Tensor
    num_vertices: int
    num_edges: int
    pair_keys: torch.Tensor
    weights: torch.Tensor


def pair_keys(src_ids: torch.Tensor, dst_ids: torch.Tensor) -> torch.Tensor:
    """int64 ``src << 32 | dst`` of IDs below 2^32."""
    return (src_ids.to(torch.int64) << 32) | dst_ids.to(torch.int64)


def touched(n_vertices: int, si: np.ndarray, di: np.ndarray) -> np.ndarray:
    """The vertex indices the ops name, ascending."""
    return np.flatnonzero(np.bincount(np.concatenate([si, di]),
                                      minlength=n_vertices))


def expected(ids, si, di, w, precision: str = "float32",
             device="cpu") -> Answers:
    """The reference's answers after the ops (si, di, w) over vertex IDs
    ``ids`` (NumPy arrays), computed on ``device``; ``precision`` other
    than the configuration's float32 is the control's."""
    dev = torch.device(device)
    n = len(ids)
    s = torch.from_numpy(np.asarray(si)).to(dev, torch.int64)
    d = torch.from_numpy(np.asarray(di)).to(dev, torch.int64)
    wt = torch.from_numpy(np.asarray(w, np.float32)).to(dev)
    key, order = torch.sort(s * n + d, stable=True)
    last = torch.ones_like(key, dtype=torch.bool)
    last[:-1] = key[1:] != key[:-1]          # the last op of each pair
    op = order[last]
    lw = wt[op].to(PRECISIONS[precision]).to(torch.float32)
    live = lw != 0
    vid = torch.from_numpy(np.asarray(ids, np.uint64).view(np.int64)).to(dev)
    keys = pair_keys(vid[s[op][live]], vid[d[op][live]])
    nv = int(touched(n, np.asarray(si), np.asarray(di)).size)
    return Answers(torch.ones(nv, dtype=torch.bool, device=dev), nv,
                   int(keys.numel()), keys, lw[live])


# every number compared, with its limit: all are exact counts
LIMITS = {"dropped_ops": 0, "ids_unresolved": 0, "vertices_off": 0,
          "edges_off": 0, "pairs_missing": 0, "pairs_extra": 0,
          "weights_off": 0, "cycle_counts_off": 0}


def compare(got: Answers, want: Answers) -> dict:
    """The store's answers against the reference's: IDs that do not
    resolve, count differences, pairs missing or extra (a duplicate pair
    counts as extra), and pairs whose weight differs in any bit."""
    dev = want.pair_keys.device
    wk, wo = torch.sort(want.pair_keys)
    ww = want.weights[wo].to(torch.float32)
    gk, go = torch.sort(got.pair_keys.to(dev))
    gw = got.weights.to(dev, torch.float32)[go]
    dup = torch.zeros_like(gk, dtype=torch.bool)
    dup[1:] = gk[1:] == gk[:-1]
    if wk.numel():
        pos = torch.searchsorted(wk, gk).clamp(max=wk.numel() - 1)
        hit = wk[pos] == gk
    else:
        pos, hit = torch.zeros_like(gk), torch.zeros_like(dup)
    first = hit & ~dup
    off = gw[first].view(torch.int32) != ww[pos[first]].view(torch.int32)
    return {"ids_unresolved": int((~got.found.to(torch.bool)).sum()),
            "vertices_off": abs(int(got.num_vertices) - want.num_vertices),
            "edges_off": abs(int(got.num_edges) - want.num_edges),
            "pairs_missing": int(wk.numel() - int(first.sum())),
            "pairs_extra": int((~first).sum()),
            "weights_off": int(off.sum())}
