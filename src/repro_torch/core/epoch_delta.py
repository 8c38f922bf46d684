"""Epoch-delta extraction: the exact edge changes between two captured
epochs of one (per-shard) ``GraphState`` (port of
``repro.core.epoch_delta``).

The paper's hybrid snapshot-log design makes the difference between two
sealed epochs a small log suffix — this module turns that suffix into a
typed ``EpochDelta`` the incremental analytics engine can consume
(``repro_torch.analytics.incremental``): per-pair ``(src_row, dst_row,
w_prev, w_new)`` changes plus vertex-level events, derived WITHOUT
replaying ops.

Row offsets are the identity carrier: vertex rows are recycled into the
free ring only by a global defrag, so between two epochs with an equal
``pool.defrags`` counter every row offset names the same vertex in both
states and warm per-row value arrays stay aligned. Extraction therefore
REFUSES (returns ``None`` + reason) whenever:

* ``pool.defrags`` differs — rows may have moved / been recycled;
* any overflow flag changed — dropped ops make the window unreliable;
* any vertex delete/revive happened — a vertex delete hides every
  incident edge (in- AND out-) at read time, so source rows far from the
  touched set change adjacency invisibly.

Touched rows are the union of two passes, both run on the state's device
so that only the touched row indices come to the host (at LiveJournal
scale the pool's ``ts`` alone is 512 MB):

1. vertex-table signature diff (``size``/``cap``/``start_block``/
   ``deg``/``del_time``) — catches appends, extent moves and per-vertex
   compactions that changed the footprint;
2. fresh log-entry scan — pool entries stamped ``ts >= prev_clock``
   (per-vertex compaction preserves entry timestamps, so any surviving
   window write marks its owner row even when the vt signature happens
   to collide).

Touched rows then get a sorted-CSR merge diff between the two epochs'
host CSR views — the effective per-pair changes, immune to how many log
records produced them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .status import Reason

__all__ = ["EpochDelta", "HostCsr", "host_csr", "extract_delta",
           "extract_delta_sharded", "merged_flags"]


@dataclasses.dataclass(frozen=True)
class HostCsr:
    """Host (numpy) view of one ``GraphSnapshot`` — built once per epoch
    and shared by the extractor and every host-side advance."""

    indptr: np.ndarray    # int32[n_cap + 1]
    dst: np.ndarray       # int32[m_cap] destination row offsets
    weight: np.ndarray    # float32[m_cap]
    active: np.ndarray    # bool[n_cap]
    ids: np.ndarray       # uint32[n_cap, 2]
    m: int                # live edge count

    @property
    def n_cap(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def deg(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    def vid64(self) -> np.ndarray:
        """Row -> 64-bit vertex ID."""
        return (self.ids[:, 0].astype(np.uint64) << np.uint64(32)) | \
            self.ids[:, 1].astype(np.uint64)


def host_csr(snap) -> HostCsr:
    """One host pull of a device ``GraphSnapshot``."""
    return HostCsr(indptr=snap.indptr.cpu().numpy(),
                   dst=snap.dst.cpu().numpy(),
                   weight=snap.weight.cpu().numpy(),
                   active=snap.active.cpu().numpy(),
                   ids=snap.ids.cpu().numpy().astype(np.uint32),
                   m=int(snap.m))


@dataclasses.dataclass(frozen=True)
class EpochDelta:
    """Effective changes between two epochs of one shard.

    Pair arrays are parallel: change k turned edge ``(e_src[k],
    e_dst[k])`` from weight ``w_prev[k]`` to ``w_new[k]`` (0.0 = absent /
    tombstoned on that side) — the NET effect, not the op log, so an
    insert+delete of the same pair inside the window vanishes here."""

    touched_rows: np.ndarray      # int32 — rows whose adjacency changed
    new_rows: np.ndarray          # int32 — rows allocated in the window
    e_src: np.ndarray             # int32[k]
    e_dst: np.ndarray             # int32[k]
    w_prev: np.ndarray            # float32[k]
    w_new: np.ndarray             # float32[k]
    m_prev: int                   # live edges at the previous epoch
    m_cur: int                    # live edges at the current epoch

    @property
    def n_changed(self) -> int:
        return int(self.e_src.shape[0])

    @property
    def inserts(self) -> np.ndarray:
        return (self.w_prev == 0.0) & (self.w_new != 0.0)

    @property
    def deletes(self) -> np.ndarray:
        return (self.w_prev != 0.0) & (self.w_new == 0.0)

    @property
    def updates(self) -> np.ndarray:
        return (self.w_prev != 0.0) & (self.w_new != 0.0)

    @property
    def has_deletes(self) -> bool:
        return bool(self.deletes.any())

    @property
    def has_weight_increase(self) -> bool:
        return bool((self.updates & (self.w_new > self.w_prev)).any())


def _flags(state) -> Tuple[int, ...]:
    """(defrags, sort overflow, vt overflow, pool overflow, num_rows,
    clock) in one host fetch."""
    return tuple(torch.stack([
        state.pool.defrags, state.sort.overflow, state.vt.overflow,
        state.pool.overflow, state.vt.num_rows,
        state.pool.clock]).tolist())


def _row_pairs(csr: HostCsr, r: int) -> Tuple[np.ndarray, np.ndarray]:
    lo, hi = int(csr.indptr[r]), int(csr.indptr[r + 1])
    return csr.dst[lo:hi], csr.weight[lo:hi]


def _touched_rows(prev_state, cur_state, n_prev: int, n_cur: int,
                  prev_clock: int, n_cap: int) -> Optional[np.ndarray]:
    """Sorted int32 rows touched in the window (on the device, one pull),
    or None on a vertex delete / revive."""
    pvt, cvt = prev_state.vt, cur_state.vt
    dt_p, dt_c = pvt.del_time[:n_prev], cvt.del_time[:n_prev]
    moved = dt_p != dt_c
    if bool((moved & ~((dt_p == -1) & (dt_c == 0))).any()):
        return None
    sig = torch.zeros((n_cap,), dtype=torch.bool, device=dt_c.device)
    for f in ("size", "cap", "start_block", "deg"):
        moved = moved | (getattr(pvt, f)[:n_prev] != getattr(cvt, f)[:n_prev])
    sig[:n_prev] = moved
    # fresh log entries: per-vertex compaction and the bounded append both
    # preserve entry timestamps, so any surviving window write marks its
    # block's owner row (blocks are never recycled between defrags)
    pool = cur_state.pool
    fresh = (pool.ts >= prev_clock).any(dim=1) & (pool.owner >= 0) & \
        (pool.owner < n_cap)
    sig[pool.owner[fresh].to(torch.int64)] = True
    sig[n_prev:n_cur] = True
    return torch.nonzero(sig).flatten().cpu().numpy().astype(np.int32)


def extract_delta(prev_state, cur_state, prev_csr: HostCsr,
                  cur_csr: HostCsr) -> Tuple[Optional[EpochDelta], Reason]:
    """Diff two captured epochs of ONE shard. Returns ``(delta, reason)``;
    ``delta is None`` means the window is not advance-safe and callers
    must recompute from scratch (``reason`` says why)."""
    pf, cf = _flags(prev_state), _flags(cur_state)
    if pf[0] != cf[0]:
        return None, Reason.DEFRAG       # rows may have been recycled
    if pf[1:4] != cf[1:4]:
        return None, Reason.OVERFLOW     # dropped ops in the window
    n_prev, n_cur = pf[4], cf[4]
    if n_cur < n_prev:
        return None, Reason.ROWS_SHRANK  # never expected without defrag
    # vertex delete / revive anywhere invalidates untouched source rows
    # (their in-edges to the deleted vertex vanish at read time)
    touched = _touched_rows(prev_state, cur_state, n_prev, n_cur, pf[5],
                            cur_csr.n_cap)
    if touched is None:
        return None, Reason.VERTEX_EVENT
    new_rows = np.arange(n_prev, n_cur, dtype=np.int32)

    es, ed, wp, wn = [], [], [], []
    for r in touched.tolist():
        pd, pw = (_row_pairs(prev_csr, r) if r < n_prev
                  else (np.zeros(0, np.int32), np.zeros(0, np.float32)))
        cd, cw = _row_pairs(cur_csr, r)
        if pd.shape == cd.shape and np.array_equal(pd, cd) and \
                np.array_equal(pw, cw):
            continue
        both = np.union1d(pd, cd).astype(np.int32)
        wpr = np.zeros(both.shape, np.float32)
        wpr[np.searchsorted(both, pd)] = pw
        wcu = np.zeros(both.shape, np.float32)
        wcu[np.searchsorted(both, cd)] = cw
        ch = wpr != wcu
        k = int(ch.sum())
        if k:
            es.append(np.full((k,), r, np.int32))
            ed.append(both[ch])
            wp.append(wpr[ch])
            wn.append(wcu[ch])

    cat = lambda xs, dt: (np.concatenate(xs) if xs  # noqa: E731
                          else np.zeros((0,), dt))
    return EpochDelta(
        touched_rows=touched, new_rows=new_rows,
        e_src=cat(es, np.int32), e_dst=cat(ed, np.int32),
        w_prev=cat(wp, np.float32), w_new=cat(wn, np.float32),
        m_prev=prev_csr.m, m_cur=cur_csr.m), Reason.OK


def _host_state_views(state, n_shards: int):
    """Per-shard views of the state fields extraction reads, sliced off
    the leading shard axis without a copy. The JAX package pulls these
    fields to the host once and slices there; the port leaves them on the
    state's device, where ``extract_delta`` scans them and fetches only
    each shard's flags and touched rows."""
    from types import SimpleNamespace as NS
    vt, pool, sort = state.vt, state.pool, state.sort
    return [NS(pool=NS(defrags=pool.defrags[s], overflow=pool.overflow[s],
                       clock=pool.clock[s], ts=pool.ts[s],
                       owner=pool.owner[s]),
               sort=NS(overflow=sort.overflow[s]),
               vt=NS(overflow=vt.overflow[s], size=vt.size[s],
                     cap=vt.cap[s], start_block=vt.start_block[s],
                     deg=vt.deg[s], del_time=vt.del_time[s],
                     num_rows=vt.num_rows[s]))
            for s in range(n_shards)]


def extract_delta_sharded(prev_state, cur_state, prev_csrs: List[HostCsr],
                          cur_csrs: List[HostCsr]
                          ) -> Tuple[Optional[List[EpochDelta]], str]:
    """Per-shard deltas over stacked sharded states (leading shard axis).
    Any shard refusing refuses the whole window — warm row alignment must
    hold everywhere — with the reason prefixed by ``shard{s}:``."""
    n_shards = len(cur_csrs)
    pvs = _host_state_views(prev_state, n_shards)
    cvs = _host_state_views(cur_state, n_shards)
    out = []
    for s in range(n_shards):
        d, reason = extract_delta(pvs[s], cvs[s], prev_csrs[s],
                                  cur_csrs[s])
        if d is None:
            # the shard index is diagnostic; the suffix is the Reason code
            return None, f"shard{s}:{reason}"
        out.append(d)
    return out, Reason.OK


def merged_flags(deltas: List[EpochDelta]) -> dict:
    """Aggregate advance-safety flags over per-shard deltas."""
    return dict(
        n_changed=sum(d.n_changed for d in deltas),
        m_prev=sum(d.m_prev for d in deltas),
        m_cur=sum(d.m_cur for d in deltas),
        has_deletes=any(d.has_deletes for d in deltas),
        has_weight_increase=any(d.has_weight_increase for d in deltas),
        new_rows=sum(int(d.new_rows.shape[0]) for d in deltas))
