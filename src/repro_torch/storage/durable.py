"""``DurableStore`` — log-then-apply durability behind the GraphStore API
(port of ``repro.storage.durable``; the directory layout, WAL and
checkpoints are the JAX package's, so either package recovers the
other's directory).

Wraps any backend whose ``apply`` is deterministic (both shipped stores
are: fixed-shape padded batches, last-writer-wins). Every ``apply``
frames the EXACT batch into the write-ahead log before the in-memory
apply runs, so the on-disk stream replayed through a fresh store's
``apply`` reproduces the live state bit for bit. ``checkpoint()`` seals
the log: sync the WAL, write an (incremental when safe) epoch-consistent
checkpoint recording the last covered WAL seq, rotate to a fresh
segment, GC old chains and fully-covered segments.

Recovery (module function ``recover``) = newest valid checkpoint chain +
WAL suffix replay::

    store, report = recover(directory, lambda: make_store("local", ...))

``recover`` reads the chosen checkpoint chain once and installs it (the
JAX package's reads it a second time to restore it); ``timings=`` (a
dict, optional) receives the ms of each part: ``read`` and ``crc`` of
the checkpoint chain, ``h2d``, ``replay`` and the ``replayed_ops``.

Falls back checkpoint-by-checkpoint on corruption (dead newer
checkpoints from a diverged pre-crash future are truncated, exactly like
a log), and to a full WAL replay from empty when nothing is recoverable.
Everything else (reads, analytics, epochs, pins) delegates to the inner
store untouched — the wrapper is scheduling-transparent, so
``GraphQueryService`` takes a DurableStore like any other backend.
"""
from __future__ import annotations

import dataclasses
import pathlib
import shutil
import time
from typing import Callable, Optional

from ..api.ir import ApplyResult, OpBatch, UnsupportedOpError
from ..core.status import Reason
from . import checkpoint as ck
from . import wal as wl

__all__ = ["DurabilityConfig", "DurableStore", "recover"]


@dataclasses.dataclass
class DurabilityConfig:
    """Knobs of the durability subsystem (see README "Durability &
    crash recovery")."""

    group_commit: int = 32        # records per fsync (1 = sync every op)
    fsync: bool = True            # False: flush only (page-cache trust)
    incremental: bool = True      # delta checkpoints when row-safe
    checkpoint_every: Optional[int] = None   # auto-ckpt per N applies
    keep: int = 2                 # full checkpoint chains retained
    max_delta_frac: float = 0.5   # touched-block cap for deltas


class DurableStore:
    """GraphStore wrapper adding WAL + checkpoint durability."""

    def __init__(self, store, directory, *,
                 config: Optional[DurabilityConfig] = None,
                 injector=None, _start_seq: int = 0, **kw):
        self.inner = store
        self.directory = pathlib.Path(directory)
        self.config = config or DurabilityConfig(**kw)
        self.injector = injector
        self._wal_seq = _start_seq - 1     # last framed record seq
        self._applies_since_ckpt = 0
        self.wal_stats = dict(wal_records=0, wal_bytes=0, wal_syncs=0,
                              wal_ms=0.0, checkpoints=0, checkpoint_ms=0.0,
                              checkpoint_bytes=0, last_checkpoint_kind="")
        (self.directory / "wal").mkdir(parents=True, exist_ok=True)
        self._open_segment(_start_seq)

    def _open_segment(self, start_seq: int):
        self.wal = wl.WalWriter(
            self.directory / "wal" / f"wal_{start_seq:012d}.log",
            group_commit=self.config.group_commit,
            fsync=self.config.fsync, injector=self.injector)

    # ---- the durable write path ----
    def apply(self, batch: OpBatch) -> ApplyResult:
        if batch.kind not in self.supported_ops:
            # refuse BEFORE logging: an unsupported op must not poison
            # the replay stream (replay calls inner.apply verbatim)
            raise UnsupportedOpError(batch.kind, self.backend)
        if len(batch) == 0:
            return ApplyResult(0, 0)
        t0 = time.perf_counter()
        self._wal_seq += 1
        self.wal.append(self._wal_seq, batch)
        self.wal_stats["wal_ms"] = round(
            self.wal_stats["wal_ms"] +
            (time.perf_counter() - t0) * 1000.0, 3)
        res = self.inner.apply(batch)
        self._applies_since_ckpt += 1
        self.wal_stats["wal_records"] = self.wal.records_written
        self.wal_stats["wal_bytes"] = self.wal.bytes_written
        self.wal_stats["wal_syncs"] = self.wal.syncs
        ce = self.config.checkpoint_every
        if ce and self._applies_since_ckpt >= ce:
            self.checkpoint()
        return res

    def sync(self):
        """Force the group-commit boundary (durable ack point)."""
        self.wal.sync()
        self.wal_stats["wal_syncs"] = self.wal.syncs

    def checkpoint(self, *, timings: Optional[dict] = None) -> dict:
        """Seal the log into a checkpoint: WAL sync, (incremental)
        checkpoint stamped with the covered WAL seq, segment rotation,
        GC of old chains and fully-covered segments. ``timings``: the
        parts of the save (``checkpoint.save_graph_checkpoint``)."""
        t0 = time.perf_counter()
        self.sync()
        man = ck.save_graph_checkpoint(
            self.directory, self.inner,
            incremental=self.config.incremental,
            wal_seq=self._wal_seq, keep=self.config.keep,
            max_delta_frac=self.config.max_delta_frac, timings=timings)
        self.wal.close()
        self._open_segment(self._wal_seq + 1)
        self._prune_wal()
        self._applies_since_ckpt = 0
        self.wal_stats["checkpoints"] += 1
        self.wal_stats["checkpoint_ms"] = round(
            self.wal_stats["checkpoint_ms"] +
            (time.perf_counter() - t0) * 1000.0, 3)
        self.wal_stats["checkpoint_bytes"] = man["bytes"]
        self.wal_stats["last_checkpoint_kind"] = man["kind"]
        return man

    def _prune_wal(self):
        """Drop segments every retained checkpoint already covers: the
        OLDEST retained checkpoint's ``wal_seq`` bounds how far back any
        recovery can need to replay."""
        ids = ck.checkpoint_ids(self.directory)
        if not ids:
            return
        try:
            oldest = ck._read_manifest(self.directory, ids[0])
        except ck.CheckpointError:
            return
        horizon = oldest["wal_seq"]
        for p in wl.wal_segments(self.directory / "wal"):
            if p == self.wal.path:
                continue
            scan = wl.read_wal(p)
            if scan.tail is Reason.OK and scan.last_seq <= horizon:
                p.unlink()
            else:
                break      # segments are ordered; keep everything newer

    def close(self):
        self.wal.close()

    # ---- transparent delegation ----
    def __getattr__(self, name):
        return getattr(self.inner, name)

    @property
    def backend(self) -> str:
        return "durable+" + self.inner.backend

    @property
    def stats(self) -> dict:
        return {**self.inner.stats, **self.wal_stats}


def recover(directory, make_store: Callable[[], object], *,
            config: Optional[DurabilityConfig] = None, injector=None,
            timings: Optional[dict] = None, **kw):
    """Rebuild a durable store from ``directory``: newest valid
    checkpoint chain (falling back on corruption) + deterministic replay
    of the WAL suffix. Returns ``(DurableStore, report)`` where the
    report records what recovery actually did::

        {"checkpoint": id|None, "checkpoint_kind": ..., "replayed": n,
         "wal_tail": Reason, "last_seq": int, "truncated_ckpts": [...]}
    """
    directory = pathlib.Path(directory)
    store = make_store()
    report = dict(checkpoint=None, checkpoint_kind=None, replayed=0,
                  wal_tail=Reason.OK, last_seq=-1, truncated_ckpts=[],
                  gap_at=None)
    after = -1
    hit = ck.latest_recoverable(directory, timings=timings)
    if hit is not None:
        (leaves, man), hit = hit, None
        ck.install_checkpoint(store, leaves, man, timings)
        del leaves          # the host copy of the state, freed before replay
        after = man["wal_seq"]
        report["checkpoint"] = man["ckpt_id"]
        report["checkpoint_kind"] = man["kind"]
        # newer checkpoints that failed validation are a dead (possibly
        # diverged) future — truncate them like a log suffix
        for i in ck.checkpoint_ids(directory):
            if i > man["ckpt_id"]:
                shutil.rmtree(ck._dir_of(directory, i),
                              ignore_errors=True)
                report["truncated_ckpts"].append(i)
    # seal the log: chop the first broken segment at its valid prefix
    # (so the torn garbage can never shadow post-recovery appends) and
    # retire segments past it — a broken tail means a seq gap, and a
    # deterministic replay must never jump one
    broken = False
    for p in wl.wal_segments(directory / "wal"):
        if broken:
            p.rename(p.with_name(p.name + ".dead"))
            continue
        scan = wl.read_wal(p)
        if scan.tail is not Reason.OK:
            with open(p, "r+b") as f:
                f.truncate(scan.valid_bytes)
            report["wal_tail"] = scan.tail
            broken = True
    scan = wl.read_wal_dir(directory / "wal", after_seq=after)
    expect = after + 1
    last = after
    t0 = time.perf_counter()
    ops = 0
    for rec in scan.records:
        if rec.seq != expect:      # gap: records lost with a fallen-back
            report["gap_at"] = rec.seq   # checkpoint — stop, stay exact
            break
        store.apply(rec.batch)
        report["replayed"] += 1
        ops += len(rec.batch)
        expect += 1
        last = rec.seq
    if timings is not None:
        timings["replay"] = (time.perf_counter() - t0) * 1e3
        timings["replayed_ops"] = ops
    report["last_seq"] = last
    if report["gap_at"] is not None:
        # post-gap records are unreachable forever AND their seqs would
        # collide with the restarted log — retire those segments
        for p in wl.wal_segments(directory / "wal"):
            s = wl.read_wal(p)
            if s.records and s.records[-1].seq > last:
                p.rename(p.with_name(p.name + ".dead"))
    cfg = config or DurabilityConfig(**kw)
    dur = DurableStore(store, directory, config=cfg, injector=injector,
                       _start_seq=last + 1)
    return dur, report
