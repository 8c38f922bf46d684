"""Write-ahead log of applied ``OpBatch``es (PyTorch port).

A copy of ``repro.storage.wal``: the codec is numpy-only and the port
imports nothing of the JAX package, so it carries its own copy, byte for
byte the same format (a segment written by either package reads in the
other).

The paper's hybrid snapshot-log design maps directly onto disk: a sealed
epoch checkpoint is the snapshot, and the op stream is the log —
``GraphStore.apply`` is deterministic by construction (fixed-shape padded
batches, last-writer-wins within a batch), so replaying the EXACT applied
batches from a checkpointed state reproduces the live state bit for bit.
The WAL therefore frames batches at the store's apply boundary (never
re-split on replay: batch composition decides pool clocks and defrag
trigger points).

On-disk format (all little-endian):

* file preamble: ``b"RGWAL1\\x00\\x00"`` (8 bytes);
* record: ``magic u32 | seq u64 | kind u8 | len u32`` (17-byte header),
  ``crc u32`` over header-after-magic + payload, then the payload —
  a self-describing ``OpBatch`` encoding (kind + count + raw arrays).

Reading is TOLERANT by contract: ``read_wal`` returns the longest valid
record prefix plus a typed tail state (``core.status.Reason``) — a torn
tail (crash mid-write), a corrupt record, or lost framing never raises;
they terminate the scan exactly where durability ends. Writes are
fsync-batched: ``group_commit`` records per ``fsync`` (1 = every record
durable before ``append`` returns); ``sync()`` force-flushes the tail.

Fault injection: a ``faultfs.FaultInjector`` passed to ``WalWriter``
filters every record write (truncating it and/or raising
``InjectedCrash`` after the partial write lands), which is how the
recovery tests produce byte-exact torn tails deterministically.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..api.ir import OpBatch
from ..core.status import Reason

__all__ = ["FILE_MAGIC", "REC_MAGIC", "encode_batch", "decode_batch",
           "encode_record", "WalRecord", "WalScan", "WalWriter",
           "read_wal", "wal_segments", "read_wal_dir"]

FILE_MAGIC = b"RGWAL1\x00\x00"
REC_MAGIC = 0x4C415752            # "RWAL"
_HDR = struct.Struct("<IQBI")     # magic, seq, kind, payload len
_CRC = struct.Struct("<I")
_KIND_CODE = {"edges": 0, "add_vertices": 1, "delete_vertices": 2}
_KIND_NAME = {v: k for k, v in _KIND_CODE.items()}


# ---- OpBatch payload codec ----

def encode_batch(batch: OpBatch) -> bytes:
    """Self-contained payload: ``n u32`` then the raw arrays (src/dst
    uint64 + weight float32, or ids uint64)."""
    n = len(batch)
    if batch.kind == "edges":
        return struct.pack("<I", n) + batch.src.tobytes() + \
            batch.dst.tobytes() + batch.weight.tobytes()
    return struct.pack("<I", n) + batch.ids.tobytes()


def decode_batch(kind_code: int, payload: bytes) -> OpBatch:
    """Inverse of ``encode_batch``; raises ``ValueError`` on any length
    mismatch (a CRC-valid but undecodable body is a format bug, surfaced
    as ``Reason.WAL_DECODE`` by the reader)."""
    kind = _KIND_NAME.get(kind_code)
    if kind is None:
        raise ValueError(f"unknown OpBatch kind code {kind_code}")
    if len(payload) < 4:
        raise ValueError("payload shorter than its count field")
    (n,) = struct.unpack_from("<I", payload)
    body = payload[4:]
    if kind == "edges":
        if len(body) != n * (8 + 8 + 4):
            raise ValueError("edges payload length mismatch")
        src = np.frombuffer(body[:8 * n], np.uint64)
        dst = np.frombuffer(body[8 * n:16 * n], np.uint64)
        w = np.frombuffer(body[16 * n:], np.float32)
        return OpBatch.edges(src.copy(), dst.copy(), w.copy())
    if len(body) != 8 * n:
        raise ValueError(f"{kind} payload length mismatch")
    ids = np.frombuffer(body, np.uint64).copy()
    return OpBatch(kind=kind, ids=ids)


def encode_record(seq: int, batch: OpBatch) -> bytes:
    payload = encode_batch(batch)
    hdr = _HDR.pack(REC_MAGIC, seq, _KIND_CODE[batch.kind], len(payload))
    crc = zlib.crc32(payload, zlib.crc32(hdr[4:]))
    return hdr + _CRC.pack(crc) + payload


# ---- reading ----

@dataclasses.dataclass(frozen=True)
class WalRecord:
    seq: int
    batch: OpBatch


@dataclasses.dataclass(frozen=True)
class WalScan:
    """Longest valid prefix of one segment (or one ordered segment set)."""

    records: List[WalRecord]
    tail: Reason              # OK, or why the scan stopped early
    valid_bytes: int          # offset of the first invalid byte

    @property
    def last_seq(self) -> int:
        return self.records[-1].seq if self.records else -1


def _scan(data: bytes) -> WalScan:
    if len(data) == 0:
        return WalScan([], Reason.OK, 0)
    if len(data) < len(FILE_MAGIC):
        return WalScan([], Reason.WAL_TORN, 0)
    if data[:len(FILE_MAGIC)] != FILE_MAGIC:
        return WalScan([], Reason.WAL_BAD_HEADER, 0)
    out: List[WalRecord] = []
    off = len(FILE_MAGIC)
    n = len(data)
    while off < n:
        if off + _HDR.size + _CRC.size > n:
            return WalScan(out, Reason.WAL_TORN, off)
        magic, seq, kcode, plen = _HDR.unpack_from(data, off)
        if magic != REC_MAGIC:
            return WalScan(out, Reason.WAL_BAD_MAGIC, off)
        body_at = off + _HDR.size + _CRC.size
        if body_at + plen > n:
            return WalScan(out, Reason.WAL_TORN, off)
        (crc,) = _CRC.unpack_from(data, off + _HDR.size)
        payload = data[body_at:body_at + plen]
        want = zlib.crc32(payload,
                          zlib.crc32(data[off + 4:off + _HDR.size]))
        if crc != want:
            return WalScan(out, Reason.WAL_BAD_CRC, off)
        try:
            batch = decode_batch(kcode, payload)
        except ValueError:
            return WalScan(out, Reason.WAL_DECODE, off)
        out.append(WalRecord(int(seq), batch))
        off = body_at + plen
    return WalScan(out, Reason.OK, off)


def read_wal(path) -> WalScan:
    """Scan one segment file; a missing file is an empty OK scan."""
    p = pathlib.Path(path)
    if not p.exists():
        return WalScan([], Reason.OK, 0)
    return _scan(p.read_bytes())


def wal_segments(directory) -> List[pathlib.Path]:
    """Segment files under ``directory``, ordered by start seq (segments
    rotate at checkpoints: ``wal_<start_seq>.log``)."""
    d = pathlib.Path(directory)
    if not d.exists():
        return []
    segs = []
    for p in d.glob("wal_*.log"):
        try:
            segs.append((int(p.stem.split("_", 1)[1]), p))
        except ValueError:
            continue
    return [p for _, p in sorted(segs)]


def read_wal_dir(directory, after_seq: int = -1) -> WalScan:
    """Ordered scan over every segment, stopping at the first non-OK
    tail (later segments are unreachable once durability is broken —
    rotation only ever happens after a durable checkpoint, so a torn
    middle segment means the later ones postdate a crash rollback).
    Returns records with ``seq > after_seq``."""
    records: List[WalRecord] = []
    tail = Reason.OK
    valid = 0
    for p in wal_segments(directory):
        scan = read_wal(p)
        records.extend(r for r in scan.records if r.seq > after_seq)
        valid += scan.valid_bytes
        if scan.tail is not Reason.OK:
            tail = scan.tail
            break
    return WalScan(records, tail, valid)


# ---- writing ----

class WalWriter:
    """Append-only segment writer with group-commit fsync.

    ``group_commit=k``: one ``fsync`` per ``k`` appended records (the
    classic group-commit latency/durability dial); ``fsync=False`` trusts
    the OS page cache (still ``flush``ed, so same-process readers see
    every byte). ``injector`` is the fault hook (see module docstring).
    """

    def __init__(self, path, *, group_commit: int = 32, fsync: bool = True,
                 injector=None):
        self.path = pathlib.Path(path)
        self.group_commit = max(1, int(group_commit))
        self.fsync = bool(fsync)
        self.injector = injector
        self.records_written = 0
        self.bytes_written = 0
        self.syncs = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fresh = not self.path.exists() or self.path.stat().st_size == 0
        self._f = open(self.path, "ab")
        if fresh:
            self._f.write(FILE_MAGIC)
            self._flush(force=True)
        self._pending = 0

    def append(self, seq: int, batch: OpBatch) -> int:
        """Frame and append one applied batch; returns the record's byte
        size. Durability lags by up to ``group_commit - 1`` records."""
        data = encode_record(seq, batch)
        crash = False
        if self.injector is not None:
            data, crash = self.injector.filter_record(seq, data)
        self._f.write(data)
        if crash:
            # the torn bytes must actually land where a real crash would
            # leave them before the simulated process death propagates
            self._f.flush()
            os.fsync(self._f.fileno())
            from .faultfs import InjectedCrash
            raise InjectedCrash(f"injected crash writing WAL seq {seq}")
        self.records_written += 1
        self.bytes_written += len(data)
        self._pending += 1
        if self._pending >= self.group_commit:
            self.sync()
        return len(data)

    def _flush(self, force: bool = False):
        self._f.flush()
        if self.fsync or force:
            os.fsync(self._f.fileno())

    def sync(self):
        """Force the group-commit boundary: flush + (configured) fsync."""
        if self.injector is not None:
            self.injector.on_sync()
        self._flush()
        self._pending = 0
        self.syncs += 1

    def close(self):
        if not self._f.closed:
            self._flush(force=True)
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
