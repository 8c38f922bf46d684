"""Deterministic fault injection for the durability subsystem (PyTorch
port; a copy of ``repro.storage.faultfs``, which is pure Python).

Two families of faults:

* **in-flight** — a ``FaultInjector`` hooked into ``WalWriter`` kills the
  "process" (raises ``InjectedCrash``) after a configured number of
  records, optionally leaving a TORN tail: the first ``torn_bytes`` bytes
  of the failing record land on disk, byte-exactly what a crash between
  ``write`` and completion produces;
* **at-rest** — helpers that corrupt already-written files the way real
  storage fails: truncation (lost tail), bit flips (latent corruption),
  and deleted/partial checkpoint members (torn incremental chains).

Everything is seedable/deterministic so the recovery property tests can
enumerate failure points instead of sampling them.
"""
from __future__ import annotations

import pathlib
from typing import Optional, Tuple

__all__ = ["InjectedCrash", "FaultInjector", "truncate_file", "flip_byte",
           "corrupt_checkpoint_array", "tear_checkpoint"]


class InjectedCrash(RuntimeError):
    """Stands in for the process dying mid-write (kill -9, power loss)."""


class FaultInjector:
    """WAL writer hook: crash after ``fail_after_records`` appended
    records, tearing the failing record to ``torn_bytes`` bytes;
    ``fail_on_sync`` crashes at the next group-commit boundary instead
    (everything buffered, nothing torn)."""

    def __init__(self, fail_after_records: Optional[int] = None,
                 torn_bytes: int = 0, fail_on_sync: bool = False):
        self.fail_after_records = fail_after_records
        self.torn_bytes = int(torn_bytes)
        self.fail_on_sync = bool(fail_on_sync)
        self.records_seen = 0
        self.crashed = False

    def filter_record(self, seq: int, data: bytes) -> Tuple[bytes, bool]:
        self.records_seen += 1
        if (self.fail_after_records is not None
                and self.records_seen > self.fail_after_records):
            self.crashed = True
            return data[:max(0, min(self.torn_bytes, len(data)))], True
        return data, False

    def on_sync(self):
        if self.fail_on_sync:
            self.crashed = True
            raise InjectedCrash("injected crash at group-commit fsync")


def truncate_file(path, size: int):
    """Chop ``path`` to ``size`` bytes (lost tail)."""
    p = pathlib.Path(path)
    data = p.read_bytes()
    p.write_bytes(data[:max(0, size)])


def flip_byte(path, offset: int):
    """XOR one byte at ``offset`` (negative = from the end)."""
    p = pathlib.Path(path)
    data = bytearray(p.read_bytes())
    data[offset] ^= 0xFF
    p.write_bytes(bytes(data))


def _member_entry(man: dict, name: str) -> dict:
    entry = man["arrays"].get(name)
    if entry is None and man.get("delta"):
        entry = man["delta"]["arrays"].get(name) or \
            man["delta"]["arrays"].get("delta/" + name) or \
            (man["delta"]["blocks"] if name in ("blocks", "delta/blocks")
             else None)
    if entry is None:
        raise KeyError(f"no member {name!r} in checkpoint manifest")
    return entry


def corrupt_checkpoint_array(ckpt_dir, name: str, offset: int = -1):
    """Flip a byte inside a named array member of a checkpoint dir
    (name as recorded in the manifest, e.g. ``pool/dst`` — delta members
    resolve with or without their ``delta/`` prefix)."""
    import json
    d = pathlib.Path(ckpt_dir)
    man = json.loads((d / "manifest.json").read_text())
    flip_byte(d / _member_entry(man, name)["file"], offset)


def tear_checkpoint(ckpt_dir, name: Optional[str] = None):
    """Delete one member file of a checkpoint dir — the torn-directory
    failure a crash during (non-atomic) copy/backup tooling produces.
    Default: the manifest itself (worst case)."""
    d = pathlib.Path(ckpt_dir)
    if name is None:
        (d / "manifest.json").unlink()
        return
    import json
    man = json.loads((d / "manifest.json").read_text())
    (d / _member_entry(man, name)["file"]).unlink()
