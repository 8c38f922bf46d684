"""Typed status/refusal codes shared across the incremental-analytics
fallback ladder and the durability subsystem (a copy of
``repro.core.status``: the port imports nothing of the JAX package, so it
carries its own).

Historically ``extract_delta`` and the stores' ``analytics_advance``
ladders passed bare strings around ("defrag", "no-warm", ...). ``Reason``
promotes every one of them to an enum member WITHOUT breaking string
consumers: it is a ``str`` subclass whose value is the exact legacy
string, so ``reason == "defrag"``, ``f"shard0:{reason}"`` and JSON
round-trips all keep working while call sites gain an enumerable,
typo-proof vocabulary. The same enum carries the WAL / checkpoint
recovery codes (``repro.storage`` in the JAX package), so a recovery
report and an advance refusal speak one language.
"""
from __future__ import annotations

import enum

__all__ = ["Reason", "ADVANCE_FALLBACKS", "DELTA_REFUSALS", "WAL_TAILS"]


class Reason(str, enum.Enum):
    """One vocabulary for "why did the fast path refuse" — epoch-delta
    extraction, warm-advance fallbacks, and WAL/checkpoint recovery."""

    OK = "ok"

    # -- extract_delta refusals (core/epoch_delta.py) --
    DEFRAG = "defrag"                  # rows may have been recycled
    OVERFLOW = "overflow"              # dropped ops in the window
    ROWS_SHRANK = "rows-shrank"        # never expected without defrag
    VERTEX_EVENT = "vertex-event"      # delete/revive hides in-edges

    # -- analytics_advance fallback ladder (api/store.py) --
    NO_WARM = "no-warm"                # no previous result / no advance form
    DELTA_TOO_LARGE = "delta-too-large"
    ABSENT_SOURCE = "absent-source"
    ADVANCE_REFUSED = "advance-refused"
    NO_WARM_PROGRAM = "no-warm-program"   # e.g. fixed-iteration PageRank
    RESTORE_BOUNDARY = "restore-boundary"  # warm handle predates a restore

    # -- registry warm guards (api/registry.py) --
    DELETES = "deletes"
    WEIGHT_INCREASE = "weight-increase"

    # -- WAL tail states (repro.storage.wal) --
    WAL_TORN = "wal-torn"              # mid-record EOF (crash while writing)
    WAL_BAD_MAGIC = "wal-bad-magic"    # framing lost / overwritten bytes
    WAL_BAD_CRC = "wal-bad-crc"        # payload corrupted on disk
    WAL_BAD_HEADER = "wal-bad-header"  # file preamble unreadable
    WAL_DECODE = "wal-decode"          # CRC-valid record, undecodable body

    # -- checkpoint recovery codes (repro.storage.checkpoint) --
    CKPT_MISSING = "ckpt-missing"
    CKPT_BAD_MANIFEST = "ckpt-bad-manifest"
    CKPT_BAD_CRC = "ckpt-bad-crc"
    CKPT_BAD_CHAIN = "ckpt-bad-chain"  # delta whose base is unrecoverable

    # keep f-string / str() behaviour identical to the legacy plain strings
    # (Python 3.11+ would otherwise render the member name)
    __str__ = str.__str__
    __format__ = str.__format__


# The reasons extract_delta itself can return (besides OK).
DELTA_REFUSALS = frozenset({
    Reason.DEFRAG, Reason.OVERFLOW, Reason.ROWS_SHRANK,
    Reason.VERTEX_EVENT,
})

# Every distinct way analytics_advance can fall back to scratch: the
# delta refusals plus the ladder's own checks plus the registry guards.
ADVANCE_FALLBACKS = frozenset(DELTA_REFUSALS | {
    Reason.NO_WARM, Reason.DELTA_TOO_LARGE, Reason.ABSENT_SOURCE,
    Reason.ADVANCE_REFUSED, Reason.NO_WARM_PROGRAM,
    Reason.RESTORE_BOUNDARY, Reason.DELETES, Reason.WEIGHT_INCREASE,
})

# Non-OK states a WAL scan can end in.
WAL_TAILS = frozenset({
    Reason.WAL_TORN, Reason.WAL_BAD_MAGIC, Reason.WAL_BAD_CRC,
    Reason.WAL_BAD_HEADER, Reason.WAL_DECODE,
})
