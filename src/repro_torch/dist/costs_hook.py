"""Where the stacked graph engine reports its exchanges: a stack of the
cost counters in use (``launch.costs.CostCounter`` pushes itself here
while it is entered) and :func:`note_collective`, which records into the
innermost one. Kept below ``launch`` so that ``dist`` does not import the
layer above it."""
from __future__ import annotations

from typing import List

__all__ = ["active", "push", "pop", "note_collective"]

_ACTIVE: List = []


def active():
    """The innermost counter in use, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def push(counter):
    _ACTIVE.append(counter)


def pop(counter):
    _ACTIVE.remove(counter)


def note_collective(kind: str, elements: int, itemsize: int, count=1):
    """Record ``count`` collectives of ``kind`` (a ``launch.costs.
    COLLECTIVES`` name) moving ``elements`` elements of ``itemsize``
    bytes each per device, in the active counter (none: nothing
    happens)."""
    c = active()
    if c is not None:
        c.add_collective(kind, elements, elements * itemsize, count)
