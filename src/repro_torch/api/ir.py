"""Typed operation IR of the ``GraphStore`` front door (PyTorch port).

A copy of ``repro.api.ir``: the IR is numpy-only, and the port imports
nothing of the JAX package, so it carries its own copy.

Three value kinds cover everything a storage backend is asked to do —
mutate (``OpBatch``), look up (``ReadOp``), and run a registered algorithm
(``AnalyticsOp``). Ops are host-side descriptions carrying exact (ragged)
numpy arrays of vertex IDs; the FIXED-SHAPE PADDING RULE lives in the
backends: every store pads a batch to its static ``batch`` width with
masked-off rows before touching a device program, so differently-sized
submissions reuse one compile cache (the same discipline ``RadixGraph``
and the sharded engine already apply internally).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import numpy as np

__all__ = ["OpBatch", "ReadOp", "AnalyticsOp", "ApplyResult",
           "AnalyticsResult", "UnsupportedOpError"]

_OP_KINDS = ("edges", "add_vertices", "delete_vertices")


class UnsupportedOpError(NotImplementedError):
    """A structurally valid ``OpBatch`` the target backend cannot route.

    Carries the op ``kind`` and the refusing ``backend`` so admission
    layers (the query service) can surface a typed rejection instead of
    crashing the write loop. Subclasses ``NotImplementedError`` so legacy
    ``except NotImplementedError`` callers keep working."""

    def __init__(self, kind: str, backend: str, detail: str = ""):
        self.kind = kind
        self.backend = backend
        msg = f"op kind {kind!r} is not supported by the {backend!r} backend"
        super().__init__(msg + (f": {detail}" if detail else ""))
_READ_KINDS = ("lookup", "degree", "neighbors", "snapshot", "num_vertices",
               "num_edges")


@dataclasses.dataclass(frozen=True)
class OpBatch:
    """One batch of graph mutations.

    ``kind='edges'``: parallel ``src``/``dst`` uint64 ID arrays plus a
    float32 ``weight`` per op — ``0.0`` is the paper's NULL tombstone
    (delete), ``None`` means all-ones inserts. Order is the operation
    order (last-writer-wins within a batch, exactly like the engine).

    ``kind='add_vertices'`` / ``'delete_vertices'``: ``ids`` only.
    """

    kind: str = "edges"
    src: Optional[np.ndarray] = None
    dst: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.kind not in _OP_KINDS:
            raise ValueError(f"OpBatch kind {self.kind!r} not in {_OP_KINDS}")
        if self.kind == "edges":
            if self.src is None or self.dst is None:
                raise ValueError("edges batch needs src and dst")
            src = np.asarray(self.src, np.uint64)
            dst = np.asarray(self.dst, np.uint64)
            if src.shape != dst.shape:
                raise ValueError("src/dst length mismatch")
            w = (np.ones(len(src), np.float32) if self.weight is None
                 else np.asarray(self.weight, np.float32))
            if w.shape != src.shape:
                raise ValueError("weight length mismatch")
            object.__setattr__(self, "src", src)
            object.__setattr__(self, "dst", dst)
            object.__setattr__(self, "weight", w)
        else:
            if self.ids is None:
                raise ValueError(f"{self.kind} batch needs ids")
            object.__setattr__(self, "ids",
                              np.asarray(self.ids, np.uint64))

    @staticmethod
    def edges(src, dst, weight=None) -> "OpBatch":
        return OpBatch(kind="edges", src=src, dst=dst, weight=weight)

    @staticmethod
    def add_vertices(ids) -> "OpBatch":
        return OpBatch(kind="add_vertices", ids=ids)

    @staticmethod
    def delete_vertices(ids) -> "OpBatch":
        return OpBatch(kind="delete_vertices", ids=ids)

    def __len__(self) -> int:
        return len(self.src if self.kind == "edges" else self.ids)


@dataclasses.dataclass(frozen=True)
class ReadOp:
    """One lookup-class read.

    kinds (cross-backend semantics — identical answers on every backend):

    * ``lookup``       -> bool[len(ids)]: vertex currently live? (row
                          offsets are backend-private, so the portable
                          answer is presence);
    * ``degree``       -> int32[len(ids)] live out-degree (0 if absent);
    * ``neighbors``    -> list of (neighbor_ids uint64[], weights f32[]);
    * ``num_vertices`` / ``num_edges`` -> int;
    * ``snapshot``     -> the backend-NATIVE CSR artifact (single
                          ``GraphSnapshot`` locally, shard-stacked on the
                          sharded backend) — the one deliberately
                          non-portable read, for analytics plumbing.
    """

    kind: str
    ids: Optional[np.ndarray] = None
    width: Optional[int] = None     # neighbors: max returned per vertex

    def __post_init__(self):
        if self.kind not in _READ_KINDS:
            raise ValueError(f"ReadOp kind {self.kind!r} not in "
                             f"{_READ_KINDS}")
        if self.kind in ("lookup", "degree", "neighbors"):
            if self.ids is None:
                raise ValueError(f"{self.kind} read needs ids")
            object.__setattr__(self, "ids", np.asarray(self.ids, np.uint64))


def _freeze(v) -> Any:
    if isinstance(v, np.ndarray):
        return ("ndarray",) + tuple(v.reshape(-1).tolist()) + (v.shape,)
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


@dataclasses.dataclass(frozen=True)
class AnalyticsOp:
    """A registered algorithm by name plus its parameters.

    ``params`` mixes static knobs (``iters``, ``max_iters``, ``k``,
    ``damping``...) with vertex arguments (``source`` — a single ID,
    ``sources`` — an ID array); the registry entry declares which is
    which, so every backend resolves IDs into its own addressing
    (offsets locally, packed keys on the mesh).
    """

    name: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", dict(self.params))

    def cache_key(self) -> Tuple:
        """Hashable identity (epoch-memoization key in the service)."""
        return (self.name,) + tuple(sorted(
            (k, _freeze(v)) for k, v in self.params.items()))


@dataclasses.dataclass(frozen=True)
class AnalyticsResult:
    """One analytics answer plus its provenance — what the incremental
    engine chains from epoch to epoch.

    ``value`` is the normalized (backend-independent) answer, exactly what
    ``GraphStore.analytics`` returns. ``epoch`` is the capture sequence the
    answer is valid at; ``mode`` records how it was produced (``scratch``
    or ``incremental``) and ``reason`` why an advance fell back (empty
    otherwise). ``iters`` is the iteration/round count of the producing
    run. ``raw`` and ``handle`` are BACKEND-PRIVATE warm state (per-row
    value arrays + the epoch handle they align with) — an advance consumes
    them; treat them as opaque."""

    value: Any
    epoch: int
    mode: str = "scratch"
    iters: int = 0
    reason: str = ""
    raw: Any = dataclasses.field(default=None, repr=False)
    handle: Any = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass(frozen=True)
class ApplyResult:
    """Outcome of one ``OpBatch``: ops admitted to the engine vs ops the
    engine refused at capacity (never UB — the paper's overflow
    discipline)."""

    applied: int
    dropped: int
