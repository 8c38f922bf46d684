"""Per-device cost counter of the port's dry runs (counterpart of
``repro.launch.hlo``).

The JAX package lowers a program to XLA HLO on placeholder devices and
reads its cost from the compiled text: FLOPs and bytes from XLA's cost
analysis, collective bytes by parsing the partitioned HLO, with while
bodies multiplied by their trip counts and each conditional at its
largest branch. A torch program has no HLO, so no parser is copied here.
Instead :class:`CostCounter`, a ``TorchDispatchMode``, sees every aten op
the program *runs* (on fake tensors: nothing is computed) and counts:

* ``flops`` (:data:`FLOPS_RULE`): ``torch.utils.flop_counter``'s formulas
  on each rank's local ops;
* ``bytes_accessed`` (:data:`BYTES_RULE`): each local aten op's input and
  output tensor bytes, as XLA's unfused count;
* ``collective_bytes`` / ``collective_counts`` / ``collective_elements``
  keyed by JAX's :data:`COLLECTIVES` names, each collective's result
  bytes per device, as ``parse_collectives`` counts a result type;
* the peak of live bytes the program allocated (the dry run's
  ``temp_size_in_bytes``).

Collectives are counted as they are executed (:data:`BRANCH_RULE`): a
run or trace counts only the branch it takes, and each loop trip it
makes, where the JAX parser counts every trip of a static bound and the
largest branch.

Two sources feed one counter:

* DTensor programs on the dry run's ``DeviceMesh``: the mode sees the
  DTensor op (skipped: its local ops follow) and the local ops and
  functional collectives of rank 0, which stand for every rank. An op
  DTensor cannot place fails the trace (the dry run records the cell as
  failed, naming the op): no cost is made up for it. The model's ops
  that DTensor cannot place as written run per rank with their
  collectives spelled out (``dist.local_ops``);
* the stacked graph engine (``dist.graph_engine``): every shard on one
  device, its exchange points (the all-to-all transpose, the replicated
  sums and decisions) call ``dist.costs_hook.note_collective`` with the
  per-shard elements and bytes (this counter joins that module's stack
  while it is entered); its aten ops are counted whole and divided
  by the shard count (``per_shard``).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..dist import costs_hook

__all__ = ["COLLECTIVES", "BRANCH_RULE", "FLOPS_RULE", "BYTES_RULE",
           "TEMP_RULE", "CostCounter"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
BRANCH_RULE = "executed"
FLOPS_RULE = ("torch.utils.flop_counter formulas (matmul, bmm, baddbmm, "
              "addmm, convolution, attention) on each device's local ops; "
              "elementwise ops count 0")
BYTES_RULE = ("each local aten op's input + output tensor bytes, view and "
              "metadata ops excluded (XLA's unfused count)")
TEMP_RULE = ("peak of the live bytes the program allocated on a device "
             "(tensors it created, not its arguments)")

# functional collectives (torch.distributed._functional_collectives) by
# JAX's names; a broadcast has no JAX counterpart and keeps its own
_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}
_FREE = ("detach", "lift_fresh", "_to_copy_meta", "wait_tensor")

def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and \
        not rets[0].alias_info.is_write


class CostCounter(TorchDispatchMode):
    """Counts what a program runs, per device (see the module docstring).
    Use as a context manager; :meth:`record` gives the totals.

    ``per_shard`` divides the aten-op counts (FLOPs, bytes) by a shard
    count: the stacked graph engine runs every shard's work in one op.
    Collectives noted by :func:`note_collective` are per shard already."""

    def __init__(self, per_shard: int = 1):
        super().__init__()
        self.per_shard = per_shard
        self.paused = False
        self.last_op = None     # the last DTensor op (names a failure)
        self.flops = 0
        self.bytes_accessed = 0
        self.cbytes: Dict[str, float] = {c: 0.0 for c in COLLECTIVES}
        self.ccounts: Dict[str, float] = {c: 0.0 for c in COLLECTIVES}
        self.celems: Dict[str, float] = {c: 0.0 for c in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def __enter__(self):
        costs_hook.push(self)
        self._unpatch = _pause_during_propagation(self)
        return super().__enter__()

    def __exit__(self, *exc):
        costs_hook.pop(self)
        self._unpatch()
        return super().__exit__(*exc)

    def add_collective(self, kind: str, elements: int, nbytes: int,
                       count: int = 1):
        for d in (self.cbytes, self.ccounts, self.celems):
            d.setdefault(kind, 0.0)
        self.cbytes[kind] += float(nbytes) * count
        self.celems[kind] += float(elements) * count
        self.ccounts[kind] += count

    def _track(self, outs):
        """Live bytes of the storages the program creates: each counted
        once, until it is freed."""
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        if key in self._seen:
            self._seen.discard(key)
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        if any(isinstance(t, DTensor) for t in ins):
            # the global op: DTensor runs it, and its local ops and
            # redistributions come back through this mode
            self.last_op = str(func)
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _tensors(out)
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name in _FUNCOL:
            res = outs[0] if outs else ins[0]
            self.add_collective(_FUNCOL[name], res.numel(), _nbytes(res))
            return out
        if name in _FREE or _is_view(func):
            return out
        from torch.utils.flop_counter import flop_registry
        if func.overloadpacket in flop_registry:
            self.flops += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        self._track([t for t in outs if not any(
            t.untyped_storage() is i.untyped_storage() for i in ins)])
        return out

    def record(self) -> dict:
        """The JAX dry-run record's cost keys, per device."""
        k = self.per_shard
        return {
            "flops": float(self.flops) / k,
            "flops_rule": FLOPS_RULE,
            "bytes_accessed": float(self.bytes_accessed) / k,
            "bytes_rule": BYTES_RULE,
            "collective_bytes": dict(self.cbytes),
            "collective_counts": dict(self.ccounts),
            "collective_elements": dict(self.celems),
            "collective_branch_rule": BRANCH_RULE,
        }


class _Paused:
    """A reusable context manager that pauses a counter: DTensor's
    sharding propagation runs each new op once on fake tensors of the
    global shapes to learn its output's metadata, which no device
    runs."""

    def __init__(self, counter, inner):
        self.counter, self.inner = counter, inner

    def __enter__(self):
        self.was = self.counter.paused
        self.counter.paused = True
        return self.inner.__enter__()

    def __exit__(self, *exc):
        self.counter.paused = self.was
        return self.inner.__exit__(*exc)


def _pause_during_propagation(counter):
    """Pause ``counter`` while DTensor propagates metadata (through the
    lock its propagator holds around that run). Returns the undo."""
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
    except ImportError:
        return lambda: None
    if hasattr(SP, "_fake_mode_lock"):
        old = SP._fake_mode_lock
        SP._fake_mode_lock = _Paused(counter, old)

        def undo():
            SP._fake_mode_lock = old
        return undo
    fn = getattr(SP, "_propagate_tensor_meta_non_cached", None)
    if fn is None:
        return lambda: None

    def paused(self, *a, **kw):
        with _Paused(counter, contextlib.nullcontext()):
            return fn(self, *a, **kw)
    SP._propagate_tensor_meta_non_cached = paused

    def undo():
        SP._propagate_tensor_meta_non_cached = fn
    return undo
