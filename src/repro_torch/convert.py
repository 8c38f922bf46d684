"""Carry a graph state across packages as numpy arrays.

``state_from_numpy`` takes a ``GraphState``-shaped tree whose leaves are
numpy arrays — the JAX package's state after ``jax.tree.map(np.asarray,
state)`` has this form — and builds the port's ``GraphState`` on
``device``. uint32 leaves (vertex IDs) become int64; every other leaf
keeps its dtype; a leaf that is already a tensor is moved to
``device``. ``state_to_numpy`` maps back, with the JAX package's dtypes
(the on-disk dtypes of a checkpoint), as copies that later in-place
applies leave unchanged. A sharded state (every leaf with a leading shard
axis, as ``dist.graph_engine.make_sharded_state`` and the JAX package
stack it) converts the same way. Fields are matched by name, so the port
never sees a JAX object.
``snapshot_from_numpy`` / ``snapshot_to_numpy`` do the same for a CSR
``GraphSnapshot``. ``lm_params_from_numpy`` / ``lm_params_to_numpy`` carry
an LM parameter dict (the JAX package's params after ``jax.tree.map(
np.asarray, params)``) into the port and back, dtypes kept: bfloat16
leaves (``ml_dtypes.bfloat16`` in numpy, which ``torch.from_numpy``
refuses) go through their 16-bit patterns. ``train_state_from_numpy`` /
``train_state_to_numpy`` do the same for a training state (params, either
optimizer's state, step), matched by field name: the JAX package's
``TrainState`` after ``jax.tree.map(np.asarray, state)`` goes in, the
port's ``TrainState`` of numpy arrays comes out.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.edgepool import EdgePool
from .core.radixgraph import GraphSnapshot, GraphState
from .core.sort import SortState
from .core.vertex_table import VertexTable

__all__ = ["state_from_numpy", "state_to_numpy", "snapshot_from_numpy",
           "snapshot_to_numpy", "lm_params_from_numpy", "lm_params_to_numpy",
           "train_state_from_numpy", "train_state_to_numpy"]

_UINT32_FIELDS = ("ids",)


def _to_torch(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    elif device.type == "cpu" or not a.flags.writeable:
        a = np.array(a, copy=True)      # the tensor must not alias ``a``
    # a host array bound for the card is copied there by ``.to`` alone
    return torch.from_numpy(a).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``: on the CPU, ``.numpy()`` alone would share
    the tensor's memory, which later in-place applies change."""
    a = t.detach().cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = _host(t)
    return a.astype(np.uint32) if name in _UINT32_FIELDS else a


def state_from_numpy(tree, device="cuda") -> GraphState:
    device = resolve_device(device)
    s, vt, pool = tree.sort, tree.vt, tree.pool
    sort = SortState(tuple(_to_torch(p, device) for p in s.pools),
                     _to_torch(s.counts, device),
                     _to_torch(s.overflow, device))
    vt = VertexTable(**{f: _to_torch(getattr(vt, f), device)
                        for f in VertexTable._fields})
    pool = EdgePool(**{f: _to_torch(getattr(pool, f), device)
                       for f in EdgePool._fields})
    return GraphState(sort, vt, pool)


def state_to_numpy(state: GraphState) -> GraphState:
    """The port's state as a ``GraphState`` of numpy arrays (JAX dtypes)."""
    s = state.sort
    sort = SortState(tuple(_host(p) for p in s.pools), _host(s.counts),
                     _host(s.overflow))
    vt = VertexTable(**{f: _to_numpy(f, getattr(state.vt, f))
                        for f in VertexTable._fields})
    pool = EdgePool(**{f: _to_numpy(f, getattr(state.pool, f))
                       for f in EdgePool._fields})
    return GraphState(sort, vt, pool)


def snapshot_from_numpy(tree, device="cuda") -> GraphSnapshot:
    """A ``GraphSnapshot``-shaped tree of numpy arrays (the JAX package's
    snapshot after ``jax.tree.map(np.asarray, snap)``) as the port's
    ``GraphSnapshot`` on ``device``."""
    device = resolve_device(device)
    return GraphSnapshot(**{f: _to_torch(getattr(tree, f), device)
                            for f in GraphSnapshot._fields})


def snapshot_to_numpy(snap: GraphSnapshot) -> GraphSnapshot:
    """The port's snapshot as a ``GraphSnapshot`` of numpy arrays (JAX
    dtypes)."""
    return GraphSnapshot(**{f: _to_numpy(f, getattr(snap, f))
                            for f in GraphSnapshot._fields})


def _tensors(tree, device):
    """A numpy array, or a dict (nested) of them, as tensors on
    ``device``, dtypes kept (bfloat16 through its 16-bit patterns)."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        bits = np.array(a.view(np.uint16), copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _arrays(tree):
    """A tensor, or a dict (nested) of them, as numpy copies (bfloat16
    leaves as ``ml_dtypes.bfloat16``, the dtype JAX hands to numpy)."""
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        import ml_dtypes     # only where a bfloat16 leaf needs it
        return _host(tree.view(torch.int16)).view(ml_dtypes.bfloat16)
    return _host(tree)


def lm_params_from_numpy(tree, device="cuda"):
    """A dict (nested) of numpy arrays as the same dict of tensors on
    ``device``, each with its dtype."""
    return _tensors(tree, resolve_device(device))


def lm_params_to_numpy(params):
    """The port's LM params as a dict of numpy arrays (bfloat16 leaves as
    ``ml_dtypes.bfloat16``, the dtype JAX hands to numpy)."""
    return _arrays(params)


def train_state_from_numpy(state, device="cuda"):
    """A training state of numpy arrays (fields ``params``, ``opt_state``,
    ``step``) as the port's ``TrainState`` of tensors on ``device``: the
    params and the optimizer's dict (AdamW's ``m`` / ``v`` / ``count``,
    Adafactor's ``s`` / ``count``) leaf for leaf, dtypes kept; ``step``
    a 0-d int32 tensor."""
    from .train.step import TrainState
    device = resolve_device(device)
    return TrainState(params=_tensors(state.params, device),
                      opt_state=_tensors(dict(state.opt_state), device),
                      step=_tensors(np.asarray(state.step, np.int32), device))


def train_state_to_numpy(state):
    """The port's ``TrainState`` as the same ``TrainState`` of numpy arrays
    (bfloat16 leaves as ``ml_dtypes.bfloat16``)."""
    from .train.step import TrainState
    return TrainState(params=_arrays(state.params),
                      opt_state=_arrays(state.opt_state),
                      step=_arrays(state.step))
