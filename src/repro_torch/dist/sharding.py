"""Rule-based partition planner of the port (counterpart of
``repro.dist.sharding``): the same rule tables and resolution.

Model code annotates every tensor dim with a *logical* axis name ("fsdp",
"tp", "batch", ...); a :class:`ShardingRules` table maps logical names to
mesh axes. :func:`spec_for` resolves one tensor's annotation against a
mesh (anything with a ``shape`` mapping of axis name -> size, such as
``launch.mesh.LocalMesh``) into a tuple of entries, one a dim, each None,
a mesh axis name or a tuple of names: the port's stand-in for JAX's
``PartitionSpec``. Two safety rails, as in JAX:

* **divisibility fallback**: a dim not divisible by the product of its
  candidate mesh-axis sizes is replicated;
* **no mesh axis twice**: within one tensor a mesh axis consumed by an
  earlier dim is dropped from later candidates.

``set_rules`` pushes an active (rules, mesh) context read by
:func:`constrain`. The port holds every tensor whole on one device, so
``constrain`` returns its input: without a mesh as JAX's does, and with
one after resolving (and so checking) the annotation.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, \
    Union

__all__ = ["ShardingRules", "TRAIN_RULES", "SERVE_RULES", "MOE_SERVE_RULES",
           "VARIANTS", "spec_for", "param_partition_specs", "set_rules",
           "constrain"]

MeshAxes = Union[None, str, Tuple[str, ...]]


class ShardingRules(dict):
    """logical axis name -> mesh axis name | tuple of names | None."""


# Training: ZeRO/FSDP over the (pod, data) axes + Megatron TP over "model".
TRAIN_RULES = ShardingRules({
    "layers": None,          # stacked-layer dim, never sharded
    "unit": None,            # hybrid block-pattern dim
    "embed": None,           # norm scales et al. — replicated
    "batch": ("pod", "data"),
    "act_seq": None,         # activation sequence dim
    "cache_seq": None,       # KV-cache sequence dim
    "fsdp": ("pod", "data"),
    "tp": "model",
    "tp_in": "model",        # second TP dim of square weights -> dropped
    "kv_tp": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": None,         # dense MoE dispatch under FSDP training
})

# Serving: weights replicated over the batch axes, pure TP over "model".
SERVE_RULES = ShardingRules({**TRAIN_RULES, "fsdp": None})

# MoE serving: expert parallelism over the batch axes.
MOE_SERVE_RULES = ShardingRules({**SERVE_RULES, "experts": ("pod", "data")})

# Named planner / config deltas for ablations: (rule overrides,
# ModelConfig overrides).
VARIANTS: Dict[str, Tuple[Dict[str, MeshAxes], Dict[str, Any]]] = {
    "baseline": ({}, {}),
    "no_fsdp": ({"fsdp": None}, {}),
    "no_tp": ({"tp": None, "tp_in": None, "kv_tp": None, "heads": None,
               "kv_heads": None, "vocab": None}, {}),
    "expert_parallel": ({"fsdp": None, "experts": ("pod", "data")}, {}),
    "seq_parallel": ({"act_seq": "model"}, {}),
    "no_remat": ({}, {"remat": False}),
}


def _candidate_axes(entry: MeshAxes, mesh_shape, used) -> Tuple[str, ...]:
    if entry is None:
        return ()
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(a for a in axes if a in mesh_shape and a not in used)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: ShardingRules, mesh) -> Tuple[MeshAxes, ...]:
    """Resolve one tensor's logical annotation into a spec tuple.

    ``axes`` is parallel to ``shape`` (None entries are replicated; dims
    past the shorter of the two are left out, as JAX's ``zip``).
    Resolution is left to right; each rule entry is applied all or
    nothing after filtering to the axes present in the mesh."""
    mesh_shape = dict(mesh.shape)
    used: set = set()
    entries: List[MeshAxes] = []
    for dim, name in zip(shape, axes):
        entry: MeshAxes = None
        if name is not None:
            cand = _candidate_axes(rules.get(name), mesh_shape, used)
            if cand:
                n = math.prod(mesh_shape[a] for a in cand)
                if n > 0 and dim % n == 0:
                    used.update(cand)
                    entry = cand[0] if len(cand) == 1 else cand
        entries.append(entry)
    return tuple(entries)


def param_partition_specs(shapes, logical, rules: ShardingRules, mesh):
    """Map parallel (param shapes, logical annotations) trees to a tree of
    spec tuples. ``shapes`` leaves have a ``shape`` (tensors, meta
    tensors); ``logical`` mirrors the containers with axis-name tuples at
    the leaf positions."""
    def rec(s, lg):
        if hasattr(s, "shape"):
            return spec_for(s.shape, tuple(lg), rules, mesh)
        if isinstance(s, dict):
            return {k: rec(v, lg[k]) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            out = [rec(a, b) for a, b in zip(s, lg)]
            return type(s)(out) if not hasattr(s, "_fields") \
                else type(s)(*out)
        raise TypeError(f"unsupported params node: {type(s)!r}")
    return rec(shapes, logical)


class _RulesContext(NamedTuple):
    rules: ShardingRules
    mesh: Any


_ACTIVE: List[_RulesContext] = []


@contextlib.contextmanager
def set_rules(rules: ShardingRules, mesh=None):
    """Activate (rules, mesh) for ``constrain``."""
    ctx = _RulesContext(ShardingRules(rules), mesh)
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def constrain(x, *axes: Optional[str]):
    """``x`` itself. Inside a ``set_rules`` context with a mesh the
    annotation is resolved first (``spec_for``), so a malformed one
    raises as it would in JAX; one device holds ``x`` whole."""
    if _ACTIVE and _ACTIVE[-1].mesh is not None:
        ctx = _ACTIVE[-1]
        spec_for(x.shape, axes, ctx.rules, ctx.mesh)
    return x
