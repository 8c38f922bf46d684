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
:func:`constrain` and by ``models.lm.moe_apply`` (the all-to-all MoE
dispatch). On the port's own meshes (``launch.mesh.LocalMesh``, every
shard on one device) ``constrain`` returns its input: without a mesh as
JAX's does, and with one after resolving (and so checking) the
annotation. On the dry run's ``DeviceMesh`` (fake DTensors) it
redistributes a DTensor to the resolved placements, as JAX's
``with_sharding_constraint`` fixes a layout; :func:`placements_for` is
the converter from a spec tuple to DTensor placements.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, \
    Union

__all__ = ["ShardingRules", "TRAIN_RULES", "SERVE_RULES", "MOE_SERVE_RULES",
           "VARIANTS", "spec_for", "param_partition_specs", "set_rules",
           "constrain", "placements_for", "is_device_mesh", "mesh_sizes"]

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


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``LocalMesh`` or a ``DeviceMesh``, in the
    mesh's order."""
    if is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


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
    mesh_shape = mesh_sizes(mesh)
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


def is_device_mesh(mesh) -> bool:
    """True for a ``torch.distributed`` ``DeviceMesh`` (the dry run's),
    False for the port's ``LocalMesh`` descriptions."""
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def _spec_axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec: Sequence[MeshAxes], mesh) -> list:
    """DTensor placements (one per mesh dim) of a ``spec_for`` tuple on a
    ``DeviceMesh``: ``Shard(d)`` on every mesh dim that tensor dim ``d``
    names, ``Replicate()`` elsewhere. One tensor dim over several mesh
    axes, such as ``("pod", "data")``, splits in the order the axes are
    given, the first outermost, as a ``PartitionSpec`` does; DTensor
    splits in mesh-dim order, so the axes must come in the mesh's order
    (every rule table's do) and any other order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _spec_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"axes {axes} of dim {d} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in pos:
            out[i] = Shard(d)
    return out


def constrain(x, *axes: Optional[str]):
    """Inside a ``set_rules`` context with a mesh the annotation is
    resolved first (``spec_for``), so a malformed one raises as it would
    in JAX. On a ``LocalMesh`` (one device holds ``x`` whole) the result
    is ``x`` itself; a DTensor on the dry run's ``DeviceMesh`` is
    redistributed to the resolved placements."""
    if _ACTIVE and _ACTIVE[-1].mesh is not None:
        ctx = _ACTIVE[-1]
        spec = spec_for(x.shape, axes, ctx.rules, ctx.mesh)
        if is_device_mesh(ctx.mesh):
            from torch.distributed.tensor import DTensor
            if isinstance(x, DTensor):
                return x.redistribute(ctx.mesh,
                                      placements_for(spec, ctx.mesh))
    return x
