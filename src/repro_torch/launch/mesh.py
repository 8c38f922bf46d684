"""Mesh descriptions of the port (counterpart of ``repro.launch.mesh``).

Two kinds of mesh:

* :class:`LocalMesh`, a plain description (axis names and sizes) over
  the one device the port runs on, read by ``dist.sharding.spec_for``.
  Its default is 1 x 1: every spec resolves to replicated, as on a
  1-device JAX mesh. Axes past 1 (an expert mesh of 8: ``data=8``) are
  *stacked*: the one device holds every shard, and a mesh program
  (``models.moe_a2a``) lays the shards on a leading axis of its tensors,
  as ``dist.graph_engine`` does; a collective is then a transpose or a
  sum over that axis.
* :func:`make_placeholder_mesh`, the production mesh of the dry run
  (``launch.dryrun``): a ``torch.distributed`` ``DeviceMesh`` of 16 x 16
  (``data``, ``model``) or 2 x 16 x 16 (``pod`` first) over a fake
  process group in this one process. Nothing is sent anywhere: tensors
  on it are fake DTensors, and a collective is a record
  (``launch.costs``).

Importing this module touches no device and starts no process group.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import resolve_device

__all__ = ["LocalMesh", "make_local_mesh", "make_production_mesh",
           "make_placeholder_mesh", "PRODUCTION_SHAPES"]

# (axis names, sizes) of the JAX package's production meshes
PRODUCTION_SHAPES = {
    "single": (("data", "model"), (16, 16)),
    "multi": (("pod", "data", "model"), (2, 16, 16)),
}


class LocalMesh(NamedTuple):
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]              # axis name -> size
    devices: Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        """The device that holds the port's tensors (every shard)."""
        return self.devices[0]


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 chips per pod (a leading 2-pod axis with
    ``multi_pod``), as the JAX package's: the port runs on one card, so
    this raises with the count it would need (the dry run's placeholder
    mesh is :func:`make_placeholder_mesh`)."""
    n = math.prod(PRODUCTION_SHAPES["multi" if multi_pod else "single"][1])
    have = torch.cuda.device_count()
    raise RuntimeError(
        f"need {n} devices for the production mesh, have {have} — the "
        "port trains on one card (launch.train without --production-mesh)")


def make_local_mesh(device="cuda", *, data: int = 1, model: int = 1,
                    pod: Optional[int] = None) -> LocalMesh:
    """A mesh over the one device the port runs on: ``("data", "model")``
    (``("pod", "data", "model")`` with ``pod``), 1 x 1 by default. Larger
    sizes stack that many shards on the device (an expert mesh of 8 for
    ``MOE_SERVE_RULES``: ``data=8``). Raises without a card when
    ``device`` is a CUDA device."""
    names = ("data", "model") if pod is None else ("pod", "data", "model")
    sizes = (data, model) if pod is None else (pod, data, model)
    if min(sizes) < 1:
        raise ValueError(f"mesh sizes must be positive: {sizes}")
    return LocalMesh(names, dict(zip(names, sizes)),
                     (resolve_device(device),))


def fake_world(n: int):
    """A fake ``torch.distributed`` process group of ``n`` ranks in this
    process (rank 0), replacing any fake group of another size. A
    collective on it sends nothing. The group is global to the process:
    callers run the dry run in a process of its own."""
    import torch.distributed as dist
    # registers the "fake" backend (c10d's FakeProcessGroup)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised; the "
                               "dry run needs a process of its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)


def make_placeholder_mesh(multi_pod: bool = False,
                          shape: Optional[Sequence[int]] = None,
                          axes: Optional[Sequence[str]] = None):
    """The dry run's mesh: a ``DeviceMesh`` over a fake process group of
    placeholder ranks, 16 x 16 ``("data", "model")`` or, with
    ``multi_pod``, 2 x 16 x 16 ``("pod", "data", "model")``, as
    ``repro.launch.mesh.make_production_mesh`` lays them out (row-major
    over the ranks). ``shape`` / ``axes`` give another layout (a 1 x 1
    mesh for a one-card cell). Starts the fake group (:func:`fake_world`)."""
    from torch.distributed.device_mesh import init_device_mesh
    names, sizes = PRODUCTION_SHAPES["multi" if multi_pod else "single"]
    if shape is not None:
        sizes = tuple(shape)
        names = tuple(axes) if axes is not None else names[-len(sizes):]
    fake_world(math.prod(sizes))
    return init_device_mesh("cpu", tuple(sizes), mesh_dim_names=names)
