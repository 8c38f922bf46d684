"""Mesh descriptions of the port (counterpart of ``repro.launch.mesh``).

A mesh here is a plain description, axis names and sizes over devices,
read by ``dist.sharding.spec_for``. The port places every tensor on one
device, so its local mesh is that one device (1 x 1: every spec
resolves to replicated, as on a 1-device JAX mesh). Importing this
module touches no device.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from .. import resolve_device

__all__ = ["LocalMesh", "make_local_mesh", "make_production_mesh"]


class LocalMesh(NamedTuple):
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]              # axis name -> size
    devices: Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        """The device that holds the port's tensors."""
        return self.devices[0]


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 chips per pod (a leading 2-pod axis with
    ``multi_pod``), as the JAX package's: the port runs on one card, so
    this raises with the count it would need."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = math.prod(shape)
    have = torch.cuda.device_count()
    raise RuntimeError(
        f"need {n} devices for the production mesh, have {have} — the "
        "port trains on one card (launch.train without --production-mesh)")


def make_local_mesh(device="cuda") -> LocalMesh:
    """Debug mesh over the one device the port runs on, ``("data",
    "model")`` of sizes 1 x 1 (the JAX package's spans ``jax.devices()``
    with a ``model_axis``; one device holds no model axis past 1). Raises
    without a card when ``device`` is a CUDA device."""
    return LocalMesh(("data", "model"), {"data": 1, "model": 1},
                     (resolve_device(device),))
