"""``repro_torch`` — the RadixGraph store ported to PyTorch and CUDA.

The package mirrors ``repro`` module by module (``core``, ``kernels``,
``api``) and imports neither JAX nor anything of the ``repro`` package.
Plain tensor code is PyTorch; the edge-pool append, the row compactors and
the SORT descent are CUDA kernels written for Hopper (``kernels/csrc``).

Every entry point and state factory takes an explicit ``device``. The
default is ``"cuda"``: without a card, a call with the default raises
instead of quietly building state on the CPU. Tests pass ``device="cpu"``, and on CPU
tensors each kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises when a CUDA device is
    asked for and PyTorch sees no card (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU")
    return dev
