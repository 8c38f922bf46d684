"""BFS frontier expansion over a flat edge array, on bitmaps.

``frontier_expand`` is the wrapper: on CUDA tensors it launches the kernel
of ``csrc/frontier.cu`` (port of the TPU kernel ``frontier_pallas``) or
raises; on CPU tensors it runs ``frontier_expand_plain``, a plain PyTorch
version of the oracle ``repro.kernels.ref.frontier_ref``.

Inputs: ``owner`` int32 (NB,) — the vertex offset whose edges block b
holds (-1 unused); ``dst`` int32 (NB, BS) destination offsets; ``valid``
bool (NB, BS); ``frontier_bits`` / ``visited_bits`` (W,) bitmaps over
vertex offsets. Output: the (W,) bitmap of destinations of valid entries
whose owner is in the frontier, minus the visited ones.

Bitmap words are int32 tensors holding the uint32 bit patterns of the JAX
package's bitmaps (torch's ``uint32`` lacks CUDA operators): bit ``v`` of
a bitmap is bit ``v % 32`` of word ``v // 32``. ``pack_bits`` and
``unpack_bits`` convert between ``bool[n]`` and words.
"""
from __future__ import annotations

import ctypes
import time

import torch

from ..core.tensor_ops import I32, I64, cdiv
from . import _build

__all__ = ["frontier_expand", "frontier_expand_plain", "pack_bits",
           "unpack_bits"]


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=I64, device=device)


def pack_bits(b: torch.Tensor, words: int | None = None) -> torch.Tensor:
    """bool[n] -> int32[words] bitmap (``words`` defaults to ceil(n/32);
    bits past ``n`` are 0). Words are built in int64 and wrapped to int32
    explicitly, so bit 31 lands as the sign bit."""
    n = b.shape[0]
    words = cdiv(n, 32) if words is None else words
    pad = torch.zeros((32 * words,), dtype=torch.bool, device=b.device)
    pad[:n] = b
    v = (pad.view(words, 32).to(I64) << _shifts(b.device)).sum(1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(I32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """int32[W] bitmap -> bool[n] (n <= 32 W). ``>>`` on a negative int32
    is arithmetic, so every shifted word is masked with ``& 1``."""
    bits = (words.to(I64)[:, None] >> _shifts(words.device)) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def frontier_expand_plain(owner, dst, valid, frontier_bits, visited_bits):
    """Plain PyTorch: mark a ``bool[32 W]`` hit vector at the masked
    destinations, then pack it and mask ``~visited``. Same rules as the
    oracle: owner clipped to [0, 32 W - 1], owner < 0 ignored, dst outside
    [0, 32 W) dropped."""
    W = frontier_bits.shape[0]
    N = 32 * W
    on = unpack_bits(frontier_bits, N)[owner.clamp(0, N - 1).to(I64)]
    on = on & (owner >= 0)
    m = valid & on[:, None] & (dst >= 0) & (dst < N)
    hit = torch.zeros((N + 1,), dtype=torch.bool, device=dst.device)
    hit.index_fill_(0, torch.where(m, dst, N).reshape(-1).to(I64), True)
    return pack_bits(hit[:N], W) & ~visited_bits


def _lib():
    fn = _build.load("frontier").frontier_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def frontier_expand(owner, dst, valid, frontier_bits, visited_bits):
    """Kernel wrapper: CUDA kernel on CUDA tensors, plain version on CPU
    tensors."""
    if not dst.is_cuda:
        return frontier_expand_plain(owner, dst, valid, frontier_bits,
                                     visited_bits)
    t0 = time.perf_counter_ns()
    dev = dst.device
    NB, BS = dst.shape
    W = frontier_bits.shape[0]
    what = "frontier_expand"
    _build.check_tensor(owner, (I32,), (NB,), "owner", dev, what)
    _build.check_tensor(dst, (I32,), (NB, BS), "dst", dev, what)
    _build.check_tensor(valid, (torch.bool,), (NB, BS), "valid", dev, what)
    _build.check_tensor(frontier_bits, (I32,), (W,), "frontier_bits", dev,
                        what)
    _build.check_tensor(visited_bits, (I32,), (W,), "visited_bits", dev,
                        what)
    if W == 0 or 32 * W >= 2 ** 31:
        raise ValueError(f"{what}: need 0 < W < 2^26 bitmap words, got {W}")
    out = torch.zeros((W,), dtype=I32, device=dev)
    _build.launch(what, _lib(), dev, (
        owner.data_ptr(), dst.data_ptr(), valid.data_ptr(),
        frontier_bits.data_ptr(), visited_bits.data_ptr(), out.data_ptr(),
        NB, BS, W), t0)
    return out
