"""Fused SORT descent: (B, 2) [hi, lo] int64 keys -> int32 offsets.

``sort_lookup`` is the wrapper: on CUDA tensors it launches the kernel of
``csrc/sort_lookup.cu`` (port of the TPU kernel ``sort_lookup_pallas``) or
raises; on CPU tensors it runs ``sort_lookup_plain``, the layer-by-layer
gather of ``repro.core.sort.lookup`` (equal to the oracle
``repro.kernels.ref.sort_lookup_ref``).
"""
from __future__ import annotations

import ctypes
import time

import torch

from ..core.keys import extract_bits
from . import _build

__all__ = ["sort_lookup", "sort_lookup_plain", "MAX_LAYERS"]

MAX_LAYERS = 8


def sort_lookup_plain(pools, keys, *, fanout_bits, bit_offsets):
    B = keys.shape[0]
    node = torch.zeros((B,), dtype=torch.int32, device=keys.device)
    valid = torch.ones((B,), dtype=torch.bool, device=keys.device)
    for pool, a, boff in zip(pools, fanout_bits, bit_offsets):
        slot = node * (1 << a) + extract_bits(keys, boff, a)
        child = pool[slot.clamp(0, pool.shape[0] - 1).to(torch.int64)]
        child = torch.where(valid, child, -1)
        valid = child >= 0
        node = child.clamp_min(0)
    return torch.where(valid, node, -1)


def _lib():
    lib = _build.load("sort_lookup")
    fn = lib.sort_lookup_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), i, p]
        fn.restype = ctypes.c_int
    return fn


def sort_lookup(pools, keys, *, fanout_bits, bit_offsets):
    """Kernel wrapper: CUDA kernel on CUDA tensors, plain version on CPU
    tensors."""
    if not keys.is_cuda:
        return sort_lookup_plain(pools, keys, fanout_bits=fanout_bits,
                                 bit_offsets=bit_offsets)
    t0 = time.perf_counter_ns()
    dev = keys.device
    L = len(pools)
    if not 1 <= L <= MAX_LAYERS or len(fanout_bits) != L or \
            len(bit_offsets) != L:
        raise ValueError(f"sort_lookup: need 1..{MAX_LAYERS} layers with "
                         "one fan-out and bit offset each")
    _build.check_tensor(keys, (torch.int64,), (keys.shape[0], 2), "keys",
                        dev, "sort_lookup")
    for i, p in enumerate(pools):
        _build.check_tensor(p, (torch.int32,), (p.numel(),), f"pools[{i}]",
                            dev, "sort_lookup")
    B = keys.shape[0]
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * L)(*[p.data_ptr() for p in pools])
    sizes = (ctypes.c_longlong * L)(*[p.shape[0] for p in pools])
    bits = (ctypes.c_int * L)(*fanout_bits)
    offs = (ctypes.c_int * L)(*bit_offsets)
    _build.launch("sort_lookup", _lib(), dev, (
        keys.data_ptr(), out.data_ptr(), B, ptrs, sizes, bits, offs, L), t0)
    return out
