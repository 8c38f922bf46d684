"""Batched ART insert: keys applied in batch order to an ``ArtState``.

``art_insert`` is the wrapper: on CUDA tensors it launches the kernel of
``csrc/art.cu`` (one launch for the whole batch) or raises; on CPU tensors
it runs ``art_insert_plain``, the per-key loop of ``lax.scan`` in
``repro.baselines.art._art_insert``. This is a port of a JAX function, not
of a TPU kernel: the JAX package has no Pallas kernel for it.

Both update the state's tensors IN PLACE (the tree's arrays are gigabytes
at LiveJournal scale, where JAX's functional scan returns new ones) and
return the state. Every ``.at[...].set(mode="drop")`` of the JAX function
that aims at row ``cap_s`` / ``cap_d`` or column 256 means "no write"; here
those writes are simply not made.
"""
from __future__ import annotations

import ctypes
import time

import torch

from . import _build

__all__ = ["art_insert", "art_insert_plain", "MAX_LAYERS", "SPARSE_CAP"]

MAX_LAYERS = 8
SPARSE_CAP = 16


def art_insert_plain(st, radix: torch.Tensor, offsets: torch.Tensor):
    """Insert ``radix`` (int32 (B, layers) radix bytes) -> ``offsets``
    (int32 (B,)) one key at a time, in batch order, exactly as the JAX
    scan: per layer a dense store (case A), a free sparse slot (case B),
    or a metamorphosis of a full sparse node into a dense row with its 16
    entries migrated (case C); node and dense-row overflows counted."""
    L = len(st.skeys)
    skeys, schild, dense_of, dchild = st.skeys, st.schild, st.dense_of, \
        st.dchild
    scount, dcount = st.scount.tolist(), st.dcount.tolist()
    overflow = int(st.overflow)
    for x, off in zip(radix.tolist(), offsets.tolist()):
        node, alive = 0, True
        for i in range(L):
            b = x[i]
            cap_s, cap_d = skeys[i].shape[0], dchild[i].shape[0]
            nc = min(max(node, 0), cap_s - 1)
            drow = int(dense_of[i][nc])
            is_dense = drow >= 0
            drc = min(max(drow, 0), cap_d - 1)
            sk = skeys[i][nc].tolist()
            has_s, has_free = b in sk, -1 in sk
            pos = sk.index(b) if has_s else 0
            fpos = sk.index(-1) if has_free else 0
            if is_dense:
                child = int(dchild[i][drc, b])
            else:
                child = int(schild[i][nc, pos]) if has_s else -1
            need = alive and child < 0
            if i == L - 1:
                new_child = off
            else:
                fits_s = scount[i + 1] < skeys[i + 1].shape[0]
                new_child = scount[i + 1] if fits_s else -1
                scount[i + 1] += int(need and fits_s)
                overflow += int(need and not fits_s)
                need = need and fits_s
            if need and is_dense:                       # case A
                dchild[i][drc, b] = new_child
            elif need and has_free:                     # case B
                skeys[i][nc, fpos] = b
                schild[i][nc, fpos] = new_child
            elif need:                                  # case C
                new_did = dcount[i]
                if new_did < cap_d:
                    row = schild[i][nc].tolist()
                    for j in range(SPARSE_CAP):
                        if sk[j] >= 0:
                            dchild[i][new_did, sk[j]] = row[j]
                    dchild[i][new_did, b] = new_child
                    dense_of[i][nc] = new_did
                    dcount[i] += 1
                else:
                    overflow += 1
            alive = alive and (new_child >= 0 if need else child >= 0)
            node = max(new_child if need else child, 0)
    st.scount.copy_(torch.tensor(scount, dtype=torch.int32))
    st.dcount.copy_(torch.tensor(dcount, dtype=torch.int32))
    st.overflow.fill_(overflow)
    return st


def _lib():
    lib = _build.load("art")
    fn = lib.art_insert_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        pp = ctypes.POINTER(ctypes.c_void_p)
        ll = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [pp, pp, pp, pp, ll, ll, i, p, p, ctypes.c_longlong,
                       p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def art_insert(st, radix: torch.Tensor, offsets: torch.Tensor):
    """Kernel wrapper: the CUDA kernel on CUDA tensors (one launch for the
    batch), the plain per-key loop on CPU tensors. Updates ``st`` in place
    and returns it."""
    if not radix.is_cuda:
        return art_insert_plain(st, radix, offsets)
    t0 = time.perf_counter_ns()
    dev = radix.device
    L = len(st.skeys)
    if not 1 <= L <= MAX_LAYERS or not (len(st.schild) == len(st.dense_of)
                                        == len(st.dchild) == L):
        raise ValueError(f"art_insert: need 1..{MAX_LAYERS} layers with "
                         "four arrays each")
    B = radix.shape[0]
    what = "art_insert"
    i32 = (torch.int32,)
    _build.check_tensor(radix, i32, (B, L), "radix", dev, what)
    _build.check_tensor(offsets, i32, (B,), "offsets", dev, what)
    _build.check_tensor(st.scount, i32, (L,), "scount", dev, what)
    _build.check_tensor(st.dcount, i32, (L,), "dcount", dev, what)
    _build.check_tensor(st.overflow, i32, (), "overflow", dev, what)
    for i in range(L):
        cs, cd = st.skeys[i].shape[0], st.dchild[i].shape[0]
        _build.check_tensor(st.skeys[i], i32, (cs, SPARSE_CAP),
                            f"skeys[{i}]", dev, what)
        _build.check_tensor(st.schild[i], i32, (cs, SPARSE_CAP),
                            f"schild[{i}]", dev, what)
        _build.check_tensor(st.dense_of[i], i32, (cs,), f"dense_of[{i}]",
                            dev, what)
        _build.check_tensor(st.dchild[i], i32, (cd, 256), f"dchild[{i}]",
                            dev, what)

    def ptrs(ts):
        return (ctypes.c_void_p * L)(*[t.data_ptr() for t in ts])

    cap_s = (ctypes.c_longlong * L)(*[t.shape[0] for t in st.skeys])
    cap_d = (ctypes.c_longlong * L)(*[t.shape[0] for t in st.dchild])
    if B:
        _build.launch(what, _lib(), dev, (
            ptrs(st.skeys), ptrs(st.schild), ptrs(st.dense_of),
            ptrs(st.dchild), cap_s, cap_d, L, radix.data_ptr(),
            offsets.data_ptr(), B, st.scount.data_ptr(),
            st.dcount.data_ptr(), st.overflow.data_ptr()), t0)
    return st
