"""Checkpoints of the port's training state (counterpart of
``repro.checkpoint.checkpoint``), in the JAX package's files: each
package restores what the other wrote.

* ``step_<N>/arrays.npz`` holds every leaf as a full array under its path
  (``repro_torch.tree``: ``params/embed``, ``opt_state/m/embed``,
  ``opt_state/count``, ``step``; ``/`` written as ``__``), and
  ``manifest.json`` the step, a user metadata dict (the data stream's
  state) and each leaf's shape and dtype string;
* atomic: written under ``step_<N>.tmp``, fsynced, then renamed;
* async: ``Checkpointer.save_async`` copies the tensors to the host, then
  writes on a worker thread while training goes on;
* keep-last-k GC and a SIGTERM hook (a synchronous save, then exit 0).

A bfloat16 leaf is stored as its 16-bit patterns (numpy has no bfloat16:
``np.savez`` writes JAX's ``ml_dtypes.bfloat16`` arrays as ``V2`` too) and
the manifest says ``bfloat16``; ``restore_checkpoint`` reads such a leaf
through its bits. The JAX package's own restore cannot (its
``arr.astype(tgt.dtype)`` has no cast from ``V2``: ROADMAP Queue 3).
Restored leaves take the target tree's dtypes and devices.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import signal
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..tree import flatten_with_path, tree_map, unflatten

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint",
           "latest_step"]

_SEP = "/"


def _host_array(leaf):
    """(numpy array as stored, its dtype string) of a tensor or array."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
            return bits.view("V2"), "bfloat16"
        return t.numpy(), str(t.dtype).split(".")[1]
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory, tree, step: int,
                    metadata: Optional[Dict] = None, keep: int = 3):
    """Synchronous atomic save of a tree of tensors (or numpy arrays)."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"step_{step}.tmp"
    final = d / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    arrays = {}
    manifest = {"step": int(step), "metadata": metadata or {},
                "leaves": {}}
    for path, leaf in flatten_with_path(tree):
        key = _SEP.join(path)
        arr, dtype = _host_array(leaf)
        arrays[key.replace("/", "__")] = arr
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    with open(tmp / "manifest.json", "rb+") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(d, keep)
    return str(final)


def _gc(d: pathlib.Path, keep: int):
    steps = sorted(int(m.group(1)) for p in d.iterdir()
                   if (m := re.fullmatch(r"step_(\d+)", p.name)))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(d / f"step_{s}", ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


def _leaf_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":      # 16-bit patterns, whatever numpy calls them
        bits = np.array(arr.view(np.uint16), copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def restore_checkpoint(directory, target_tree, step: Optional[int] = None):
    """Restore into the structure of ``target_tree`` (a tree of tensors):
    each leaf read by its path, checked against the manifest's shape, cast
    to the target leaf's dtype and placed on its device. ``step`` defaults
    to the latest. Returns (tree, step, metadata)."""
    d = pathlib.Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {d}")
    src = d / f"step_{step}"
    manifest = json.loads((src / "manifest.json").read_text())
    out = []
    with np.load(src / "arrays.npz") as data:
        for path, tgt in flatten_with_path(target_tree):
            p = _SEP.join(path)
            key = p.replace("/", "__")
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {p}")
            arr = data[key]
            want = manifest["leaves"][p]
            if list(arr.shape) != want["shape"]:
                raise ValueError(f"leaf {p}: shape {list(arr.shape)}, "
                                 f"manifest {want['shape']}")
            t = _leaf_tensor(arr, want["dtype"])
            out.append(t.to(device=tgt.device, dtype=tgt.dtype))
    return unflatten(target_tree, out), step, manifest["metadata"]


class Checkpointer:
    """Async checkpointer with a preemption (SIGTERM) hook."""

    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[Exception] = None

    def save_async(self, tree, step: int, metadata=None):
        """Copy ``tree`` to the host now, write it on a worker thread."""
        self.wait()
        host_tree = tree_map(
            lambda x: x.detach().to("cpu", copy=True) if torch.is_tensor(x)
            else np.array(x, copy=True), tree)

        def work():
            try:
                save_checkpoint(self.dir, host_tree, step, metadata,
                                self.keep)
            except Exception as e:  # noqa: BLE001  (re-raised by wait)
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise e

    def install_sigterm_hook(self, get_state):
        """On SIGTERM (preemption), synchronously checkpoint and exit 0."""
        def handler(signum, frame):
            tree, step = get_state()
            save_checkpoint(self.dir, tree, step,
                            {"preempted": True}, self.keep)
            os._exit(0)

        signal.signal(signal.SIGTERM, handler)
