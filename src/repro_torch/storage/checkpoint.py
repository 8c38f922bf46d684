"""Epoch-consistent graph checkpoints: full and incremental (block-row).

Port of ``repro.storage.checkpoint``, in the same on-disk format: a
directory written by either package restores in the other. Member names
(``sort/pools/0``, ``vt/ids``, ``pool/ts``, ...), their order, their
dtypes (the JAX package's: ``vt/ids`` is uint32 on disk, int64 in the
port) and so every ``.npy`` file and CRC come out byte-identical for the
same state.

A checkpoint serializes ONE captured functional state — pool arrays,
vertex table, radix-sort index, MVCC scalars — plus the host counters a
restored process resumes with. Every array member carries a CRC32 of its
bytes in the manifest, so corruption is detected at restore, never
silently replayed over.

**Incremental checkpoints** reuse the touched-row argument the
epoch-delta extractor is built on: between two states with an equal
``pool.defrags`` counter, block extents never move and all content
writes land inside the current extents of rows whose vertex-table
signature (``size``/``cap``/``start_block``/``deg``) changed, or inside
blocks holding entries stamped ``ts >= base_clock``. A delta checkpoint
therefore stores the small leaves in full (vertex table, sort index,
scalars) and only the TOUCHED BLOCK ROWS of the three big pool arrays
(``dst``/``weight``/``ts``), scattered over the base chain at restore.
Any defrag since the base (``defrags`` differs — the manifest records
the counter), any overflow, or a touched fraction above
``max_delta_frac`` falls back to a full checkpoint.

Atomicity: members are written into ``ckpt_<id>.tmp``, each fsynced,
the manifest LAST, then the directory is renamed into place and the
parent fsynced — a crash mid-checkpoint leaves a ``.tmp`` orphan that
recovery ignores.

The host side is numpy: the state is copied to the host once
(``convert.state_to_numpy``), scanned, checksummed and written there;
a restore builds the state on the store's device from the host leaves.
``timings=`` (a dict, optional) receives the ms of each part: ``d2h``,
``scan``, ``crc`` and ``write`` (``np.save`` + fsync) on save; ``read``,
``crc`` and ``h2d`` on restore.

Layout::

    <dir>/ckpt_00000007/manifest.json
                        sort__pools__0.npy ... pool__owner.npy
                        delta__blocks.npy  delta__pool__dst.npy ...
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..convert import state_to_numpy
from ..core.radixgraph import GraphState
from ..core.status import Reason

__all__ = ["CheckpointError", "save_graph_checkpoint",
           "restore_graph_checkpoint", "resolve_checkpoint",
           "checkpoint_ids", "latest_recoverable", "flatten_named",
           "unflatten_named"]

FORMAT = "radixgraph-checkpoint"
VERSION = 1
_BIG = ("pool/dst", "pool/weight", "pool/ts")   # block-row delta members


class CheckpointError(RuntimeError):
    """Restore-side failure, typed by a ``core.status.Reason`` code."""

    def __init__(self, code: Reason, detail: str = ""):
        self.code = code
        super().__init__(f"{code}: {detail}" if detail else str(code))


def _tick(timings: Optional[dict], part: str, t0: float) -> float:
    """Add the ms since ``t0`` to ``timings[part]``; returns the clock."""
    now = time.perf_counter()
    if timings is not None:
        timings[part] = timings.get(part, 0.0) + (now - t0) * 1e3
    return now


# ---- GraphState <-> named leaves ----

def flatten_named(tree) -> List[Tuple[str, object]]:
    """``(name, leaf)`` of a ``GraphState`` (NamedTuples and tuples), in
    field order, named by path as the JAX package's
    ``tree_flatten_with_path`` names them: ``sort/pools/0``, ``vt/ids``,
    ``pool/ts``."""
    out = []

    def walk(prefix, node):
        if isinstance(node, tuple):
            keys = node._fields if hasattr(node, "_fields") \
                else range(len(node))
            for k, v in zip(keys, node):
                walk(f"{prefix}{k}/", v)
        else:
            out.append((prefix[:-1], node))
    walk("", tree)
    return out


def unflatten_named(leaves: Dict[str, object], template: GraphState
                    ) -> GraphState:
    """A ``GraphState`` shaped like ``template`` whose leaves are
    ``leaves[name]``."""
    def node(prefix, t):
        if isinstance(t, tuple):
            keys = t._fields if hasattr(t, "_fields") else range(len(t))
            vals = [node(f"{prefix}{k}/", v) for k, v in zip(keys, t)]
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        return leaves[prefix[:-1]]
    return node("", template)


def _fname(name: str) -> str:
    return name.replace("/", "__") + ".npy"


def _crc(arr: np.ndarray) -> int:
    """CRC32 of the array's bytes in C order (the JAX package's
    ``crc32(arr.tobytes())``), read in place rather than copied."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


# ---- directory bookkeeping ----

def checkpoint_ids(directory) -> List[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return []
    ids = []
    for p in d.glob("ckpt_*"):
        if p.suffix == ".tmp" or not p.is_dir():
            continue
        try:
            ids.append(int(p.name.split("_", 1)[1]))
        except ValueError:
            continue
    return sorted(ids)


def _dir_of(directory, ckpt_id: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"ckpt_{ckpt_id:08d}"


def _read_manifest(directory, ckpt_id: int) -> dict:
    p = _dir_of(directory, ckpt_id) / "manifest.json"
    try:
        man = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(Reason.CKPT_BAD_MANIFEST,
                              f"ckpt {ckpt_id}: {e}")
    if man.get("format") != FORMAT or man.get("version") != VERSION:
        raise CheckpointError(Reason.CKPT_BAD_MANIFEST,
                              f"ckpt {ckpt_id}: wrong format/version")
    return man


def _load_member(ckpt_dir: pathlib.Path, name: str, entry: dict,
                 timings: Optional[dict] = None) -> np.ndarray:
    path = ckpt_dir / entry["file"]
    t0 = time.perf_counter()
    try:
        arr = np.load(path)
    except Exception as e:   # missing file, chopped .npy header, ...
        raise CheckpointError(Reason.CKPT_BAD_CRC, f"{name}: {e}")
    t0 = _tick(timings, "read", t0)
    if list(arr.shape) != entry["shape"] or str(arr.dtype) != entry["dtype"]:
        raise CheckpointError(Reason.CKPT_BAD_CRC,
                              f"{name}: shape/dtype mismatch")
    crc = _crc(arr)
    _tick(timings, "crc", t0)
    if crc != entry["crc32"]:
        raise CheckpointError(Reason.CKPT_BAD_CRC, f"{name}: CRC mismatch")
    return arr


# ---- incremental block-row selection ----

def _pool3(a: np.ndarray, bs: Optional[int] = None) -> np.ndarray:
    """Normalize to a leading shard dim: (S, n_blocks[, bs])."""
    want = 2 if bs is None else 3
    return a if a.ndim == want else a[None]


def _touched_blocks(host: Dict[str, np.ndarray], base_small: dict,
                    base_clock: np.ndarray) -> np.ndarray:
    """Flat indices (into the shard-flattened block axis) of every block
    row whose content MAY differ from the base checkpoint — the
    epoch-delta touched-row argument applied to storage:

    * blocks holding an entry stamped at/after the base clock (fresh
      appends; per-vertex compaction preserves entry timestamps, so a
      moved window write still flags its new block);
    * the full current extent of every row whose vt signature changed
      (compaction relocates whole extents; the vacated blocks keep their
      old bytes and need no rewrite);
    * the full extent of rows allocated since the base.
    """
    ts = _pool3(host["pool/ts"], bs=0)
    owner = _pool3(host["pool/owner"])
    S, nb, bs = ts.shape
    size = _pool3(host["vt/size"])
    cap = _pool3(host["vt/cap"])
    start = _pool3(host["vt/start_block"])
    deg = _pool3(host["vt/deg"])
    nrows = np.asarray(host["vt/num_rows"]).reshape(-1)
    touched = np.zeros((S, nb), bool)
    for s in range(S):
        touched[s] = (ts[s] >= base_clock[s]).any(axis=1) & (owner[s] >= 0)
        bn = int(base_small["num_rows"][s])
        n_cap = size.shape[1]
        rowmask = np.zeros((n_cap,), bool)
        for cur, prev in ((size, "size"), (cap, "cap"),
                          (start, "start_block"), (deg, "deg")):
            rowmask[:bn] |= cur[s][:bn] != base_small[prev][s][:bn]
        rowmask[bn:int(nrows[s])] = True
        rowmask &= (cap[s] > 0) & (start[s] >= 0)
        rows = np.nonzero(rowmask)[0]
        if len(rows):
            starts = start[s][rows].astype(np.int64)
            counts = -(-cap[s][rows].astype(np.int64) // bs)
            reps = np.repeat(starts, counts)
            offs = np.arange(len(reps)) - np.repeat(
                np.cumsum(counts) - counts, counts)
            idx = reps + offs
            touched[s][idx[(idx >= 0) & (idx < nb)]] = True
    return np.nonzero(touched.reshape(-1))[0].astype(np.int64)


def _base_small(directory, base_man: dict) -> dict:
    """The base checkpoint's vt signature arrays (always stored in full,
    even in delta checkpoints) shaped (S, ...)."""
    d = _dir_of(directory, base_man["ckpt_id"])
    out = {}
    for name in ("size", "cap", "start_block", "deg", "num_rows"):
        key = f"vt/{name}"
        arr = _load_member(d, key, base_man["arrays"][key])
        out[name] = _pool3(arr) if name != "num_rows" \
            else np.asarray(arr).reshape(-1)
    return out


# ---- saving ----

def save_graph_checkpoint(directory, store, *, incremental: bool = True,
                          wal_seq: int = -1, keep: int = 2,
                          max_delta_frac: float = 0.5,
                          timings: Optional[dict] = None) -> dict:
    """Checkpoint ``store``'s live state under ``directory``; returns the
    manifest. ``incremental=True`` writes a block-row delta against the
    latest existing checkpoint whenever the row-identity guards hold.
    ``keep``: full chains retained by GC (older dirs are deleted after a
    successful save). ``wal_seq``: last WAL record covered — recovery
    replays strictly newer records. ``timings``: see the module
    docstring."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    state, meta = store.durable_state()
    named = flatten_named(state_to_numpy(state))
    host = dict(named)
    t0 = _tick(timings, "d2h", t0)
    S = getattr(store, "n_shards", 1)
    clock = np.asarray(host["pool/clock"]).reshape(-1).tolist()
    defrags = np.asarray(host["pool/defrags"]).reshape(-1).tolist()
    overflow = [int(np.asarray(host[k]).sum()) for k in
                ("sort/overflow", "vt/overflow", "pool/overflow")]

    ids = checkpoint_ids(directory)
    ckpt_id = (ids[-1] + 1) if ids else 0
    kind, base_id, blocks, why_full = "full", None, None, "no-base"
    if incremental and ids:
        try:
            base_man = _read_manifest(directory, ids[-1])
            if base_man["n_shards"] != S:
                why_full = "shard-mismatch"
            elif base_man["defrags"] != defrags:
                why_full = Reason.DEFRAG.value
            elif base_man["overflow"] != overflow:
                why_full = Reason.OVERFLOW.value
            else:
                blocks = _touched_blocks(
                    host, _base_small(directory, base_man),
                    np.asarray(base_man["clock"]))
                nb_total = int(np.prod(_pool3(host["pool/owner"]).shape))
                if len(blocks) > max_delta_frac * nb_total:
                    blocks, why_full = None, Reason.DELTA_TOO_LARGE.value
                else:
                    kind, base_id, why_full = "delta", ids[-1], ""
        except CheckpointError as e:
            blocks, why_full = None, str(e.code)
    _tick(timings, "scan", t0)

    tmp = directory / f"ckpt_{ckpt_id:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    def _write(name: str, arr: np.ndarray) -> dict:
        fn = _fname(name)
        t = time.perf_counter()
        with open(tmp / fn, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        t = _tick(timings, "write", t)
        crc = _crc(arr)
        _tick(timings, "crc", t)
        return dict(file=fn, shape=list(arr.shape), dtype=str(arr.dtype),
                    crc32=crc)

    arrays, delta = {}, None
    if kind == "full":
        for name, _ in named:
            arrays[name] = _write(name, host[name])
        bytes_written = sum(host[n].nbytes for n in arrays)
    else:
        for name, _ in named:
            if name not in _BIG:
                arrays[name] = _write(name, host[name])
        d_arrays = {"delta/blocks": _write("delta/blocks", blocks)}
        bs = _pool3(host["pool/ts"], bs=0).shape[-1]
        for name in _BIG:
            t = time.perf_counter()
            rows = _pool3(host[name], bs=0).reshape(-1, bs)[blocks]
            _tick(timings, "scan", t)
            d_arrays[f"delta/{name}"] = _write(f"delta/{name}", rows)
        delta = dict(n_blocks=int(len(blocks)),
                     arrays={f"delta/{n}": d_arrays[f"delta/{n}"]
                             for n in _BIG},
                     blocks=d_arrays["delta/blocks"])
        bytes_written = sum(host[n].nbytes for n in arrays) + \
            blocks.nbytes + sum(
                int(np.prod(e["shape"])) * np.dtype(e["dtype"]).itemsize
                for e in delta["arrays"].values())

    manifest = dict(
        format=FORMAT, version=VERSION, ckpt_id=ckpt_id, kind=kind,
        base=base_id, backend=getattr(store, "backend", "?"), n_shards=S,
        wal_seq=int(wal_seq), clock=clock, defrags=defrags,
        overflow=overflow, meta=meta, arrays=arrays, delta=delta,
        why_full=why_full, bytes=int(bytes_written))
    t0 = time.perf_counter()
    mpath = tmp / "manifest.json"
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    final = _dir_of(directory, ckpt_id)
    os.rename(tmp, final)
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    _gc(directory, keep)
    _tick(timings, "write", t0)
    return manifest


def _gc(directory, keep: int):
    """Retain the last ``keep`` FULL checkpoints and every delta chained
    on them; delete older dirs (a delta's base is always newer-or-equal
    to the previous full, so this never orphans a chain)."""
    if keep <= 0:
        return
    fulls = []
    for i in checkpoint_ids(directory):
        try:
            if _read_manifest(directory, i)["kind"] == "full":
                fulls.append(i)
        except CheckpointError:
            continue
    if len(fulls) <= keep:
        return
    cutoff = fulls[-keep]
    for i in checkpoint_ids(directory):
        if i < cutoff:
            shutil.rmtree(_dir_of(directory, i), ignore_errors=True)


# ---- loading ----

def resolve_checkpoint(directory, ckpt_id: int, _depth: int = 0, *,
                       timings: Optional[dict] = None
                       ) -> Tuple[Dict[str, np.ndarray], dict]:
    """Load checkpoint ``ckpt_id``, resolving its delta chain. Returns
    ``(named host leaves, manifest)``; raises ``CheckpointError`` on any
    CRC / chain / manifest failure."""
    if _depth > 64:
        raise CheckpointError(Reason.CKPT_BAD_CHAIN, "chain too deep")
    man = _read_manifest(directory, ckpt_id)
    d = _dir_of(directory, ckpt_id)
    leaves = {name: _load_member(d, name, entry, timings)
              for name, entry in man["arrays"].items()}
    if man["kind"] == "delta":
        if man["base"] is None:
            raise CheckpointError(Reason.CKPT_BAD_CHAIN,
                                  f"ckpt {ckpt_id}: delta without base")
        try:
            base_leaves, _ = resolve_checkpoint(directory, man["base"],
                                                _depth + 1, timings=timings)
        except CheckpointError as e:
            raise CheckpointError(
                Reason.CKPT_BAD_CHAIN,
                f"ckpt {ckpt_id}: base {man['base']} unrecoverable "
                f"({e.code})") from e
        blocks = _load_member(d, "delta/blocks", man["delta"]["blocks"],
                              timings)
        for name in _BIG:
            rows = _load_member(d, f"delta/{name}",
                                man["delta"]["arrays"][f"delta/{name}"],
                                timings)
            t0 = time.perf_counter()
            big = base_leaves[name]     # freshly loaded: patched in place
            flat = big.reshape(-1, big.shape[-1])
            flat[blocks] = rows
            leaves[name] = flat.reshape(big.shape)
            _tick(timings, "read", t0)
    return leaves, man


def latest_recoverable(directory, *, timings: Optional[dict] = None
                       ) -> Optional[Tuple[Dict[str, np.ndarray], dict]]:
    """Newest checkpoint whose whole chain validates; None when nothing
    under ``directory`` is recoverable (corrupt members are skipped, not
    fatal — recovery falls back to older checkpoints, then to a bare WAL
    replay)."""
    for i in reversed(checkpoint_ids(directory)):
        try:
            return resolve_checkpoint(directory, i, timings=timings)
        except CheckpointError:
            continue
    return None


def install_checkpoint(store, leaves: Dict[str, np.ndarray], man: dict,
                       timings: Optional[dict] = None):
    """Install resolved host leaves into ``store`` (same spec): every
    member of the store's state must be present at the store's shape; the
    store builds the state on its own device (``load_durable_state``)."""
    template, _ = store.durable_state()
    for name, leaf in flatten_named(template):
        if name not in leaves:
            raise CheckpointError(Reason.CKPT_BAD_MANIFEST,
                                  f"member {name} missing")
        arr = leaves[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise CheckpointError(
                Reason.CKPT_BAD_MANIFEST,
                f"member {name}: checkpoint shape {arr.shape} vs store "
                f"{tuple(leaf.shape)} — mismatched store spec")
    t0 = time.perf_counter()
    store.load_durable_state(unflatten_named(leaves, template),
                             man.get("meta", {}))
    _tick(timings, "h2d", t0)


def restore_graph_checkpoint(directory, store,
                             ckpt_id: Optional[int] = None, *,
                             timings: Optional[dict] = None) -> dict:
    """Install a checkpointed state into ``store`` (same spec); returns
    the manifest restored from. ``ckpt_id=None`` picks the newest fully
    valid chain."""
    if ckpt_id is not None:
        leaves, man = resolve_checkpoint(directory, ckpt_id,
                                         timings=timings)
    else:
        hit = latest_recoverable(directory, timings=timings)
        if hit is None:
            raise CheckpointError(Reason.CKPT_MISSING,
                                  f"no recoverable checkpoint in "
                                  f"{directory}")
        leaves, man = hit
    install_checkpoint(store, leaves, man, timings)
    return man
