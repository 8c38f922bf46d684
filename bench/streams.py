"""Traffic generation: vertex IDs, endpoint laws and the op stream of a cell.

Everything is made from the run's ``--seed`` in a few large calls: the
endpoints and weights by a ``torch.Generator`` on the run's device, the
IDs by NumPy. The streams are then handed, as NumPy arrays on the host,
identically to the store and to the reference. A traffic mix is a
data file ``traffic/<mix>.json`` of parameters that names its generator,
``generators/<name>.py``; a configuration names its endpoint law,
``laws/<name>.py``. A new mix of an existing generator is a new data file
alone; a new generator or law is a new file, found by its name. A
generator makes a ``Mix``: the timed stream of one cycle, what every new
store is preloaded with, and whether a cycle ends with a new store.

The endpoint law is the one ``chip_smoke.powerlaw_stream`` used (the
probability of rank ``r`` proportional to ``r ** -exponent``, the rank
being the vertex index), drawn by ``laws/powerlaw.py`` by inverse CDF
instead of ``Generator.choice(p=...)``; IDs are a keyed bijection of the index on
32-bit words instead of a draw without replacement.
"""
from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .spec import HERE, load_module

__all__ = ["Stream", "Mix", "seed_sequence", "id_mix", "vertex_ids",
           "generator", "endpoints", "make_mix"]

_M32 = np.uint64(0xFFFFFFFF)


def seed_sequence(seed: int, *tag: int) -> np.random.SeedSequence:
    """A SeedSequence for any whole ``seed`` (negative or past 64 bits
    included), split by ``tag``."""
    words = []
    s = abs(int(seed))
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return np.random.SeedSequence([int(seed < 0), *words, *tag])


def id_mix(index: np.ndarray, seed: int) -> np.ndarray:
    """A keyed bijection of 32-bit words: xor, odd multiply, xor-shift and
    add, each a bijection on [0, 2^32). Distinct indices give distinct
    IDs. Returns uint64 values below 2^32."""
    k = seed_sequence(seed, 1).generate_state(6, np.uint32).astype(np.uint64)
    m1, m2 = k[0] | np.uint64(1), k[1] | np.uint64(1)
    x = np.asarray(index, np.uint64) & _M32
    x ^= k[2]
    x = (x * m1) & _M32
    x ^= x >> np.uint64(16)
    x = (x * m2) & _M32
    x ^= x >> np.uint64(13)
    x = (x + k[3]) & _M32
    x ^= x >> np.uint64(16)
    x = (x * (k[4] | np.uint64(1))) & _M32
    return x ^ (x >> np.uint64(15))


def vertex_ids(n: int, seed: int) -> np.ndarray:
    """The ``n`` distinct vertex IDs of a run: ``id_mix(arange(n))``."""
    return id_mix(np.arange(n, dtype=np.uint64), seed)


def generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from any whole ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed_sequence(seed, 2).generate_state(1, np.uint64)[0]))
    return g


def endpoints(g, law: dict, n_vertices: int, size: int,
              here: pathlib.Path = HERE) -> np.ndarray:
    """``size`` vertex indices drawn with generator ``g`` by the law
    ``law`` ({"law": name, **params}): ``laws/<name>.py``, whose
    ``draw(g, n_vertices, size, **params)`` gives int32 indices on
    ``g``'s device."""
    params = {k: v for k, v in law.items() if k != "law"}
    draw = load_module("laws", law["law"], here).draw
    return draw(g, n_vertices, size, **params).cpu().numpy()


@dataclass
class Stream:
    """Ops in order: endpoint indices into ``ids`` and weights (``w == 0``
    is a tombstone), with the IDs gathered."""

    ids: np.ndarray        # uint64[n_vertices]
    src_idx: np.ndarray    # int32[ops]
    dst_idx: np.ndarray    # int32[ops]
    weight: np.ndarray     # float32[ops]
    src: np.ndarray        # uint64[ops] = ids[src_idx]
    dst: np.ndarray        # uint64[ops] = ids[dst_idx]

    def __len__(self) -> int:
        return len(self.weight)


@dataclass
class Mix:
    """What a generator makes for one run. ``ops`` is the timed stream of
    one cycle, a whole number of flushes. ``preload`` (same ``ids``, any
    length, or None) is applied to every new store before its first timed
    flush: in set-up, and again after each re-make. ``remake``: at a
    cycle's end a new store is made (and preloaded) for the next cycle;
    else the next cycle replays ``ops`` on the same store."""

    ops: Stream
    preload: Optional[Stream] = None
    remake: bool = True

    @property
    def ids(self) -> np.ndarray:
        return self.ops.ids


def make_mix(config: dict, traffic: dict, seed: int, device="cpu",
             here: pathlib.Path = HERE) -> Mix:
    """The run's ``Mix``, drawn on ``device`` by the generator
    ``generators/<traffic["generator"]>.py``: its ``make(config, traffic,
    seed, device, here)``, which returns a ``Mix`` (or a bare ``Stream``:
    the timed stream, no preload, a new store each cycle)."""
    mix = load_module("generators", traffic["generator"], here).make(
        config, traffic, seed, device, here)
    mix = mix if isinstance(mix, Mix) else Mix(mix)
    if mix.preload is not None and mix.preload.ids is not mix.ops.ids:
        raise ValueError("a preload must name the timed stream's ids")
    return mix
