"""Data pipeline of the port (counterpart of ``repro.data.pipeline``): the
deterministic synthetic token stream, the random-walk stream over a live
``RadixGraph`` (the graph store is the corpus), background prefetch, and
host-to-device placement.

The streams draw with numpy exactly as the JAX package's do, so the same
seed and step give the same batches in both packages, bit for bit. Every
stream is checkpointable: ``state()`` returns a small dict stored in the
checkpoint metadata; ``restore(state)`` resumes bit-exactly.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["TokenStream", "GraphWalkStream", "Prefetcher", "shard_batch"]


class TokenStream:
    """Deterministic synthetic LM batches (counter-keyed PRNG: any step can
    be regenerated, so resume == replay)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.step = 0

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def state_for(self, consumed: int) -> Dict:
        """Resume state after ``consumed`` batches were TRAINED on (use this
        under a Prefetcher, which generates ahead of consumption)."""
        return {"step": consumed, "seed": self.seed}

    def restore(self, st: Dict):
        self.step = int(st["step"])
        self.seed = int(st["seed"])

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        rng = np.random.default_rng((self.seed << 32) | self.step)
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        # inject learnable bigram structure so loss decreases measurably
        odd = toks[:, 1::2].shape[1]
        toks[:, 1::2] = (toks[:, 0::2][:, :odd] * 31 + 7) % self.vocab
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class GraphWalkStream:
    """Random-walk sequences over a snapshot of the port's ``RadixGraph``
    (vertex offsets -> token ids). ``refresh`` takes a new snapshot as the
    graph ingests updates (streaming pretraining): the CSR view comes to
    the host once a refresh, and the walks are numpy, as in JAX."""

    def __init__(self, graph, vocab: int, batch: int, seq: int, seed: int = 0):
        self.graph, self.vocab = graph, vocab
        self.batch, self.seq, self.seed = batch, seq, seed
        self.step = 0
        self.refresh()

    def refresh(self):
        snap = self.graph.snapshot()
        self.indptr = snap.indptr.cpu().numpy()
        self.dst = snap.dst.cpu().numpy()
        self.active = np.nonzero(snap.active.cpu().numpy())[0]

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def state_for(self, consumed: int) -> Dict:
        return {"step": consumed, "seed": self.seed}

    def restore(self, st: Dict):
        self.step = int(st["step"])
        self.seed = int(st["seed"])

    def __next__(self) -> Dict:
        rng = np.random.default_rng((self.seed << 32) | self.step)
        B, S = self.batch, self.seq + 1
        walks = np.zeros((B, S), np.int32)
        cur = rng.choice(self.active, B)
        walks[:, 0] = cur
        for t in range(1, S):
            lo, hi = self.indptr[cur], self.indptr[cur + 1]
            deg = hi - lo
            nxt = np.where(
                deg > 0,
                self.dst[np.minimum(lo + (rng.random(B) * np.maximum(deg, 1)
                                          ).astype(np.int64), hi - 1)],
                rng.choice(self.active, B))
            cur = nxt
            walks[:, t] = cur
        toks = walks % self.vocab
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        return self


class Prefetcher:
    """Background-thread prefetch of host batches (overlaps data generation
    with device compute). The worker makes numpy batches only; they go to
    the device in ``shard_batch``, on the caller's thread."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.err: Optional[BaseException] = None
        self._stop = False
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _work(self):
        try:
            for item in self.it:
                if self._stop:
                    return
                self.q.put(item)
        except BaseException as e:  # noqa: BLE001  (re-raised by __next__)
            self.err = e
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            if self.err:
                raise self.err
            raise StopIteration
        return item

    def close(self):
        self._stop = True


def shard_batch(batch: Dict, mesh) -> Dict:
    """Host batch -> tensors on the mesh's device. The port's mesh is one
    device (``launch.mesh.make_local_mesh``), which holds every batch
    whole: nothing is split over the JAX package's batch axes."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in batch.items()}
