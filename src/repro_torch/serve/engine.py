"""Batched serving engine of the port: continuous batching over fixed
decode slots (counterpart of ``repro.serve.engine``).

Requests are admitted through the RadixKV manager (block accounting with
the snapshot-log lifecycle); prefill fills a slot's cache, then every
slot decodes in lockstep (one ``model.decode`` a step, idle slots too).
Finished slots are recycled at RadixKV defrag epochs. Greedy sampling
(argmax, the first maximum).

Admission, the LIFO ``free_slots.pop()``, the step order (``active`` in
insertion order), the finish rules and the dead-lock stop are the JAX
engine's. So is what a prefill leaves in the cache. The JAX engine
prefills at batch = ``slots`` (the prompt in the request's row, token 0
in the others) and keeps the request's row, or every row when no request
is active. This one does the same where it shows: with no request active
it prefills every row in place (a recurrent family's next prefill in an
idle slot reads that row's conv tail), and for ``moe``, whose expert
capacity the batch's rows share, it prefills at batch = ``slots`` on a
copy of the cache and keeps the request's row. Otherwise it prefills the
request's row alone (batch 1) in place in its slot: rows are independent,
so the answer and the row are the same at 1/``slots`` of the work. The
slot's rows are views found from the family's cache layout
(``models.api.cache_batch_dims``), never from sizes.

``encdec`` is not served here, as the JAX engine cannot serve it (its
prefill takes no ``frames``): it runs through ``model.prefill`` /
``model.decode`` with ``frames`` / ``enc_out``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.api import cache_batch_dims, cache_map
from .radix_kv import RadixKVManager


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int = 16
    out: Optional[List[int]] = None
    slot: int = -1
    sid: int = -1
    pos: int = 0
    done: bool = False


class ServeEngine:
    def __init__(self, model, params, *, slots: int = 8, smax: int = 256,
                 kv_blocks: int = 4096, block_tokens: int = 16,
                 eos_id: Optional[int] = None):
        self.model = model
        self.cfg = model.cfg
        if self.cfg.family == "encdec":
            raise ValueError("the engine serves no encdec model: run it "
                             "through model.prefill / model.decode with "
                             "frames / enc_out")
        self.params = params
        self.device = params["embed"].device
        self.slots = slots
        self.smax = smax
        self.eos_id = eos_id
        self.kv = RadixKVManager(total_blocks=kv_blocks,
                                 block_tokens=block_tokens)
        self.cache = model.init_cache(slots, smax, device=self.device)
        self.free_slots = list(range(slots))
        self.active: Dict[int, Request] = {}
        self._dims = cache_batch_dims(self.cfg)
        self._shared_rows = self.cfg.family == "moe"
        self._prefill = model.prefill
        self._decode = model.decode

    def _rows(self, cache, slot: int):
        """Views of ``slot``'s rows of every leaf of ``cache``."""
        return cache_map(lambda c, d: c.narrow(d, slot, 1), cache,
                         self._dims)

    def _prefill_into_slot(self, req: Request):
        """The prompt through ``prefill`` into ``req.slot``'s rows of the
        cache, as the JAX engine's batch-``slots`` prefill leaves them (see
        the module's docstring)."""
        if self.active and not self._shared_rows:
            toks = torch.as_tensor(req.prompt[None], dtype=torch.int32,
                                   device=self.device)
            logits, _ = self._prefill(self.params, {"tokens": toks},
                                      self._rows(self.cache, req.slot))
            row = 0
        else:
            toks = np.zeros((self.slots, len(req.prompt)), np.int32)
            toks[req.slot] = req.prompt
            toks = torch.from_numpy(toks).to(self.device)
            cache = cache_map(torch.clone, self.cache) if self.active \
                else self.cache
            logits, _ = self._prefill(self.params, {"tokens": toks}, cache)
            if self.active:
                cache_map(lambda old, new: old.copy_(new),
                          self._rows(self.cache, req.slot),
                          self._rows(cache, req.slot))
            row = req.slot
        req.pos = len(req.prompt)
        req.out = [int(torch.argmax(logits[row]))]

    def submit(self, prompt, max_new=16) -> Optional[int]:
        if not self.free_slots:
            return None
        sid = self.kv.admit(len(prompt))
        if sid is None:
            return None
        rid = sid
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new=max_new, sid=sid)
        req.slot = self.free_slots.pop()
        self._prefill_into_slot(req)
        self.active[rid] = req
        return rid

    def step(self) -> List[int]:
        """One lockstep decode across the slots. Returns finished rids."""
        if not self.active:
            return []
        token = np.zeros((self.slots,), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        for r in self.active.values():
            token[r.slot] = r.out[-1]
            pos[r.slot] = r.pos
        pos_t = torch.from_numpy(pos).to(self.device)
        batch = {"token": torch.from_numpy(token).to(self.device),
                 "pos": pos_t}
        if self.cfg.pos == "mrope":
            batch["positions"] = pos_t[None, :, None].expand(
                3, self.slots, 1)
        logits, self.cache = self._decode(self.params, batch, self.cache)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        finished = []
        for rid, r in list(self.active.items()):
            if not self.kv.append_token(r.sid):
                r.done = True            # KV pool exhausted: finish early
            r.pos += 1
            r.out.append(int(nxt[r.slot]))
            if (len(r.out) >= r.max_new or r.pos >= self.smax - 1 or
                    (self.eos_id is not None and r.out[-1] == self.eos_id) or
                    r.done):
                r.done = True
                self.kv.finish(r.sid)
                self.free_slots.append(r.slot)
                finished.append(rid)
                del self.active[rid]
        return finished

    def run(self, prompts, max_new=16) -> Dict[int, List[int]]:
        """Serve a list of prompts to completion (continuous batching).
        Returns {prompt_index: generated token list}."""
        results: Dict[int, List[int]] = {}
        registry: Dict[int, tuple] = {}
        pending = list(enumerate(prompts))
        while pending or self.active:
            progressed = False
            while pending and self.free_slots:
                idx, p = pending[0]
                rid = self.submit(p, max_new)
                if rid is None:
                    break
                registry[rid] = (idx, self.active[rid])
                pending.pop(0)
                progressed = True
            fins = self.step()
            for rid in fins:
                idx, req = registry.pop(rid)
                results[idx] = req.out
            if not fins and not progressed and not self.active:
                break  # admission dead-lock (pool exhausted): stop cleanly
        return results
