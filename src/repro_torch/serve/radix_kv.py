"""RadixKV — the paper's snapshot-log lifecycle transplanted onto paged KV
cache blocks. The port's copy of ``repro.serve.radix_kv`` (host-side
Python, no JAX there either): the same operations, counters and
relocation plans.

Mapping (edge array -> KV extent):
  vertex            -> active sequence
  edge block        -> KV block (``block_tokens`` positions)
  log append O(1)   -> per-token block append from the bump allocator
  compaction (2d)   -> defragmentation: live sequences relocated to
                       contiguous extents, freed/finished blocks reclaimed
  free-slot queue   -> finished sequences recycled at defrag epochs only
                       (same dangling-reference safety argument as §3.1)

The manager is host-side (admission control / block tables); the device-side
cache is the contiguous-per-sequence layout the models already use, plus a
``gather`` relocation plan emitted at defrag. Amortized O(1) blocks-touched
per decoded token, mirroring Theorem 2.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Sequence:
    sid: int
    start_block: int
    n_blocks: int
    tokens: int
    finished: bool = False


@dataclass
class RadixKVManager:
    total_blocks: int
    block_tokens: int = 16
    defrag_threshold: float = 0.5   # defrag when garbage > half the pool

    next_block: int = 0
    garbage_blocks: int = 0
    seqs: Dict[int, Sequence] = field(default_factory=dict)
    _next_sid: int = 0
    defrags: int = 0
    overflow: int = 0

    # ---- paper-lifecycle operations ----
    def admit(self, prompt_tokens: int) -> Optional[int]:
        """Admit a sequence: allocate a 2x extent (snapshot = prompt blocks,
        log = equal headroom — the paper's cap = 2d discipline)."""
        need = max(1, -(-prompt_tokens // self.block_tokens))
        blocks = 2 * need
        if not self._ensure(blocks):
            self.overflow += 1
            return None
        s = Sequence(self._next_sid, self.next_block, blocks, prompt_tokens)
        self.next_block += blocks
        self.seqs[s.sid] = s
        self._next_sid += 1
        return s.sid

    def append_token(self, sid: int) -> bool:
        """O(1) log append; on extent exhaustion re-extent at 2x (the
        compaction-growth path; relocation cost amortizes per Theorem 2)."""
        s = self.seqs[sid]
        s.tokens += 1
        if s.tokens <= s.n_blocks * self.block_tokens:
            return True
        live = -(-s.tokens // self.block_tokens)
        blocks = 2 * live
        if not self._ensure(blocks):
            self.overflow += 1
            s.tokens -= 1
            return False
        self.garbage_blocks += s.n_blocks
        s.start_block = self.next_block
        s.n_blocks = blocks
        self.next_block += blocks
        return True

    def finish(self, sid: int):
        s = self.seqs[sid]
        s.finished = True
        self.garbage_blocks += s.n_blocks

    def _ensure(self, blocks: int) -> bool:
        if self.next_block + blocks <= self.total_blocks:
            return True
        if self.garbage_blocks > 0:   # any reclaim might make it fit
            self.defrag()
        return self.next_block + blocks <= self.total_blocks

    def defrag(self) -> List[Tuple[int, int, int]]:
        """Compact live extents to the front (vertex-ordered relocation).
        Returns the relocation plan [(old_start, new_start, n_blocks)] the
        device cache applies as one gather."""
        plan = []
        cursor = 0
        for sid in sorted(self.seqs):
            s = self.seqs[sid]
            if s.finished:
                continue
            live = max(1, -(-s.tokens // self.block_tokens))
            blocks = 2 * live
            plan.append((s.start_block, cursor, min(s.n_blocks, blocks)))
            s.start_block = cursor
            s.n_blocks = blocks
            cursor += blocks
        self.seqs = {k: v for k, v in self.seqs.items() if not v.finished}
        self.next_block = cursor
        self.garbage_blocks = 0
        self.defrags += 1
        return plan

    # ---- introspection ----
    @property
    def live_blocks(self) -> int:
        return sum(s.n_blocks for s in self.seqs.values() if not s.finished)

    @property
    def utilization(self) -> float:
        return self.live_blocks / max(self.total_blocks, 1)
