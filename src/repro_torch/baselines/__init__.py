"""Baselines the paper compares against, on the port's PyTorch substrate
(port of ``repro.baselines``).

Vertex indices: ``TorchART`` (adaptive radix tree, 8-bit layers,
sparse/dense nodes; its batched insert is one CUDA kernel on a card) and
``HashIndex`` (open addressing — the multi-level-vector family's ID
translation); uniform-tree and vEB-tree SORT configurations come from
``core.sort_optimizer.uniform_config`` / ``veb_config`` + ``SortSpec``.

Edge structures: selected by ``RadixGraph(policy=...)`` — 'grow'
(log-structured, LiveGraph/GTX paradigm) and 'sorted' (sorted snapshot +
small buffer, Spruce paradigm) against the paper's 'snaplog'.
"""
from .art import TorchART
from .hash_index import HashIndex

__all__ = ["TorchART", "HashIndex"]
