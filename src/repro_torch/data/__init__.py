"""``repro_torch.data`` — the training data streams of the port (port of
``repro.data``)."""
from .pipeline import GraphWalkStream, Prefetcher, TokenStream, shard_batch

__all__ = ["TokenStream", "GraphWalkStream", "Prefetcher", "shard_batch"]
