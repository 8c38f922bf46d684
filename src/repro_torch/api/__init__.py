"""``repro_torch.api`` — the GraphStore front door of the port.

    from repro_torch.api import AnalyticsOp, OpBatch, ReadOp, make_store

    store = make_store("local", n_max=4096, expected_n=1000)  # on the card
    # or make_store("sharded", n_shards=4, n_per_shard=4096): every shard
    # on the one card
    store.apply(OpBatch.edges(src, dst, w))
    deg = store.read(ReadOp("degree", ids=ids))
    pr = store.analytics(AnalyticsOp("pagerank", {"iters": 20}))

The analytics registry (``repro_torch.api.registry``) maps algorithm
names to their single-CSR implementation and incremental advance.
"""
from .ir import (AnalyticsOp, AnalyticsResult, ApplyResult, OpBatch, ReadOp,
                 UnsupportedOpError)
from .registry import (ANALYTICS, AnalyticsSpec, analytics_spec,
                       available_analytics, register_analytics)
from .store import (Epoch, GraphStore, LocalStore, ShardedStore,
                    available_backends, make_store, register_backend)

__all__ = [
    "AnalyticsOp", "AnalyticsResult", "ApplyResult", "OpBatch", "ReadOp",
    "UnsupportedOpError", "ANALYTICS", "AnalyticsSpec", "analytics_spec",
    "available_analytics", "register_analytics", "Epoch", "GraphStore",
    "LocalStore", "ShardedStore", "available_backends", "make_store",
    "register_backend",
]
