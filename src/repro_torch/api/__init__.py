"""``repro_torch.api`` — the GraphStore front door of the port.

    from repro_torch.api import OpBatch, ReadOp, make_store

    store = make_store("local", n_max=4096, expected_n=1000)  # on the card
    store.apply(OpBatch.edges(src, dst, w))
    deg = store.read(ReadOp("degree", ids=ids))
"""
from .ir import (AnalyticsOp, AnalyticsResult, ApplyResult, OpBatch, ReadOp,
                 UnsupportedOpError)
from .store import (Epoch, GraphStore, LocalStore, available_backends,
                    make_store, register_backend)

__all__ = [
    "AnalyticsOp", "AnalyticsResult", "ApplyResult", "OpBatch", "ReadOp",
    "UnsupportedOpError", "Epoch", "GraphStore", "LocalStore",
    "available_backends", "make_store", "register_backend",
]
