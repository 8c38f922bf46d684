"""Serving in the port: the LM engine with the RadixKV block manager
(counterparts of ``repro.serve``'s ``ServeEngine`` and ``RadixKVManager``)
and the graph query service."""
from .engine import ServeEngine
from .graph_service import GraphQueryService, Query, drive_mixed_workload
from .radix_kv import RadixKVManager

__all__ = ["RadixKVManager", "ServeEngine", "GraphQueryService", "Query",
           "drive_mixed_workload"]
