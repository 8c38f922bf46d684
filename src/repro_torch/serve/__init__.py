"""The graph query service of the port (counterpart of ``repro.serve``'s
``GraphQueryService``)."""
from .graph_service import GraphQueryService, Query, drive_mixed_workload

__all__ = ["GraphQueryService", "Query", "drive_mixed_workload"]
