"""``repro_torch.dist`` — the sharded graph engine of the port (port of
``repro.dist.graph_engine``): every shard on one device, stacked on a
leading shard axis."""
from .graph_engine import (make_apply_edges, make_apply_edges_pipelined,
                           make_degree_map, make_khop_counts, make_num_edges,
                           make_sharded_state, make_snapshot,
                           make_sync_vertices, shard_of_keys)

__all__ = ["make_sharded_state", "make_apply_edges",
           "make_apply_edges_pipelined", "make_sync_vertices",
           "make_snapshot", "make_khop_counts", "make_degree_map",
           "make_num_edges", "shard_of_keys"]
