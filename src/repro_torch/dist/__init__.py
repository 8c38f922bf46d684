"""``repro_torch.dist`` — the sharded graph engine of the port (port of
``repro.dist.graph_engine``: every shard on one device, stacked on a
leading shard axis), the partition planner's rules (``sharding``) and
int8 gradient compression (``compress``)."""
from .compress import dequantize_int8, error_feedback, quantize_int8
from .graph_engine import (make_apply_edges, make_apply_edges_pipelined,
                           make_degree_map, make_khop_counts, make_num_edges,
                           make_sharded_state, make_snapshot,
                           make_sync_vertices, shard_of_keys)
from .sharding import (MOE_SERVE_RULES, SERVE_RULES, TRAIN_RULES, VARIANTS,
                       ShardingRules, constrain, param_partition_specs,
                       set_rules, spec_for)

__all__ = ["make_sharded_state", "make_apply_edges",
           "make_apply_edges_pipelined", "make_sync_vertices",
           "make_snapshot", "make_khop_counts", "make_degree_map",
           "make_num_edges", "shard_of_keys", "ShardingRules", "TRAIN_RULES",
           "SERVE_RULES", "MOE_SERVE_RULES", "VARIANTS", "spec_for",
           "param_partition_specs", "set_rules", "constrain",
           "quantize_int8", "dequantize_int8", "error_feedback"]
