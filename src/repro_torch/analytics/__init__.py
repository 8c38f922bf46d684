from .algorithms import (INF, bfs, sssp, pagerank, wcc, triangle_count, bc,
                         khop, edge_sources, csr_edges, bfs_expand,
                         pagerank_contrib, pagerank_scatter)

__all__ = ["INF", "bfs", "sssp", "pagerank", "wcc", "triangle_count", "bc",
           "khop", "edge_sources", "csr_edges", "bfs_expand",
           "pagerank_contrib", "pagerank_scatter"]
