"""Graph containers and host-side preprocessing (the framework's L6).

Reference parity: dual-CSR + canonical edge ids (wrapper.py:84-116) and
edge-balanced row chunking (part_csr.py:13-27), redesigned for XLA:
int32 indices, static padded shapes, conflict-free row-owned tiles.
"""

from custom_op_benchmark_tpu.graph.graph import Graph, from_coo
from custom_op_benchmark_tpu.graph.partition import (
    partition_csr,
    edge_partition,
)
from custom_op_benchmark_tpu.graph.tiled import TiledGraph
from custom_op_benchmark_tpu.graph.builders import (
    add_self_loops,
    clique_batch,
    grid_graph,
    random_graph,
    remove_duplicate_edges,
)
from custom_op_benchmark_tpu.graph.reorder import (
    Reordering,
    connected_components,
    degree_balanced_order,
    reorder_graph,
    tile_aligned_order,
)
from custom_op_benchmark_tpu.graph.blockdiag import BlockGraph, block_graph
from custom_op_benchmark_tpu.graph.ell import EllGraph, ell_pack
from custom_op_benchmark_tpu.graph.cache import cached, graph_key
from custom_op_benchmark_tpu.graph.cluster import cluster_order

__all__ = [
    "Graph",
    "from_coo",
    "TiledGraph",
    "partition_csr",
    "edge_partition",
    "clique_batch",
    "random_graph",
    "grid_graph",
    "add_self_loops",
    "remove_duplicate_edges",
    "Reordering",
    "connected_components",
    "degree_balanced_order",
    "reorder_graph",
    "tile_aligned_order",
    "BlockGraph",
    "block_graph",
    "EllGraph",
    "ell_pack",
    "cached",
    "graph_key",
    "cluster_order",
]
