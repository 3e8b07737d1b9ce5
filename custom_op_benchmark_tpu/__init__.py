"""custom_op_benchmark_tpu — a graph message-passing framework in JAX.

Built from scratch under JAX/XLA/Pallas with the capabilities of the
reference repo ``yzh119/custom_op_benchmark`` (see SURVEY.md); it runs on
NVIDIA GPUs (and on the CPU for tests):

- the differentiable sparse op family SDDMM / NodeMulEdge / edge-softmax /
  vector-SpMM (reference: graphop/graphop_kernel.cu, wrapper.py:8-55),
  implemented as conflict-free segment/tile layouts — no atomics
  (reference: graphop/atomic.cuh) — behind ``jax.custom_vjp``;
- a dual-CSR graph container with canonical edge ids
  (reference: wrapper.py:84-116) and edge-balanced partitioning
  (reference: part_csr.py);
- Pallas kernels (Triton route) on a block-sparse tiling;
- GAT / GCN / GraphSAGE / graph-transformer model layers;
- neighbor-sampling minibatch pipelines;
- multi-chip edge-partitioned execution via ``shard_map`` over a
  ``jax.sharding.Mesh``.
"""

from custom_op_benchmark_tpu.graph import Graph, from_coo, TiledGraph
from custom_op_benchmark_tpu.ops import (
    attention,
    gat_attention,
    sddmm,
    node_mul_edge,
    edge_softmax,
    vector_spmm,
)
from custom_op_benchmark_tpu.utils.summary import describe

__version__ = "0.1.0"

__all__ = [
    "Graph",
    "TiledGraph",
    "from_coo",
    "attention",
    "gat_attention",
    "describe",
    "sddmm",
    "node_mul_edge",
    "edge_softmax",
    "vector_spmm",
]
