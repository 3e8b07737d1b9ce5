"""Graph Isomorphism Network (sum aggregator + MLP).

Beyond-reference model family (the reference's op set covers it: GIN's
neighborhood sum is gspmm copy_lhs/sum — the same aggregation vector_spmm
specializes). Supports the ELL fast path via ell_copy_spmm.
"""

from __future__ import annotations

import dataclasses

import jax

from custom_op_benchmark_tpu.graph.graph import Graph
from custom_op_benchmark_tpu.models.core import Module, dense
from custom_op_benchmark_tpu.ops import gspmm


@dataclasses.dataclass(frozen=True)
class GINLayer(Module):
    """h'_v = MLP((1 + eps)·h_v + Σ_{u→v} h_u)."""

    out_dim: int
    hidden_dim: int = 0

    def __call__(self, s, g: Graph, x: jax.Array, *, ell=None, block=None):
        if block is not None:
            # Dense-block fast path (whole-stack (B, L, F) layout).
            from custom_op_benchmark_tpu.ops import block_copy_spmm

            neigh = block_copy_spmm(block, x, reduce="sum")
        elif ell is not None:
            from custom_op_benchmark_tpu.ops import ell_copy_spmm

            src_ell, dst_ell = ell
            neigh = ell_copy_spmm(dst_ell, src_ell, x, reduce="sum")
        else:
            neigh = gspmm(g, "copy_lhs", "sum", lhs=x, lhs_target="u",
                          to="dst")
        eps = s.param("eps", jax.nn.initializers.zeros, ())
        h = (1.0 + eps) * x + neigh
        h = jax.nn.relu(dense(s.child("mlp1"), h,
                              self.hidden_dim or self.out_dim))
        return dense(s.child("mlp2"), h, self.out_dim)


@dataclasses.dataclass(frozen=True)
class GIN(Module):
    hidden_dim: int
    out_dim: int
    num_layers: int = 2

    def __call__(self, s, g: Graph, x: jax.Array, *,
                 deterministic: bool = True, ell=None, block=None):
        if block is not None:   # whole-stack (B, L, ·) layout
            x = block.scatter_nodes(x)
        for i in range(self.num_layers - 1):
            x = jax.nn.relu(GINLayer(self.hidden_dim)(
                s.child(f"layer{i}"), g, x, ell=ell, block=block))
        x = GINLayer(self.out_dim)(
            s.child(f"layer{self.num_layers - 1}"), g, x, ell=ell,
            block=block)
        return block.gather_nodes(x) if block is not None else x
