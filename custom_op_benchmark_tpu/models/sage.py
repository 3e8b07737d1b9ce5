"""GraphSAGE (mean aggregator) — the sampled-minibatch model family.

Pairs with data/sampling.py's fanout neighbor sampler (the Reddit
GraphSAGE 25/10 config of BASELINE.md).
"""

from __future__ import annotations

import dataclasses

import jax

from custom_op_benchmark_tpu.graph.graph import Graph
from custom_op_benchmark_tpu.models.core import Module, dense, dropout
from custom_op_benchmark_tpu.ops import gspmm


@dataclasses.dataclass(frozen=True)
class SAGELayer(Module):
    """h'_v = W_self·h_v + W_neigh·mean_{u→v} h_u."""

    out_dim: int

    def __call__(self, s, g: Graph, x: jax.Array, *, ell=None,
                 in_cols=None, block=None):
        if block is not None:
            # Dense-block fast path (whole-stack (B, L, F) layout).
            from custom_op_benchmark_tpu.ops import block_copy_spmm

            neigh = block_copy_spmm(block, x, reduce="mean")
        elif in_cols is not None:
            # Sampled-minibatch fast path: static one-bucket in-neighbor
            # matrix (ops/sampled.py) — scatter-free, one compile/epoch.
            from custom_op_benchmark_tpu.ops.sampled import (
                sampled_copy_spmm,
            )

            neigh = sampled_copy_spmm(in_cols, g, x, reduce="mean")
        elif ell is not None:
            from custom_op_benchmark_tpu.ops import ell_copy_spmm

            src_ell, dst_ell = ell
            neigh = ell_copy_spmm(dst_ell, src_ell, x, reduce="mean")
        else:
            neigh = gspmm(g, "copy_lhs", "mean", lhs=x, lhs_target="u",
                          to="dst")
        return (dense(s.child("W_self"), x, self.out_dim)
                + dense(s.child("W_neigh"), neigh, self.out_dim,
                        use_bias=False))


@dataclasses.dataclass(frozen=True)
class GraphSAGE(Module):
    hidden_dim: int
    out_dim: int
    num_layers: int = 2
    dropout_rate: float = 0.0

    def __call__(self, s, g: Graph, x: jax.Array, *,
                 deterministic: bool = True, ell=None, in_cols=None,
                 block=None):
        if block is not None:   # whole-stack (B, L, ·) layout
            x = block.scatter_nodes(x)
        for i in range(self.num_layers - 1):
            x = jax.nn.relu(SAGELayer(self.hidden_dim)(
                s.child(f"layer{i}"), g, x, ell=ell, in_cols=in_cols,
                block=block))
            x = dropout(s, x, self.dropout_rate, deterministic)
        x = SAGELayer(self.out_dim)(
            s.child(f"layer{self.num_layers - 1}"), g, x, ell=ell,
            in_cols=in_cols, block=block)
        return block.gather_nodes(x) if block is not None else x
