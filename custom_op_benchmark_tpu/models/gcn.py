"""Graph Convolutional Network (symmetric-normalized aggregation)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from custom_op_benchmark_tpu.graph.graph import Graph
from custom_op_benchmark_tpu.models.core import Module, dense, dropout
from custom_op_benchmark_tpu.ops import gspmm


@dataclasses.dataclass(frozen=True)
class GCNLayer(Module):
    """h' = D̂^{-1/2} Â D̂^{-1/2} h W  (aggregation over in-edges)."""

    out_dim: int
    use_bias: bool = True

    def __call__(self, s, g: Graph, x: jax.Array, *, ell=None, block=None):
        z = dense(s.child("W"), x, self.out_dim, use_bias=False)
        if block is not None:
            # Dense-block fast path, whole-stack layout: x is (B, L, F);
            # degrees come from the block adjacency (same edge set).
            from custom_op_benchmark_tpu.ops import block_copy_spmm

            deg_out = jnp.maximum(
                jnp.sum(block.adj, axis=2).astype(z.dtype), 1.0)
            deg_in = jnp.maximum(
                jnp.sum(block.adj, axis=1).astype(z.dtype), 1.0)
            z = z * jax.lax.rsqrt(deg_out)[..., None]
            out = block_copy_spmm(block, z, reduce="sum")
            out = out * jax.lax.rsqrt(deg_in)[..., None]
        else:
            # Symmetric normalization: scale by 1/sqrt(deg_out) at src
            # and 1/sqrt(deg_in) at dst.
            deg_out = jnp.maximum(g.out_degrees().astype(z.dtype), 1.0)
            deg_in = jnp.maximum(g.in_degrees().astype(z.dtype), 1.0)
            z = z * jax.lax.rsqrt(deg_out)[:, None]
            if ell is not None:
                from custom_op_benchmark_tpu.ops import ell_copy_spmm

                src_ell, dst_ell = ell
                out = ell_copy_spmm(dst_ell, src_ell, z, reduce="sum")
            else:
                out = gspmm(g, "copy_lhs", "sum", lhs=z, lhs_target="u",
                            to="dst")
            out = out * jax.lax.rsqrt(deg_in)[:, None]
        if self.use_bias:
            out = out + s.param("b", jax.nn.initializers.zeros,
                                (self.out_dim,), z.dtype)
        return out


@dataclasses.dataclass(frozen=True)
class GCN(Module):
    hidden_dim: int
    out_dim: int
    num_layers: int = 2
    dropout_rate: float = 0.0

    def __call__(self, s, g: Graph, x: jax.Array, *,
                 deterministic: bool = True, ell=None, block=None):
        if block is not None:   # whole-stack (B, L, ·) layout
            x = block.scatter_nodes(x)
        for i in range(self.num_layers - 1):
            x = jax.nn.relu(GCNLayer(self.hidden_dim)(
                s.child(f"layer{i}"), g, x, ell=ell, block=block))
            x = dropout(s, x, self.dropout_rate, deterministic)
        x = GCNLayer(self.out_dim)(
            s.child(f"layer{self.num_layers - 1}"), g, x, ell=ell,
            block=block)
        return block.gather_nodes(x) if block is not None else x
