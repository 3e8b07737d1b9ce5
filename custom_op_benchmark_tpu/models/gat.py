"""Graph Attention Network (GAT) on the sparse op family.

The attention layer is the composition the reference benchmarks piecewise
(SURVEY.md §2.3): additive attention scores on edges → masked edge-softmax
→ vector-SpMM aggregation, all through the framework's custom-vjp ops.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from custom_op_benchmark_tpu.graph.graph import Graph
from custom_op_benchmark_tpu.models.core import (
    Module,
    dense,
    dropout,
    remat_call,
)
from custom_op_benchmark_tpu.ops import vector_spmm

_glorot = jax.nn.initializers.glorot_uniform()


def aggregate_to_dst(g: Graph, edata: jax.Array, x: jax.Array) -> jax.Array:
    """``out[v] = Σ_{e=(u,v)} edata[e]·x[u]`` via the transpose graph.

    vector_spmm aggregates over CSR rows (to src — reference
    wrapper.py:274 semantics); in-edge aggregation runs the same op on
    ``g.reverse()``, whose canonical order is this graph's CSC order, so
    edge data is permuted by ``csc_perm`` (the reference backward kernels
    pull the same trick — graphop_kernel.cu:398, 586-597).
    """
    # impl pinned: g.reverse() is a fresh object per call, so "auto"
    # would rebuild strategy views at every trace.
    return vector_spmm(g.reverse(), edata[g.csc_perm], x, impl="xla")


@dataclasses.dataclass(frozen=True)
class GATLayer(Module):
    """One multi-head GAT layer (additive attention, LeakyReLU scores).

    score[e,h] = LeakyReLU(a_l·Wx[src] + a_r·Wx[dst]);
    α = edge_softmax over in-edges of dst; out[v] = Σ α·Wx[src].
    """

    out_dim: int
    num_heads: int = 1
    negative_slope: float = 0.2
    concat_heads: bool = True
    residual: bool = False
    dropout_rate: float = 0.0
    param_dtype: jnp.dtype = jnp.float32
    # Compute dtype (mixed precision): params stay param_dtype, the z
    # tensor — and therefore every gathered (R, D, d) tile in the fused
    # ops — runs at this width; accumulation stays f32 inside the ops
    # (preferred_element_type).
    dtype: jnp.dtype = None

    def __call__(self, s, g: Graph, x: jax.Array, *,
                 deterministic: bool = True, ell=None, block=None):
        h, d = self.num_heads, self.out_dim
        a_l = s.param("a_l", _glorot, (h, d), self.param_dtype)
        a_r = s.param("a_r", _glorot, (h, d), self.param_dtype)
        if self.dtype is not None:
            a_l = a_l.astype(self.dtype)
            a_r = a_r.astype(self.dtype)

        def proj(name, inp):
            return dense(s.child(name), inp, h * d, use_bias=False,
                         dtype=self.dtype, param_dtype=self.param_dtype)

        lead = x.shape[:-1]
        z = proj("W", x).reshape(lead + (h, d))
        if block is not None and (self.dropout_rate == 0.0
                                  or deterministic):
            # Dense-block fast path, whole-stack layout: x arrives in
            # (B, L, F) (GAT scatters once at the stack entry).
            from custom_op_benchmark_tpu.ops import block_gat_attention

            out = block_gat_attention(
                block, a_l, a_r, z, negative_slope=self.negative_slope)
        elif ell is not None and (self.dropout_rate == 0.0
                                  or deterministic):
            # Degree-bucketed fused path (ops/ell.py): score, softmax and
            # aggregation in one scatter-free sweep per bucket.
            from custom_op_benchmark_tpu.ops import ell_gat_attention

            src_ell, dst_ell = ell
            out = ell_gat_attention(
                dst_ell, src_ell, a_l, a_r, z,
                negative_slope=self.negative_slope,
            )
        else:
            n = x.shape[0]
            el = jnp.einsum("nhd,hd->nh", z, a_l)
            er = jnp.einsum("nhd,hd->nh", z, a_r)
            # Additive scores per edge; padded edge endpoints clamp
            # (garbage masked below).
            nclamp = jnp.minimum(g.src, n - 1), jnp.minimum(g.dst, n - 1)
            scores = jax.nn.leaky_relu(el[nclamp[0]] + er[nclamp[1]],
                                       self.negative_slope)

            # Fused dst-softmax + aggregation stays in CSC order — saves
            # two cancelling full-edge permutation gathers per layer
            # (round-1 weak #10).
            from custom_op_benchmark_tpu.ops import softmax_aggregate_dst

            dropout_fn = None
            if self.dropout_rate > 0.0:
                dropout_fn = (lambda a: dropout(
                    s, a, self.dropout_rate, deterministic))
            out = softmax_aggregate_dst(
                g, scores, z, dropout_fn=dropout_fn)   # (n, h, d)

        if self.residual:
            res = x if x.shape[-1] == h * d else proj("W_res", x)
            out = out + res.reshape(lead + (h, d))
        if self.concat_heads:
            return out.reshape(lead + (h * d,))
        return out.mean(axis=-2)


@dataclasses.dataclass(frozen=True)
class GAT(Module):
    """A GAT stack for node classification (ELU between layers).

    ``remat=True`` checkpoints each layer (``jax.checkpoint``): the fused
    attention's gathered z tiles (GBs at ogbn edge counts) are recomputed
    in the backward instead of living from each layer's forward until its
    backward — trades one extra gather pass per layer for O(layers·e·d)
    device memory. Use it when a full-graph training step runs out of
    memory.
    """

    hidden_dim: int
    out_dim: int
    num_layers: int = 2
    num_heads: int = 8
    dropout_rate: float = 0.0
    remat: bool = False
    # Mixed precision: dtype=jnp.bfloat16 runs every layer's z tensor
    # (and the fused ops' gathered tiles) at bf16 with f32 params and
    # f32 in-op accumulation; logits are returned in f32.
    dtype: jnp.dtype = None

    def __call__(self, s, g: Graph, x: jax.Array, *,
                 deterministic: bool = True, ell=None, block=None):
        # Dense-block whole-stack layout (same pass as GraphTransformer):
        # scatter once, run every layer in (B, L, ·), gather once.
        block_layout = block is not None and (
            self.dropout_rate == 0.0 or deterministic)
        if block_layout:
            x = block.scatter_nodes(x)
        blk = block if block_layout else None
        for i in range(self.num_layers - 1):
            layer = GATLayer(self.hidden_dim, self.num_heads,
                             dropout_rate=self.dropout_rate,
                             residual=i > 0, dtype=self.dtype)
            x = remat_call(
                s, f"layer{i}",
                lambda c, x, layer=layer: layer(
                    c, g, x, deterministic=deterministic, ell=ell,
                    block=blk),
                x, remat=self.remat)
            x = dropout(s, jax.nn.elu(x), self.dropout_rate, deterministic)
        last = GATLayer(self.out_dim, num_heads=1, concat_heads=False,
                        dtype=self.dtype)
        out = last(s.child(f"layer{self.num_layers - 1}"), g, x,
                   deterministic=deterministic, ell=ell, block=blk)
        if block_layout:
            out = block.gather_nodes(out)
        return out.astype(jnp.float32) if self.dtype is not None else out
