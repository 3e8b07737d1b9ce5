"""Masked graph transformer: dot-product attention restricted to edges.

This is the model the reference's benchmark workload implies: its 512×30
clique graph *is* the block-diagonal mask of batched self-attention
(wrapper.py:79-101), and its op sequence SDDMM → edge-softmax →
vector-SpMM is exactly masked multi-head attention computed edge-wise.
The NodeMulEdge op carries edge-wise relative-position scores, the use the
reference built it for (graphop_kernel.cu:17 comment).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from custom_op_benchmark_tpu.graph.graph import Graph
from custom_op_benchmark_tpu.models.core import (
    Module,
    dense,
    dropout,
    layer_norm,
    remat_call,
)
from custom_op_benchmark_tpu.ops import node_mul_edge, sddmm


@dataclasses.dataclass(frozen=True)
class GraphMultiHeadAttention(Module):
    """Multi-head dot-product attention over graph edges.

    scores[e,h] = <Q[src], K[dst]>/√d (+ <Q[src], E[e]> if edge features),
    α = softmax over in-edges of dst (attention normalizes over keys),
    out[v] = Σ_{e=(u,v)} α[e]·V[u].

    When a ``TiledGraph`` is supplied (and no edge features are used),
    the whole score→softmax→aggregate pipeline runs as the fused tiled
    attention (ops/tiled.py) with no edge-sized device-memory traffic.
    """

    num_heads: int
    head_dim: int
    dtype: jnp.dtype = None   # compute dtype (mixed precision)

    def __call__(self, s, g: Graph, x: jax.Array,
                 edge_feat: Optional[jax.Array] = None, *, tiled=None,
                 block=None, ell=None, block_layout: bool = False):
        h, d = self.num_heads, self.head_dim
        lead = x.shape[:-1]

        def proj(name):
            return dense(s.child(name), x, h * d, use_bias=False,
                         dtype=self.dtype).reshape(lead + (h, d))

        def out_proj(out):
            return dense(s.child("Wo"), out.reshape(lead + (h * d,)),
                         x.shape[-1], dtype=self.dtype)

        q, k, v = proj("Wq"), proj("Wk"), proj("Wv")
        if block_layout:
            # Model-level layout pass: x arrives ALREADY in the (B, L, D)
            # block layout (GraphTransformer scatters once at the stack
            # entry), so the per-layer scatter/gather boundary
            # conversions vanish. Dense works on the last dim either way.
            assert block is not None and edge_feat is None
            from custom_op_benchmark_tpu.ops import block_attention

            return out_proj(block_attention(block, q, k, v,
                                            normalize="dst"))

        if ell is not None:
            # Degree-bucketed fused attention (general graphs): pass the
            # (src, dst) dual from ops.ell_dual; normalization over
            # in-edges of dst ⇒ run over the dst packing. Edge features
            # take the fused edge-bias kernel.
            from custom_op_benchmark_tpu.ops import ell_attention
            from custom_op_benchmark_tpu.ops.ell import (
                ell_edge_bias_attention,
            )

            src_ell, dst_ell = ell
            if edge_feat is None:
                return out_proj(ell_attention(dst_ell, src_ell, q, k, v))
            return out_proj(ell_edge_bias_attention(
                dst_ell, src_ell, q, k, v, edge_feat))

        if block is not None and edge_feat is None:
            # Component-batched dense attention (ops/dense_block.py);
            # scatter/gather at the boundary keeps the model node-indexed.
            from custom_op_benchmark_tpu.ops import block_attention

            out = block_attention(
                block,
                block.scatter_nodes(q),
                block.scatter_nodes(k),
                block.scatter_nodes(v),
                normalize="dst",
            )
            return out_proj(block.gather_nodes(out))

        if tiled is not None and edge_feat is None:
            from custom_op_benchmark_tpu.ops.tiled import tiled_attention

            return out_proj(tiled_attention(tiled, q, k, v,
                                            normalize="dst"))

        # Attention over in-edges of dst: score = <Q[dst], K[src]>.
        scores = sddmm(g, k, q)  # <K[src], Q[dst]> per edge
        if edge_feat is not None:
            # Relative-position / edge-feature scores via NodeMulEdge.
            scores = scores + node_mul_edge(g, q, edge_feat)
        scores = scores / jnp.sqrt(jnp.asarray(d, x.dtype))

        from custom_op_benchmark_tpu.ops import softmax_aggregate_dst

        return out_proj(softmax_aggregate_dst(g, scores, v))  # CSC-fused


@dataclasses.dataclass(frozen=True)
class GraphTransformerLayer(Module):
    num_heads: int
    head_dim: int
    mlp_dim: int
    dropout_rate: float = 0.0
    dtype: jnp.dtype = None   # compute dtype (mixed precision)

    def __call__(self, s, g: Graph, x: jax.Array,
                 edge_feat: Optional[jax.Array] = None, *,
                 deterministic: bool = True, tiled=None, block=None,
                 ell=None, block_layout: bool = False):
        dt = self.dtype
        y = layer_norm(s.child("ln1"), x, dtype=dt)
        y = GraphMultiHeadAttention(self.num_heads, self.head_dim,
                                    dtype=dt)(
            s.child("attn"), g, y, edge_feat, tiled=tiled, block=block,
            ell=ell, block_layout=block_layout)
        x = x + dropout(s, y, self.dropout_rate, deterministic)
        y = layer_norm(s.child("ln2"), x, dtype=dt)
        y = jax.nn.gelu(dense(s.child("mlp1"), y, self.mlp_dim, dtype=dt))
        y = dense(s.child("mlp2"), y, x.shape[-1], dtype=dt)
        return x + dropout(s, y, self.dropout_rate, deterministic)


@dataclasses.dataclass(frozen=True)
class GraphTransformer(Module):
    """A stack of masked-attention transformer layers over a graph.

    ``remat=True`` checkpoints each layer (``jax.checkpoint``, same
    contract as :class:`..models.gat.GAT`): the fused attention's
    gathered k/v/q tiles — and with edge features the (R, D, d) bias
    tiles — are recomputed in the backward instead of living from each
    layer's forward until its backward. Required for full-graph
    edge-bias training at ogbn-arxiv edge counts and above.
    """

    dim: int
    num_heads: int
    num_layers: int
    mlp_dim: Optional[int] = None
    out_dim: Optional[int] = None
    dropout_rate: float = 0.0
    remat: bool = False
    # Mixed precision: params stay f32; activations (and the fused ops'
    # gathered tiles) run at this dtype; logits return in f32.
    dtype: jnp.dtype = None
    # Layout pass switch (block strategy only): False reverts to
    # per-layer scatter/gather at every attention boundary — kept for
    # A/B measurement; the whole-stack layout is numerically equivalent.
    block_whole_stack: bool = True

    def __call__(self, s, g: Graph, x: jax.Array,
                 edge_feat: Optional[jax.Array] = None, *,
                 deterministic: bool = True, tiled=None, block=None,
                 ell=None):
        # Model-level layout pass (dense_block): scatter ONCE to the
        # (B, L, D) component-batched layout, run every layer there
        # (dense/LayerNorm/attention all operate per slot; padded slots
        # carry garbage that the adjacency mask and the final gather
        # discard), gather ONCE at the stack exit — removing the two
        # boundary permutations every layer otherwise pays.
        block_layout = (block is not None and edge_feat is None
                        and self.block_whole_stack)
        if block_layout:
            x = block.scatter_nodes(x)
        if x.shape[-1] != self.dim:
            x = dense(s.child("proj_in"), x, self.dim, dtype=self.dtype)
        layer = GraphTransformerLayer(
            self.num_heads, self.dim // self.num_heads,
            self.mlp_dim or 4 * self.dim, self.dropout_rate,
            dtype=self.dtype)
        for i in range(self.num_layers):
            x = remat_call(
                s, f"layer{i}",
                lambda c, x: layer(
                    c, g, x, edge_feat, deterministic=deterministic,
                    tiled=tiled, block=block, ell=ell,
                    block_layout=block_layout),
                x, remat=self.remat)
        if block_layout:
            x = block.gather_nodes(x)
        x = layer_norm(s.child("ln_out"), x, dtype=self.dtype)
        if self.out_dim is not None:
            x = dense(s.child("proj_out"), x, self.out_dim,
                      dtype=self.dtype)
        return x.astype(jnp.float32) if self.dtype is not None else x
