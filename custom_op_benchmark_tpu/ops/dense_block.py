"""The op family on the component-batched dense layout (BlockGraph).

Same semantic contracts as ops/primitives.py (SURVEY.md §2.3, reference
wrapper.py:8-55), specialized to graphs whose components fit in dense
``(B, L, L)`` blocks. Everything is plain XLA batched matmul math — masked
bmm / softmax — so gradients come from ``jax.grad`` directly and every op
moves exactly its ideal device-memory bytes (the reference's dense-bmm
baseline, wrapper.py:185, promoted to an execution strategy).

Inputs live block-dense: node tensors ``(B, L, ...)`` via
``bg.scatter_nodes``, edge tensors ``(B, L, L, ...)`` via
``bg.scatter_edges``. Multi-head shapes append ``(h, d)`` / ``(h,)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from custom_op_benchmark_tpu.graph.blockdiag import BlockGraph

_NEG = -1e30


def block_sddmm(bg: BlockGraph, a: jax.Array, b: jax.Array) -> jax.Array:
    """Masked scores: a, b (B,L,d) → (B,L,L); or (B,L,h,d) → (B,L,L,h).

    Reference contract: maskedmm_csr (graphop_kernel.cu:41-55).
    """
    if a.ndim == 3:
        s = jnp.einsum("bxd,byd->bxy", a, b,
                       preferred_element_type=jnp.float32).astype(a.dtype)
        return jnp.where(bg.adj, s, 0)
    s = jnp.einsum("bxhd,byhd->bxyh", a, b,
                   preferred_element_type=jnp.float32).astype(a.dtype)
    return jnp.where(bg.adj[..., None], s, 0)


def block_node_mul_edge(bg: BlockGraph, a: jax.Array,
                        be: jax.Array) -> jax.Array:
    """scores[b,x,y,h] = ⟨a[b,x,h,:], be[b,x,y,:]⟩ — node × edge-feature
    dots (reference: node_mul_edge, graphop_kernel.cu:19-34; B is
    edge-carried and shared across heads)."""
    if a.ndim == 3:
        s = jnp.einsum("bxd,bxyd->bxy", a, be,
                       preferred_element_type=jnp.float32).astype(a.dtype)
        return jnp.where(bg.adj, s, 0)
    s = jnp.einsum("bxhd,bxyd->bxyh", a, be,
                   preferred_element_type=jnp.float32).astype(a.dtype)
    return jnp.where(bg.adj[..., None], s, 0)


def block_softmax(bg: BlockGraph, scores: jax.Array, *,
                  by: str = "src") -> jax.Array:
    """Segment softmax over a node's incident edges (stable, masked).

    ``by="src"``: normalize over each row's out-edges (axis 2);
    ``by="dst"``: over each column's in-edges (axis 1). Reference:
    sparse_softmax fwd, graphop_kernel.cu:171-202, direction chosen by
    the CSR handed in (wrapper.py:231 vs 258).
    """
    if by == "src":
        axis = 2
    elif by == "dst":
        axis = 1
    else:
        raise ValueError(f"by must be 'src' or 'dst', got {by!r}")
    adj = bg.adj if scores.ndim == 3 else bg.adj[..., None]
    s = jnp.where(adj, scores, _NEG)
    m = jax.lax.stop_gradient(jnp.max(s, axis=axis, keepdims=True))
    z = jnp.where(adj, jnp.exp(s - m), 0)
    denom = jnp.sum(z, axis=axis, keepdims=True)
    return z / jnp.maximum(denom, 1e-30)


def block_spmm(bg: BlockGraph, ed: jax.Array, x: jax.Array) -> jax.Array:
    """y[b,u] = Σ_v ed[b,u,v]·x[b,v] — neighborhood aggregation
    (reference: vector_spmm, graphop_kernel.cu:119-130). ed (B,L,L) or
    (B,L,L,h); x (B,L,d) or (B,L,h,d)."""
    ed = jnp.where(bg.adj if ed.ndim == 3 else bg.adj[..., None], ed, 0)
    if ed.ndim == 3:
        return jnp.einsum("bxy,byd->bxd", ed, x,
                          preferred_element_type=jnp.float32).astype(x.dtype)
    return jnp.einsum("bxyh,byhd->bxhd", ed, x,
                      preferred_element_type=jnp.float32).astype(x.dtype)


def block_copy_spmm(bg: BlockGraph, x: jax.Array, *,
                    reduce: str = "sum") -> jax.Array:
    """out[b,v] = Σ (or mean) over in-edges u→v of x[b,u] — the
    unweighted aggregation core of GCN/SAGE/GIN as ONE masked batched
    matmul (reference: vector_spmm with unit weights / gspmm copy_lhs).
    x (B, L, d)."""
    adj = bg.adj.astype(x.dtype)
    out = jnp.einsum("bxy,bxd->byd", adj, x,
                     preferred_element_type=jnp.float32)
    if reduce == "mean":
        deg = jnp.maximum(
            jnp.sum(bg.adj, axis=1).astype(jnp.float32), 1.0)
        out = out / deg[..., None]
    elif reduce != "sum":
        raise ValueError(f"reduce must be 'sum'/'mean', got {reduce!r}")
    return out.astype(x.dtype)


def block_gat_attention(bg: BlockGraph, a_l: jax.Array, a_r: jax.Array,
                        z: jax.Array, *,
                        negative_slope: float = 0.2) -> jax.Array:
    """Fused GAT layer core on the dense block layout.

    score[b,u,v,h] = LeakyReLU(a_l·z[b,u,h] + a_r·z[b,v,h]), α = softmax
    over in-edges of dst v, out[b,v,h] = Σ_u α·z[b,u,h] — the additive-
    attention decomposition the reference models with NodeMulEdge +
    sparse_softmax + vector_spmm (wrapper.py:32-55). a_l/a_r (h, d);
    z (B, L, h, d). Plain masked batched matmuls — grads via jax.grad.
    """
    f32 = jnp.float32
    el = jnp.einsum("blhd,hd->blh", z, a_l, preferred_element_type=f32)
    er = jnp.einsum("blhd,hd->blh", z, a_r, preferred_element_type=f32)
    s = el[:, :, None, :] + er[:, None, :, :]      # (B, L, L, h): u, v
    s = jax.nn.leaky_relu(s, negative_slope)
    alpha = block_softmax(bg, s.astype(z.dtype), by="dst")
    return jnp.einsum("bxyh,bxhd->byhd", alpha, z,
                      preferred_element_type=f32).astype(z.dtype)


def block_attention(bg: BlockGraph, q: jax.Array, k: jax.Array,
                    v: jax.Array, *, scale: float = None,
                    normalize: str = "dst") -> jax.Array:
    """Fused masked attention per block: SDDMM → softmax → SpMM.

    ``normalize="dst"`` is the GNN direction (out[v] aggregates over
    in-edges); ``"src"`` mirrors it. q,k,v (B,L,d) or (B,L,h,d).
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if normalize == "dst":
        s = block_sddmm(bg, k, q) * scale    # s[b,u,v] keyed (src u, dst v)
        alpha = block_softmax(bg, s, by="dst")
        # aggregate over in-edges: out[v] = Σ_u α[u,v]·v_feat[u]
        if q.ndim == 3:
            return jnp.einsum("bxy,bxd->byd", alpha, v,
                              preferred_element_type=jnp.float32
                              ).astype(v.dtype)
        return jnp.einsum("bxyh,bxhd->byhd", alpha, v,
                          preferred_element_type=jnp.float32).astype(v.dtype)
    elif normalize == "src":
        s = block_sddmm(bg, q, k) * scale
        alpha = block_softmax(bg, s, by="src")
        return block_spmm(bg, alpha, v)
    raise ValueError(f"normalize must be 'src'/'dst', got {normalize!r}")
