"""Public differentiable ops: ``jax.custom_vjp`` wiring + shape dispatch.

This is the framework's L3+L5 (reference: graphop.cpp validation +
wrapper.py:8-55 autograd Functions) collapsed into one layer:

- every op is a ``jax.custom_vjp`` whose backward implements the VJP
  contracts of SURVEY.md §2.3 explicitly (index arrays get ``None``
  cotangents, like the reference's ``return None, None, ...``);
- rank dispatch matches the reference launchers: rank-2 node features mean
  single-head (``h`` inferred from rank — graphop_kernel.cu:247, 283, 421),
  normalized internally to ``(n, h, d)``;
- ``impl`` selects the execution backend: ``"xla"`` (segment ops, the
  oracle), ``"pallas"``/``"tiled"`` (Pallas BSR kernels),
  ``"dense_block"``, ``"ell"``, or ``"auto"`` (strategy advisor — see
  ops/dispatch.py). Non-XLA strategies need a concrete (non-traced)
  Graph; their views are built once per graph and cached.

Input validation happens at trace time on shapes/dtypes (the reference's
CHECK_INPUT role, graphop.cpp:4-6) — there is nothing to check at runtime
because layouts are static.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from custom_op_benchmark_tpu.graph.graph import Graph
from custom_op_benchmark_tpu.ops import dispatch as _dispatch
from custom_op_benchmark_tpu.ops import xla as _xla


def _resolve(g, impl: str) -> str:
    """Concrete strategy for this (graph, impl) — see ops/dispatch.py."""
    return _dispatch.resolve(g, impl)


def _norm_nodes(x, name):
    if x.ndim == 2:
        return x[:, None, :], True
    if x.ndim == 3:
        return x, False
    raise ValueError(f"{name} must be (n, d) or (n, h, d), got {x.shape}")


def _norm_edges(x, name):
    if x.ndim == 1:
        return x[:, None], True
    if x.ndim == 2:
        return x, False
    raise ValueError(f"{name} must be (e,) or (e, h), got {x.shape}")


# ---------------------------------------------------------------------------
# SDDMM
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _sddmm(impl, src, dst, csc_perm, dst_csc, A, B):
    return _xla.sddmm_fwd(src, dst, A, B)


def _sddmm_f(impl, src, dst, csc_perm, dst_csc, A, B):
    y = _sddmm(impl, src, dst, csc_perm, dst_csc, A, B)
    return y, (src, dst, csc_perm, dst_csc, A, B)


def _sddmm_b(impl, res, dy):
    src, dst, csc_perm, dst_csc, A, B = res
    dA, dB = _xla.sddmm_bwd(src, dst, csc_perm, dst_csc, A, B, dy)
    return None, None, None, None, dA, dB


_sddmm.defvjp(_sddmm_f, _sddmm_b)


def sddmm(g: Graph, A: jax.Array, B: jax.Array, *, impl: str = "auto"):
    """Edge scores ``y[e(, h)] = <A[src(e)(, h)], B[dst(e)(, h)]>``.

    Reference: ``MaskedMMCSR`` (wrapper.py:20-30, graphop_kernel.cu:41-55).
    A, B: ``(n, d)`` → returns ``(E,)``; ``(n, h, d)`` → ``(E, h)``
    (E = padded edge count; padded entries are garbage — mask with
    ``g.edge_mask`` if needed downstream outside this op family).
    """
    strategy = _resolve(g, impl)
    A3, sa = _norm_nodes(A, "A")
    B3, sb = _norm_nodes(B, "B")
    if sa != sb or A3.shape != B3.shape:
        raise ValueError(f"A/B shape mismatch: {A.shape} vs {B.shape}")
    if strategy != "xla":
        return _dispatch.sddmm(strategy, g, A, B)
    y = _sddmm(impl, g.src, g.dst, g.csc_perm, g.dst_csc, A3, B3)
    return y[:, 0] if sa else y


# ---------------------------------------------------------------------------
# NodeMulEdge
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _node_mul_edge(impl, src, A, B):
    return _xla.node_mul_edge_fwd(src, A, B)


def _nme_f(impl, src, A, B):
    return _node_mul_edge(impl, src, A, B), (src, A, B)


def _nme_b(impl, res, dy):
    src, A, B = res
    dA, dB = _xla.node_mul_edge_bwd(src, A, B, dy)
    return None, dA, dB


_node_mul_edge.defvjp(_nme_f, _nme_b)


def node_mul_edge(g: Graph, A: jax.Array, B: jax.Array, *,
                  impl: str = "auto"):
    """Edge scores ``y[e(, h)] = <A[src(e)(, h), :], B[e, :]>``.

    ``B`` is edge-carried and shared across heads (relative-position
    scores). Reference: ``NodeMulEdge`` (wrapper.py:32-42,
    graphop_kernel.cu:19-34, 62-94).
    """
    strategy = _resolve(g, impl)
    A3, squeeze = _norm_nodes(A, "A")
    if B.ndim != 2 or B.shape[1] != A3.shape[2]:
        raise ValueError(
            f"B must be (e, d={A3.shape[2]}), got {B.shape}"
        )
    if strategy == "tiled":
        # No tiled NodeMulEdge kernel exists (tile-dense edge features
        # would need (T, R, C, d) storage — a d× blowup for zero matmul
        # gain); EVERY tiled-family impl ("pallas"/"tiled"/auto) routes
        # to the ELL fast path. The substitution is part of the op's
        # contract (round-3 verdict #8; matrix pinned in
        # tests/test_dispatch.py).
        strategy = "ell"
    if strategy != "xla":
        return _dispatch.node_mul_edge(strategy, g, A, B)
    y = _node_mul_edge(impl, g.src, A3, B)
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# Edge softmax
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _edge_softmax(impl, num_segments, ids, x):
    return _xla.edge_softmax_fwd(ids, x, num_segments, sorted_ids=True)


def _esm_f(impl, num_segments, ids, x):
    y = _edge_softmax(impl, num_segments, ids, x)
    return y, (ids, y)


def _esm_b(impl, num_segments, res, dy):
    ids, y = res
    dx = _xla.edge_softmax_bwd(ids, y, dy, num_segments, sorted_ids=True)
    return None, dx


_edge_softmax.defvjp(_esm_f, _esm_b)


def edge_softmax(g: Graph, x: jax.Array, *, by: str = "dst",
                 impl: str = "auto"):
    """Numerically-stable softmax over each node's incident-edge segment.

    ``by="dst"`` normalizes over in-edges (the attention direction),
    ``by="src"`` over out-edges. The reference selects direction by passing
    the row vs column CSR (wrapper.py:231 vs 258); both run sorted segment
    reductions here — the dst direction computes in CSC order and permutes
    back, so no unsorted scatters exist on the hot path.

    Reference: ``SparseSoftmax`` (wrapper.py:8-18, graphop_kernel.cu:171-230).
    Padded edges land in a dummy segment and come back as garbage; they
    never influence real segments.
    """
    strategy = _resolve(g, impl)
    if by not in ("src", "dst"):
        raise ValueError(f"by must be 'src' or 'dst', got {by!r}")
    if strategy != "xla":
        return _dispatch.edge_softmax(strategy, g, x, by)
    x2, squeeze = _norm_edges(x, "x")
    n = g.n_nodes
    if by == "src":
        y = _edge_softmax(impl, n, g.src, x2)
    elif by == "dst":
        y_csc = _edge_softmax(impl, n, g.dst_csc, x2[g.csc_perm])
        y = y_csc[g.csc_perm_inv]
    else:
        raise ValueError(f"by must be 'src' or 'dst', got {by!r}")
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# Vector SpMM
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _vector_spmm(impl, src, dst, csc_perm, dst_csc, edata, x):
    return _xla.vector_spmm_fwd(src, dst, edata, x)


def _vspmm_f(impl, src, dst, csc_perm, dst_csc, edata, x):
    y = _vector_spmm(impl, src, dst, csc_perm, dst_csc, edata, x)
    return y, (src, dst, csc_perm, dst_csc, edata, x)


def _vspmm_b(impl, res, dy):
    src, dst, csc_perm, dst_csc, edata, x = res
    dedata, dx = _xla.vector_spmm_bwd(
        src, dst, csc_perm, dst_csc, edata, x, dy
    )
    return None, None, None, None, dedata, dx


_vector_spmm.defvjp(_vspmm_f, _vspmm_b)


def vector_spmm(g: Graph, edata: jax.Array, x: jax.Array, *,
                impl: str = "auto"):
    """Weighted aggregation ``out[u(, h)] = Σ_{e=(u,v)} edata[e(, h)]·x[v(, h)]``.

    Aggregates over each node's *out*-edges (CSR rows), matching
    ``th.sparse.mm(adj, x)`` semantics (reference: wrapper.py:274/291,
    graphop_kernel.cu:119-130). For in-edge aggregation pass the reversed
    graph (``g.reverse()``) and CSC-permuted ``edata``.
    """
    strategy = _resolve(g, impl)
    x3, sx = _norm_nodes(x, "x")
    e2, se = _norm_edges(edata, "edata")
    if se != sx:
        raise ValueError(
            f"edata/x head-rank mismatch: {edata.shape} vs {x.shape}"
        )
    if e2.shape[1] != x3.shape[1]:
        raise ValueError(
            f"edata heads {e2.shape[1]} != x heads {x3.shape[1]}"
        )
    if strategy != "xla":
        return _dispatch.vector_spmm(strategy, g, edata, x)
    y = _vector_spmm(impl, g.src, g.dst, g.csc_perm, g.dst_csc, e2, x3)
    return y[:, 0, :] if sx else y


def softmax_aggregate_dst(g: Graph, scores: jax.Array, x: jax.Array, *,
                          dropout_fn=None, impl: str = "auto"):
    """Fused ``edge_softmax(by="dst")`` + in-edge aggregation, staying in
    CSC order throughout.

    ``edge_softmax(by="dst")`` permutes scores to CSC order, reduces,
    and permutes back; in-edge aggregation then permutes forward again —
    two cancelling full-edge gathers per layer (round-1 weak #10). This
    helper keeps α in CSC order and feeds it straight to the transpose
    SpMM. Padded edges are masked via ``dst_csc == n`` (no mask gather).

    scores: (E,) or (E, h) canonical order; x: (n, d)/(n, h, d);
    returns out[v] = Σ_{e=(u,v)} softmax_dst(scores)[e] · x[u].
    ``dropout_fn`` (optional) is applied to α in CSC order —
    permutation-invariant in distribution.
    """
    del impl  # this IS the segment path; auto would re-resolve g.reverse()
    s2, ssq = _norm_edges(scores, "scores")
    n = g.n_nodes
    a_csc = _edge_softmax("xla", n, g.dst_csc, s2[g.csc_perm])
    a_csc = jnp.where((g.dst_csc < n)[:, None], a_csc, 0.0)
    if dropout_fn is not None:
        a_csc = dropout_fn(a_csc)
    a_csc = a_csc[:, 0] if ssq else a_csc
    return vector_spmm(g.reverse(), a_csc, x, impl="xla")


# ---------------------------------------------------------------------------
# Generalized message passing (gSDDMM / gSpMM) — pure-XLA conveniences.
# Differentiable via JAX autodiff (segment ops transpose correctly); the
# four primitive ops above remain the custom-kernel surface.
# ---------------------------------------------------------------------------

_BINARY = {
    "mul": lambda a, b: a * b,
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "div": lambda a, b: a / b,
    "dot": lambda a, b: (a * b).sum(-1, keepdims=True),
    "copy_lhs": lambda a, b: a,
    "copy_rhs": lambda a, b: b,
}


def _edge_operand(g: Graph, x, target: str):
    if target == "u":
        return x[jnp.minimum(g.src, x.shape[0] - 1)]
    if target == "v":
        return x[jnp.minimum(g.dst, x.shape[0] - 1)]
    if target == "e":
        return x
    raise ValueError(f"target must be u/v/e, got {target!r}")


def gsddmm(g: Graph, op: str, lhs, rhs=None, *, lhs_target="u",
           rhs_target="v"):
    """Generalized SDDMM: per-edge ``op(lhs[target], rhs[target])``."""
    a = _edge_operand(g, lhs, lhs_target)
    if rhs is None:
        return a
    b = _edge_operand(g, rhs, rhs_target)
    return _BINARY[op](a, b)


def gspmm(g: Graph, op: str, reduce: str, lhs=None, rhs=None, *,
          lhs_target="e", rhs_target="v", to: str = "src"):
    """Generalized SpMM: reduce per-edge messages into node segments.

    ``to="src"`` reduces over out-edges (reference CSR-row semantics),
    ``to="dst"`` over in-edges (via sorted CSC order).
    """
    if lhs is None and rhs is None:
        raise ValueError("need at least one operand")
    if lhs is None:
        msg = _edge_operand(g, rhs, rhs_target)
    elif rhs is None:
        msg = _edge_operand(g, lhs, lhs_target)
    else:
        msg = _BINARY[op](
            _edge_operand(g, lhs, lhs_target),
            _edge_operand(g, rhs, rhs_target),
        )
    n = g.n_nodes
    if to == "src":
        ids, sorted_ids = g.src, True
    elif to == "dst":
        msg = msg[g.csc_perm]
        ids, sorted_ids = g.dst_csc, True
    else:
        raise ValueError(f"to must be 'src' or 'dst', got {to!r}")
    if reduce == "sum":
        return _xla.segment_sum(msg, ids, n, sorted_ids=sorted_ids)
    if reduce == "mean":
        s = _xla.segment_sum(msg, ids, n, sorted_ids=sorted_ids)
        cnt = _xla.segment_sum(
            jnp.ones(msg.shape[:1], msg.dtype), ids, n, sorted_ids=sorted_ids
        )
        return s / jnp.maximum(cnt, 1.0).reshape(
            (n,) + (1,) * (s.ndim - 1)
        )
    if reduce == "max":
        return _xla.segment_max(msg, ids, n, sorted_ids=sorted_ids)
    if reduce == "min":
        # Reference parity: atomic.cuh defines AtomicMin alongside Max —
        # same sorted-segment reduction with the sign flipped.
        return -_xla.segment_max(-msg, ids, n, sorted_ids=sorted_ids)
    raise ValueError(f"reduce must be sum/mean/max/min, got {reduce!r}")


# ---------------------------------------------------------------------------
# Whole-layer fused ops with strategy dispatch — the compositions the
# reference benchmarks piecewise (wrapper.py:201-291), one call each.
# ---------------------------------------------------------------------------

def attention(g: Graph, q: jax.Array, k: jax.Array, v: jax.Array, *,
              edge_bias: jax.Array = None, scale: float = None,
              impl: str = "auto"):
    """Fused masked attention: ``score[e] = (<q[dst], k[src]> +
    <q[src], edge_bias[e]>)·scale``, softmax over in-edges of dst,
    ``out[v] = Σ α·v_feat[src]``.

    One call runs the whole reference pipeline MaskedMMCSR →
    [NodeMulEdge →] SparseSoftmax → VectorSPMM (wrapper.py:201-291) on
    the execution strategy ``impl`` resolves to — component-batched
    dense blocks, BSR tiles, degree-bucketed ELL, or composed segment
    ops — with each strategy's fused gradients. q, k, v: (n, d) or
    (n, h, d); ``edge_bias`` (E, d) is the relative-position score
    term (shared across heads — the reference built NodeMulEdge for
    exactly this, graphop_kernel.cu:17). The tiled strategy has no
    edge-feature kernel; with ``edge_bias`` it routes to ELL (same
    substitution as node_mul_edge).
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    strategy = _resolve(g, impl)
    if edge_bias is not None and not isinstance(edge_bias, jax.Array):
        # PackedEdgeWeights live in the ELL layout — only that strategy
        # can consume them (ell_pack_weights(se, de, be)).
        strategy = "ell"
    elif strategy == "tiled" and edge_bias is not None:
        strategy = "ell"
    if strategy != "xla":
        return _dispatch.attention(strategy, g, q, k, v, float(scale),
                                   edge_bias)
    scores = sddmm(g, k, q, impl="xla")
    if edge_bias is not None:
        scores = scores + node_mul_edge(g, q, edge_bias, impl="xla")
    return softmax_aggregate_dst(
        g, scores * jnp.asarray(scale, scores.dtype), v)


def gat_attention(g: Graph, a_l: jax.Array, a_r: jax.Array,
                  z: jax.Array, *, negative_slope: float = 0.2,
                  impl: str = "auto"):
    """Fused additive (GAT) attention:
    ``score[e] = LeakyReLU(a_l·z[src] + a_r·z[dst])``, softmax over
    in-edges of dst, ``out[v] = Σ α·z[src]``.

    a_l, a_r: (h, d); z: (n, h, d). The tiled strategy has no additive-
    score kernel — ``impl="pallas"``/"tiled"/"auto"-on-blocky-tilings
    route to ELL (same substitution as node_mul_edge).
    """
    if z.ndim != 3 or a_l.ndim != 2 or a_r.ndim != 2:
        raise ValueError(
            f"gat_attention wants z (n, h, d) and a_l/a_r (h, d); got "
            f"{z.shape}, {a_l.shape}, {a_r.shape}"
        )
    strategy = _resolve(g, impl)
    if strategy == "tiled":
        strategy = "ell"
    if strategy != "xla":
        return _dispatch.gat_attention(strategy, g, a_l, a_r, z,
                                       float(negative_slope))
    el = jnp.einsum("nhd,hd->nh", z, a_l)
    er = jnp.einsum("nhd,hd->nh", z, a_r)
    n = z.shape[0]
    s = (el[jnp.minimum(g.src, n - 1)] + er[jnp.minimum(g.dst, n - 1)])
    s = jax.nn.leaky_relu(s, negative_slope)
    return softmax_aggregate_dst(g, s, z)
