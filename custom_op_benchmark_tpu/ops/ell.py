"""The op family on the ELL (degree-bucketed) layout — general graphs.

Same semantic contracts as ops/primitives.py (SURVEY.md §2.3), tuned for
graphs with no block structure. Design rules (set when this layout was
first tuned; each is to be re-judged on the GPU against the segment form
— see graph/ell.py):

- **never scatter**: node outputs are assembled by gathering bucket
  contributions through the precomputed ``row_pos`` inverse permutation;
  canonical edge outputs through ``edge_pos``;
- segment reductions (softmax max/sum) are dense masked reductions over
  each bucket's width axis;
- backward passes run the forward sweeps over the transpose packing —
  the reference's dual-CSR trick (graphop_kernel.cu:355-409, 544-600);
- :func:`ell_attention` fuses SDDMM → edge-softmax → SpMM without ever
  materializing a canonical-edge-order tensor in the forward pass.

All ops take the dual packing ``(src_ell, dst_ell)`` from
:func:`ell_dual` where a transpose traversal is needed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from custom_op_benchmark_tpu.graph.ell import EllGraph, ell_pack
from custom_op_benchmark_tpu.graph.graph import Graph


def ell_dual(g: Graph, profile: str = None,
             **kw) -> Tuple[EllGraph, EllGraph]:
    """(out-edge packing, in-edge packing) sharing canonical edge ids.

    Each packing carries ``twin_slot`` — the direct slot→slot map into
    the other packing — so backward passes convert packed edge tensors
    with one gather (no canonical intermediate).

    ``profile="train"`` selects the fine bucket ladder
    (graph/ell.TRAIN_WIDTHS): measured faster for GRADIENT steps
    (backward cost scales with padded slot count) and slower for
    forward-only sweeps — see the ladder table in the constant's
    comment. Default (None) keeps the pow-2 inference ladder.
    """
    import dataclasses as _dc

    if profile is not None:
        if profile != "train":
            raise ValueError(f"profile must be None or 'train', "
                             f"got {profile!r}")
        from custom_op_benchmark_tpu.graph.ell import TRAIN_WIDTHS

        kw.setdefault("widths", TRAIN_WIDTHS)

    se = ell_pack(g, direction="src", **kw)
    de = ell_pack(g, direction="dst", **kw)

    def _twin(me: EllGraph, other: EllGraph):
        other_pos = np.asarray(jax.device_get(other.edge_pos))
        e_pad = me.num_edges_padded
        maps = []
        for b in me.buckets:
            eid = np.asarray(jax.device_get(b.eid))
            t = np.where(
                eid < e_pad,
                other_pos[np.minimum(eid, e_pad - 1)],
                other.total_slots,
            ).astype(np.int32)
            maps.append(jnp.asarray(t))
        return _dc.replace(me, twin_slot=maps)

    return _twin(se, de), _twin(de, se)


def _pad_nodes(x, n):
    """(n, ...) → (n+1, ...): dummy row for padded cols."""
    return jnp.pad(x, [(0, n + 1 - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def _pad_edges(w, e_slot):
    return jnp.pad(w, [(0, e_slot + 1 - w.shape[0])] + [(0, 0)] * (w.ndim - 1))


# ---------------------------------------------------------------------------
# Packed-layout plumbing (all gathers)
# ---------------------------------------------------------------------------

def ell_scatter_edges(ell: EllGraph, x) -> List[jax.Array]:
    """Canonical (E_pad, ...) → per-bucket packed (R, D, ...) list."""
    xp = _pad_edges(x, ell.num_edges_padded)
    return [xp[b.eid] for b in ell.buckets]


def ell_gather_edges(ell: EllGraph, packed: List[jax.Array]) -> jax.Array:
    """Per-bucket packed list → canonical (E_pad, ...) via edge_pos."""
    trail = packed[0].shape[2:]
    flat = jnp.concatenate(
        [p.reshape((-1,) + trail) for p in packed]
        + [jnp.zeros((1,) + trail, packed[0].dtype)],
        axis=0,
    )
    return flat[ell.edge_pos]


def ell_cross_packed(src_packing: EllGraph, dst_packing: EllGraph,
                     packed: List[jax.Array]) -> List[jax.Array]:
    """Re-pack per-slot edge values from ``src_packing``'s layout into
    ``dst_packing``'s, via the precomputed twin_slot map (one gather) or
    a canonical round trip if the packings weren't built by ell_dual."""
    if dst_packing.twin_slot is not None:
        trail = packed[0].shape[2:] if packed else ()
        flat = jnp.concatenate(
            [p.reshape((-1,) + trail) for p in packed]
            + [jnp.zeros((1,) + trail, packed[0].dtype)],
            axis=0,
        )
        return [flat[t] for t in dst_packing.twin_slot]
    return ell_scatter_edges(
        dst_packing, ell_gather_edges(src_packing, packed)
    )


def ell_cross_packed_materialized(src_packing, dst_packing, packed):
    """The twin hop fenced with optimization barriers on BOTH sides.

    Reason: narrow per-slot gathers were found ROW-bound (their cost
    set by the row count, not the bytes). When the hop's (R, D, c)
    output feeds multiple einsums, XLA's fusion can DUPLICATE the
    row-bound gather into each consumer instead of materializing it
    once; fencing the hop input and output forces exactly one
    materialized gather. (Splitting channels into single-consumer
    scalar hops so each fuses was worse: each fused narrow gather still
    pays the full row-bound cost.)
    """
    packed = jax.lax.optimization_barrier(packed)
    out = ell_cross_packed(src_packing, dst_packing, packed)
    return jax.lax.optimization_barrier(out)


def ell_combine_rows(ell: EllGraph, contribs: List[jax.Array]) -> jax.Array:
    """Per-bucket (R, ...) row contributions → (n_nodes, ...) via row_pos."""
    trail = contribs[0].shape[1:]
    cat = jnp.concatenate(
        contribs + [jnp.zeros((1,) + trail, contribs[0].dtype)], axis=0
    )
    return cat[ell.row_pos]


def _row_mask(b, n, ndim_extra):
    m = b.cols < n                                # (R, D)
    return m.reshape(m.shape + (1,) * ndim_extra)


# ---------------------------------------------------------------------------
# Raw bucket sweeps (shared by forwards and backwards)
# ---------------------------------------------------------------------------

def _spmm_packed(eg: EllGraph, w_packed: List[jax.Array], x):
    """contrib[r] = Σ_k w[r,k] · x[cols[r,k]] per bucket; returns list.

    Multihead: one flat (R, D, h·d) gather per bucket, heads batched
    through the block-indicator matmul on ROW-scale operands (see
    _attn_fwd_impl — per-head lane slices cost 2.3×, slot-scale head
    expansion OOMs). Per-slot weights (R, D, h) are accepted as given;
    outputs come back (R, h, d).
    """
    if x.ndim == 2:
        xp = _pad_nodes(x, eg.n_nodes)
        outs = []
        for b, w in zip(eg.buckets, w_packed):
            outs.append(jnp.einsum(
                "rk,rkd->rd", w, xp[b.cols],
                preferred_element_type=jnp.float32).astype(x.dtype))
        return outs
    n, h, d = x.shape
    xp2 = _pad_nodes(x.reshape(n, h * d), eg.n_nodes)
    heads_m = _head_matrix(max(h, 2), d)[: h * d, : h]
    outs = []
    for b, w in zip(eg.buckets, w_packed):
        xg2 = xp2[b.cols]                 # (R, D, h·d) — single consumer
        out_full = jnp.einsum("rkh,rkc->rhc", w, xg2,
                              preferred_element_type=jnp.float32)
        out = jnp.einsum("rhc,ch->rc", out_full, heads_m,
                         preferred_element_type=jnp.float32)
        outs.append(out.reshape(-1, h, d).astype(x.dtype))
    return outs


def _sddmm_packed(eg: EllGraph, A, B):
    """s[r,k] = <A[rows[r]], B[cols[r,k]]> per bucket; returns list.
    Multihead batched like _spmm_packed."""
    if A.ndim == 2:
        Ap, Bp = _pad_nodes(A, eg.n_nodes), _pad_nodes(B, eg.n_nodes)
        outs = []
        for b in eg.buckets:
            outs.append(jnp.einsum(
                "rd,rkd->rk", Ap[b.rows], Bp[b.cols],
                preferred_element_type=jnp.float32).astype(A.dtype))
        return outs
    n, h, d = A.shape
    Ap2 = _pad_nodes(A.reshape(n, h * d), eg.n_nodes)
    Bp2 = _pad_nodes(B.reshape(B.shape[0], h * d), eg.n_nodes)
    heads_m = _head_matrix(max(h, 2), d)[: h * d, : h]
    outs = []
    for b in eg.buckets:
        ah = Ap2[b.rows][:, :, None] * heads_m[None]   # (R, h·d, h)
        bg2 = Bp2[b.cols]                  # (R, D, h·d) — single consumer
        outs.append(jnp.einsum(
            "rkc,rch->rkh", bg2, ah,
            preferred_element_type=jnp.float32).astype(A.dtype))
    return outs


def _softmax_packed(eg: EllGraph, s_packed: List[jax.Array]):
    """Dense masked softmax over each packed row (whole segments)."""
    outs = []
    for b, s in zip(eg.buckets, s_packed):
        mask = _row_mask(b, eg.n_nodes, s.ndim - 2)
        sm = jnp.where(mask, s, -1e30)
        m = jax.lax.stop_gradient(jnp.max(sm, axis=1, keepdims=True))
        z = jnp.where(mask, jnp.exp(sm - m), 0)
        denom = jnp.sum(z, axis=1, keepdims=True)
        outs.append((z / jnp.maximum(denom, 1e-30)).astype(s.dtype))
    return outs


def _spmm_raw(eg, edata, x):
    if not eg.buckets:   # zero-edge graph: match the oracle's zeros
        return jnp.zeros((eg.n_nodes,) + x.shape[1:], x.dtype)
    return ell_combine_rows(eg, _spmm_packed(
        eg, ell_scatter_edges(eg, edata), x
    ))


def _sddmm_raw(eg, A, B):
    if not eg.buckets:
        return jnp.zeros(
            (eg.num_edges_padded,) + A.shape[1:-1], A.dtype
        )
    return ell_gather_edges(eg, _sddmm_packed(eg, A, B))


# ---------------------------------------------------------------------------
# ell_spmm
# ---------------------------------------------------------------------------

@jax.custom_vjp
def _ell_spmm(src_ell, dst_ell, edata, x):
    return _spmm_raw(src_ell, edata, x)


def _ell_spmm_fwd(src_ell, dst_ell, edata, x):
    return _spmm_raw(src_ell, edata, x), (src_ell, dst_ell, edata, x)


def _ell_spmm_bwd(res, dy):
    src_ell, dst_ell, edata, x = res
    dedata = _sddmm_raw(src_ell, dy, x)[: edata.shape[0]]
    dx = _spmm_raw(dst_ell, edata, dy)[: x.shape[0]]
    return None, None, dedata.astype(edata.dtype), dx.astype(x.dtype)


_ell_spmm.defvjp(_ell_spmm_fwd, _ell_spmm_bwd)


def ell_spmm(src_ell: EllGraph, dst_ell: EllGraph, edata, x):
    """y[u] = Σ_{e=(u,v)} edata[e]·x[v] — reference vector_spmm
    (graphop_kernel.cu:119-130) on the ELL layout.

    edata: (E,) or (E, h) canonical order — or a
    :class:`PackedEdgeWeights` (see :func:`ell_pack_weights`), which
    skips the per-edge scalar gather entirely (the round-1 bottleneck:
    canonical→packed weight conversion ran at ~150 M el/s and made
    weighted ELL SpMM *lose* to the segment oracle).
    x: (n, d) or (n, h, d).
    """
    if isinstance(edata, PackedEdgeWeights):
        return _ell_spmm_packed(src_ell, dst_ell, edata, x)
    e_slot = src_ell.num_edges_padded
    if edata.shape[0] < e_slot:
        edata = _pad_edges(edata, e_slot - 1)
    return _ell_spmm(src_ell, dst_ell, edata, x)


# ---------------------------------------------------------------------------
# Packed-weight SpMM: static/per-step-constant edge weights live in ELL
# slot order (both packings), so the hot path never touches canonical
# edge order at all. This is the power-law-regime answer to the
# reference's weighted spmm (graphop_kernel.cu:119-130, 509-542): where
# the reference gathers edata[eid] per edge inside the kernel, this
# layout stores the weights pre-gathered.
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackedEdgeWeights:
    """Edge weights resident in BOTH ELL packings' slot order.

    ``src[i]`` has the src packing's bucket-i shape (R, D) or (R, D, h);
    ``dst[i]`` likewise for the dst packing. The two copies carry the
    same per-edge values; keeping both makes every sweep in fwd+bwd a
    plain contiguous read (the backward's transpose sweep needs
    dst-packed weights, and cross-packing at run time would be the exact
    per-slot gather this layout exists to avoid). The VJP returns
    cotangents for both copies (mathematically equal per edge), so
    packed-resident weights can be trained directly.
    """

    src: List[jax.Array]
    dst: List[jax.Array]


def ell_pack_weights(src_ell: EllGraph, dst_ell: EllGraph,
                     edata) -> PackedEdgeWeights:
    """Cold path: canonical (E,)/(E, h) weights → dual packed layout."""
    e_slot = src_ell.num_edges_padded
    if edata.shape[0] < e_slot:
        edata = _pad_edges(edata, e_slot - 1)
    return PackedEdgeWeights(
        src=ell_scatter_edges(src_ell, edata),
        dst=ell_scatter_edges(dst_ell, edata),
    )


def ell_unpack_weights(src_ell: EllGraph, w: PackedEdgeWeights):
    """Packed → canonical (E_pad, ...) order (via the src copy)."""
    return ell_gather_edges(src_ell, w.src)


def _spmm_sddmm_fused(eg: EllGraph, w_packed, a_nodes, b_nodes):
    """Per bucket, with ONE gather of ``b_nodes`` through cols:
      spmm[r]   = Σ_k w[r,k] · b[cols[r,k]]          (uses the gather)
      score[r,k] = <a[rows[r]], b[cols[r,k]]>         (reuses it)
    Returns (spmm contribs list, score list). Multihead: w (R, D, h),
    a/b (n, h·d) flat; scores (R, D, h)."""
    multi = a_nodes.ndim == 2 and w_packed and w_packed[0].ndim == 3
    ap = _pad_nodes(a_nodes, eg.n_nodes)
    bp = _pad_nodes(b_nodes, eg.n_nodes)
    f32 = jnp.float32
    spmms, scores = [], []
    for b, w in zip(eg.buckets, w_packed):
        bg2 = bp[b.cols]                         # (R, D, h·d) — one gather
        ar2 = ap[b.rows]
        if not multi:
            spmms.append(jnp.einsum("rk,rkd->rd", w, bg2,
                                    preferred_element_type=f32))
            scores.append(jnp.einsum("rd,rkd->rk", ar2, bg2,
                                     preferred_element_type=f32))
            continue
        # Heads batched through the block-indicator matmul (round-3:
        # this was the last per-head slice_in_dim loop left — the
        # measured 2.3× lane-slice pattern). bg2 feeds TWO einsums
        # (down from 2h slice consumers); the helper's contract is one
        # shared gather for both reductions.
        h = w.shape[-1]
        d = bg2.shape[-1] // h
        heads_m = _head_matrix(max(h, 2), d)[: h * d, : h]
        out_full = jnp.einsum("rkh,rkc->rhc", w, bg2,
                              preferred_element_type=f32)
        spmms.append(jnp.einsum("rhc,ch->rc", out_full, heads_m,
                                preferred_element_type=f32))  # (R, h·d)
        ah = ar2[:, :, None] * heads_m[None]           # (R, h·d, h)
        scores.append(jnp.einsum("rkc,rch->rkh", bg2, ah,
                                 preferred_element_type=f32))  # (R, D, h)
    return spmms, scores


def _flat_nodes(x):
    return x if x.ndim == 2 else x.reshape(x.shape[0], -1)


@jax.custom_vjp
def _ell_spmm_packed(src_ell, dst_ell, w, x):
    out = ell_combine_rows(
        src_ell, _spmm_packed(src_ell, w.src, x)
    )[: x.shape[0]]
    return out.reshape(x.shape).astype(x.dtype)


def _ell_spmm_packed_fwd(src_ell, dst_ell, w, x):
    return _ell_spmm_packed(src_ell, dst_ell, w, x), (
        src_ell, dst_ell, w, x
    )


def _ell_spmm_packed_bwd(res, dy):
    """Two wide-gather passes, cotangents stay packed:

      dst pass: ONE dy gather per bucket → dx[v] = Σ w·dy[u]  AND
                dW_dst[r,k] = <x[rows], dy[cols]> (shared tile);
      src pass: ONE x gather per bucket → dW_src[r,k] = <dy[rows], x[cols]>.

    Reference decomposition (SDDMM-of-grads + transpose SpMM,
    graphop_kernel.cu:544-600) with both sweeps gather-only."""
    src_ell, dst_ell, w, x = res
    xf = _flat_nodes(x)
    dyf = _flat_nodes(dy)
    dx_contribs, dw_dst = _spmm_sddmm_fused(dst_ell, w.dst, xf, dyf)
    dx = ell_combine_rows(dst_ell, dx_contribs)[: x.shape[0]]
    _, dw_src = _spmm_sddmm_fused(src_ell, w.src, dyf, xf)
    dw = PackedEdgeWeights(
        src=[g.astype(ws.dtype) for g, ws in zip(dw_src, w.src)],
        dst=[g.astype(wd.dtype) for g, wd in zip(dw_dst, w.dst)],
    )
    return None, None, dw, dx.reshape(x.shape).astype(x.dtype)


_ell_spmm_packed.defvjp(_ell_spmm_packed_fwd, _ell_spmm_packed_bwd)


# ---------------------------------------------------------------------------
# ell_sddmm
# ---------------------------------------------------------------------------

@jax.custom_vjp
def _ell_sddmm(src_ell, dst_ell, A, B):
    return _sddmm_raw(src_ell, A, B)


def _ell_sddmm_fwd(src_ell, dst_ell, A, B):
    return _sddmm_raw(src_ell, A, B), (src_ell, dst_ell, A, B)


def _ell_sddmm_bwd(res, dy):
    src_ell, dst_ell, A, B = res
    dA = _spmm_raw(src_ell, dy, B)[: A.shape[0]]
    dB = _spmm_raw(dst_ell, dy, A)[: B.shape[0]]
    return None, None, dA.astype(A.dtype), dB.astype(B.dtype)


_ell_sddmm.defvjp(_ell_sddmm_fwd, _ell_sddmm_bwd)


def ell_sddmm(src_ell: EllGraph, dst_ell: EllGraph, A, B):
    """score[e] = <A[src(e)], B[dst(e)]> — reference maskedmm_csr
    (graphop_kernel.cu:41-55) on the ELL layout. Returns (E_pad, ...)."""
    return _ell_sddmm(src_ell, dst_ell, A, B)


# ---------------------------------------------------------------------------
# ell_softmax
# ---------------------------------------------------------------------------

@jax.custom_vjp
def _ell_softmax(ell, x):
    if not ell.buckets:
        return jnp.zeros_like(x)
    return ell_gather_edges(
        ell, _softmax_packed(ell, ell_scatter_edges(ell, x))
    )


def _ell_softmax_fwd(ell, x):
    y = _ell_softmax(ell, x)
    return y, (ell, y)


def _ell_softmax_bwd(res, dy):
    ell, y = res
    if not ell.buckets:
        return None, jnp.zeros_like(y)
    outs = []
    for b, yb, dyb in zip(
        ell.buckets, ell_scatter_edges(ell, y), ell_scatter_edges(ell, dy)
    ):
        agg = jnp.sum(yb * dyb, axis=1, keepdims=True)
        outs.append((yb * (dyb - agg)).astype(y.dtype))
    return None, ell_gather_edges(ell, outs)[: y.shape[0]]


_ell_softmax.defvjp(_ell_softmax_fwd, _ell_softmax_bwd)


def ell_softmax(ell: EllGraph, x):
    """Numerically-stable segment softmax over ``ell.direction`` segments
    (reference sparse_softmax, graphop_kernel.cu:171-202): a dense masked
    softmax per packed row; the VJP ``dx = y⊙(dy − Σ_seg y·dy)`` is dense
    per bucket row too.

    x: (E,) or (E, h) canonical edge order.
    """
    e_slot = ell.num_edges_padded
    if x.shape[0] < e_slot:
        x = _pad_edges(x, e_slot - 1)
    return _ell_softmax(ell, x)


# ---------------------------------------------------------------------------
# Fused attention — no canonical edge tensors in the forward pass
# ---------------------------------------------------------------------------

def _heads(x):
    """(n, d) → flat view + (h=1, d); (n, h, d) → (n, h·d) + (h, d)."""
    if x.ndim == 2:
        return x, 1, x.shape[1]
    return x.reshape(x.shape[0], -1), x.shape[1], x.shape[2]


def _attn_fwd_impl(ell, q, k, v, scale, want_res):
    """Shared forward sweep.

    Layout law (measured, scripts/exp_attn_variants.py): keep every
    per-slot gather SINGLE-CONSUMER so XLA fuses it into its einsum —
    stacking k‖v into one gather forces the (R, D, 2hd) tile to
    materialize in HBM and runs ~1.8× slower. So: separate k and v
    gathers, each feeding exactly one contraction.

    With ``want_res`` also returns the flash-attention residual:
    per-bucket packed α, reused by the backward's dst pass with no
    score recompute.

    Multihead runs HEADS-IN-THE-SWEEP (round-1 weak #3 — the per-head
    ``slice_in_dim`` loop measured 2.3× single-head at equal e·d): all
    heads share one full-lane ``(R, D, h·d)`` elementwise product, and
    the per-head reductions go through the tiny ``(h·d, h)``
    block-indicator matmul — so the VPU never runs on a d<128 lane
    slice. Reference analog: heads looped inside one kernel launch
    (graphop_kernel.cu:25, 421-422).
    """
    q2, h, d = _heads(q)
    k2, _, _ = _heads(k)
    v2, _, _ = _heads(v)
    f32 = jnp.float32
    kp = _pad_nodes(k2, ell.n_nodes)
    vp = _pad_nodes(v2, ell.n_nodes)
    qp = _pad_nodes(q2, ell.n_nodes)
    heads_m = _head_matrix(h, d)                  # (h·d, h) or None
    outs, alphas = [], []
    for b in ell.buckets:
        kg2 = kp[b.cols]                      # feeds the score einsum
        vg2 = vp[b.cols]                      # feeds the output einsum
        qr2 = qp[b.rows]
        mask = b.cols < ell.n_nodes
        if h == 1:
            s = jnp.einsum("rd,rkd->rk", qr2, kg2,
                           preferred_element_type=f32) * scale
            sm = jnp.where(mask, s, -1e30)
            m = jnp.max(sm, axis=1, keepdims=True)
            zexp = jnp.where(mask, jnp.exp(sm - m), 0)
            den = jnp.sum(zexp, axis=1, keepdims=True)
            alpha = zexp / jnp.maximum(den, 1e-30)
            outs.append(jnp.einsum(
                "rk,rkd->rd", alpha, vg2,
                preferred_element_type=f32).astype(q.dtype))
            if want_res:
                alphas.append(alpha)
            continue
        # All per-head reductions are batched matmuls whose
        # intermediates are ROW-scale (R, h·d, h), never SLOT-scale
        # (R, D, h·d) — an e-scale expanded intermediate OOMs at ogbn
        # sizes (4+ GB at 5M edges).
        qh = qr2[:, :, None] * heads_m[None]           # (R, h·d, h)
        s = jnp.einsum("rkc,rch->rkh", kg2, qh,
                       preferred_element_type=f32) * scale
        sm = jnp.where(mask[:, :, None], s, -1e30)
        m = jnp.max(sm, axis=1, keepdims=True)
        zexp = jnp.where(mask[:, :, None], jnp.exp(sm - m), 0)
        den = jnp.sum(zexp, axis=1, keepdims=True)
        alpha = zexp / jnp.maximum(den, 1e-30)
        out_full = jnp.einsum("rkh,rkc->rhc", alpha, vg2,
                              preferred_element_type=f32)
        outs.append(jnp.einsum("rhc,ch->rc", out_full, heads_m,
                               preferred_element_type=f32
                               ).astype(q.dtype))
        if want_res:
            alphas.append(alpha)                       # (R, D, h)
    y = ell_combine_rows(ell, outs)[: q.shape[0]].reshape(q.shape)
    return y, (alphas if want_res else None)


def _head_matrix(h, d):
    """(h·d, h) block-indicator: column i is 1 on head i's d-slice."""
    if h == 1:
        return None
    return jnp.repeat(jnp.eye(h, dtype=jnp.float32), d, axis=0)


@jax.custom_vjp
def _ell_attention(ell, ell_t, q, k, v, scale):
    if not ell.buckets:
        return jnp.zeros_like(q)
    return _attn_fwd_impl(ell, q, k, v, scale, False)[0]


def _ell_attention_fwd(ell, ell_t, q, k, v, scale):
    if not ell.buckets:
        return jnp.zeros_like(q), (ell, ell_t, q, k, v, scale, None)
    y, alphas = _attn_fwd_impl(ell, q, k, v, scale, True)
    return y, (ell, ell_t, q, k, v, scale, alphas)


def _ell_attention_bwd(res, dy):
    """Flash-style backward built around the measured layout laws
    (scripts/exp_attn_variants.py — keep per-slot gathers
    single-consumer so XLA fuses them into their einsums):

      pass 1 (dst packing): α comes straight from the saved packed
        residual (no score recompute), so the k gather feeds only the
        dq einsum and the v gather only the dα einsum; dS is packed
        alongside α for the hop.
      pass 2 (src packing): α_t/dS_t arrive through the twin-slot hop,
        so the q and dy gathers each feed exactly one reduction. The
        alternative — rebuilding α_t from node-indexed softmax stats —
        makes q_c/dy_c double-consumers and measured slower (the two
        1 GB tile materializations cost more than the hop).

    Reference analog: the bwd kernel pair at graphop_kernel.cu:544-600
    (SDDMM-of-grads + transpose-graph sweep).
    """
    ell, ell_t, q, k, v, scale, alphas = res
    if not ell.buckets:
        return (None, None, jnp.zeros_like(q), jnp.zeros_like(k),
                jnp.zeros_like(v), None)
    q2, h, d = _heads(q)
    n = ell.n_nodes
    f32 = jnp.float32
    qf = q2.astype(f32)
    dyf = _heads(dy)[0].astype(f32)
    kp = _pad_nodes(_heads(k)[0], n)
    vp = _pad_nodes(_heads(v)[0], n)
    qp = _pad_nodes(qf, n)
    dyp = _pad_nodes(dyf, n)

    # ---- pass 1: dst packing — dq + the packed (α, dS) channel stack
    # for the twin hop (α from the forward residual, no score
    # recompute). Multihead: heads-in-the-sweep via the block-indicator
    # matmul, no per-head lane slices. ----
    heads_m = _head_matrix(h, d)
    dq_contribs, packed_both = [], []
    for b, alpha in zip(ell.buckets, alphas):
        kg2 = kp[b.cols]                       # feeds dq einsum only
        vg2 = vp[b.cols]                       # feeds dα einsum only
        dyr2 = dyp[b.rows]
        if h == 1:
            dalpha = jnp.einsum("rd,rkd->rk", dyr2, vg2,
                                preferred_element_type=f32)
            agg = jnp.sum(alpha * dalpha, axis=1)
            dS = alpha * (dalpha - agg[:, None]) * scale
            dq_contribs.append(jnp.einsum(
                "rk,rkd->rd", dS, kg2, preferred_element_type=f32))
            packed_both.append(jnp.stack([alpha, dS], axis=-1))
        else:
            dyh = dyr2[:, :, None] * heads_m[None]     # (R, h·d, h)
            dalpha = jnp.einsum("rkc,rch->rkh", vg2, dyh,
                                preferred_element_type=f32)
            agg = jnp.sum(alpha * dalpha, axis=1, keepdims=True)
            dS = alpha * (dalpha - agg) * scale
            dq_full = jnp.einsum("rkh,rkc->rhc", dS, kg2,
                                 preferred_element_type=f32)
            dq_contribs.append(jnp.einsum(
                "rhc,ch->rc", dq_full, heads_m,
                preferred_element_type=f32))           # (R, h·d)
            packed_both.append(
                jnp.concatenate([alpha, dS], axis=-1))  # (R, D, 2h)
    dq = ell_combine_rows(ell, dq_contribs)[: q.shape[0]].reshape(q.shape)

    # ---- pass 2: src packing — dk/dv with α/dS crossing through the
    # twin-slot hop, so the q and dy gathers stay SINGLE-consumer
    # (measured: recomputing α_t from node stats makes q_c/dy_c
    # double-consumers, which materializes both 1 GB tiles and costs
    # more than the hop; see scripts/exp_attn_variants.py) ----
    both_t = ell_cross_packed_materialized(ell, ell_t, packed_both)
    dk_contribs, dv_contribs = [], []
    for b, bt in zip(ell_t.buckets, both_t):
        q_c2 = qp[b.cols]                      # dk einsum only
        dy_c2 = dyp[b.cols]                    # dv einsum only
        if h == 1:
            alpha_t = bt[..., 0]
            dS_t = bt[..., 1]
            dk_contribs.append(jnp.einsum(
                "rk,rkd->rd", dS_t, q_c2, preferred_element_type=f32))
            dv_contribs.append(jnp.einsum(
                "rk,rkd->rd", alpha_t, dy_c2,
                preferred_element_type=f32))
        else:
            alpha_t = bt[..., :h]
            dS_t = bt[..., h:]
            dk_full = jnp.einsum("rkh,rkc->rhc", dS_t, q_c2,
                                 preferred_element_type=f32)
            dk_contribs.append(jnp.einsum(
                "rhc,ch->rc", dk_full, heads_m,
                preferred_element_type=f32))
            dv_full = jnp.einsum("rkh,rkc->rhc", alpha_t, dy_c2,
                                 preferred_element_type=f32)
            dv_contribs.append(jnp.einsum(
                "rhc,ch->rc", dv_full, heads_m,
                preferred_element_type=f32))
    dk = ell_combine_rows(ell_t, dk_contribs)[: k.shape[0]].reshape(k.shape)
    dv = ell_combine_rows(ell_t, dv_contribs)[: v.shape[0]].reshape(v.shape)
    return (None, None, dq.astype(q.dtype), dk.astype(k.dtype),
            dv.astype(v.dtype), None)


_ell_attention.defvjp(_ell_attention_fwd, _ell_attention_bwd)


# ---------------------------------------------------------------------------
# Unweighted neighbor aggregation (GCN / GraphSAGE's gspmm copy_lhs)
# ---------------------------------------------------------------------------

def _copy_agg_raw(eg: EllGraph, x):
    """Unweighted copy-SUM per packed row (mean = sum/deg in the public
    op, keeping this VJP a pure transpose copy-sum)."""
    if not eg.buckets:
        return jnp.zeros((eg.n_nodes,) + x.shape[1:], x.dtype)
    xp = _pad_nodes(x, eg.n_nodes)
    outs = []
    for b in eg.buckets:
        xg = xp[b.cols]
        mask = _row_mask(b, eg.n_nodes, xg.ndim - 2)
        outs.append(jnp.sum(jnp.where(mask, xg, 0), axis=1))
    return ell_combine_rows(eg, outs)


@jax.custom_vjp
def _ell_copy_sum(ell, ell_t, x):
    return _copy_agg_raw(ell, x)


def _ell_copy_sum_fwd(ell, ell_t, x):
    return _copy_agg_raw(ell, x), (ell, ell_t, x)


def _ell_copy_sum_bwd(res, dy):
    ell, ell_t, x = res
    return None, None, _copy_agg_raw(ell_t, dy)[: x.shape[0]]


_ell_copy_sum.defvjp(_ell_copy_sum_fwd, _ell_copy_sum_bwd)


def ell_copy_spmm(ell: EllGraph, ell_t: EllGraph, x, *,
                  reduce: str = "sum"):
    """out[rows] = reduce over neighbors of x[cols] — the unweighted
    aggregation of GCN/GraphSAGE (gspmm copy_lhs). ``mean`` is ``sum``
    scaled by degree (so the VJP stays a pure transpose copy-sum)."""
    if reduce == "sum":
        return _ell_copy_sum(ell, ell_t, x)
    if reduce == "mean":
        y = _ell_copy_sum(ell, ell_t, x)
        deg = _copy_agg_raw(ell, jnp.ones((ell.n_nodes, 1), x.dtype))
        deg = deg.reshape((-1,) + (1,) * (y.ndim - 1))
        return y / jnp.maximum(deg, 1)
    raise ValueError(f"reduce must be sum/mean, got {reduce!r}")


# ---------------------------------------------------------------------------
# NodeMulEdge (edge-carried features — relative positional scores)
# ---------------------------------------------------------------------------

def _nme_raw(ell: EllGraph, A, Be):
    Ap = _pad_nodes(A, ell.n_nodes)
    be_packed = ell_scatter_edges(ell, Be)
    outs = []
    for b, beb in zip(ell.buckets, be_packed):
        ar = Ap[b.rows]
        if A.ndim == 2:
            outs.append(jnp.einsum("rd,rkd->rk", ar, beb,
                                   preferred_element_type=jnp.float32
                                   ).astype(A.dtype))
        else:
            outs.append(jnp.einsum("rhd,rkd->rkh", ar, beb,
                                   preferred_element_type=jnp.float32
                                   ).astype(A.dtype))
    return ell_gather_edges(ell, outs)


@jax.custom_vjp
def _ell_nme(ell, A, Be):
    return _nme_raw(ell, A, Be)


def _ell_nme_fwd(ell, A, Be):
    return _nme_raw(ell, A, Be), (ell, A, Be)


def _ell_nme_bwd(res, dy):
    """Gather-only VJP (round-2 verdict #5 — autodiff turned the Be
    cotangent into an XLA scatter). Both cotangents reduce on the SAME
    (src) packing, so no transpose packing and no twin hop are needed:

      dA[u,h,:] = Σ_{slots of row u} dy[slot,h]·Be[slot,:]
                  — per-bucket einsum + row_pos combine (gather);
      dBe[e,:]  = Σ_h dy[e,h]·A[src(e),h,:]
                  — per-slot product in packed order + edge_pos gather.

    Reference backward-kernel pair: graphop_kernel.cu:62-94 (AtomicAdd
    into dA; threads=d for dBe at :338).
    """
    ell, A, Be = res
    f32 = jnp.float32
    Ap = _pad_nodes(A.astype(f32), ell.n_nodes)
    be_packed = ell_scatter_edges(ell, Be)        # recompute, (R, D, d)
    dy_packed = ell_scatter_edges(ell, dy)        # (R, D) or (R, D, h)
    dA_contribs, dbe_parts = [], []
    for b, beb, dyb in zip(ell.buckets, be_packed, dy_packed):
        ar = Ap[b.rows]                           # (R, d) or (R, h, d)
        if A.ndim == 2:
            dA_contribs.append(jnp.einsum(
                "rk,rkd->rd", dyb, beb, preferred_element_type=f32))
            dbe_parts.append(dyb[:, :, None] * ar[:, None, :])
        else:
            dA_contribs.append(jnp.einsum(
                "rkh,rkd->rhd", dyb, beb, preferred_element_type=f32))
            dbe_parts.append(jnp.einsum(
                "rkh,rhd->rkd", dyb, ar, preferred_element_type=f32))
    dA = ell_combine_rows(ell, dA_contribs)[: A.shape[0]]
    dbe = ell_gather_edges(ell, dbe_parts)[: Be.shape[0]]
    return None, dA.astype(A.dtype), dbe.astype(Be.dtype)


_ell_nme.defvjp(_ell_nme_fwd, _ell_nme_bwd)


def ell_node_mul_edge(ell: EllGraph, ell_t: EllGraph, A, Be):
    """score[e,h] = <A[rows-side node, h, :], Be[e, :]> — the reference's
    node_mul_edge (graphop_kernel.cu:19-34; Be shared across heads).

    ``ell`` must be the src packing (reference semantics: A indexed by
    src). Hand gather-only VJP — see :func:`_ell_nme_bwd`; ``ell_t`` is
    accepted for API symmetry but unused (both cotangents reduce on the
    src packing).
    """
    del ell_t
    if not ell.buckets:
        return jnp.zeros(
            (ell.num_edges_padded,) + A.shape[1:-1], A.dtype
        )
    e_slot = ell.num_edges_padded
    if Be.shape[0] < e_slot:
        Be = _pad_edges(Be, e_slot - 1)
    return _ell_nme(ell, A, Be)


def _gat_fwd_impl(ell, a_l, a_r, z, slope, want_res):
    """Heads-in-the-sweep GAT forward (no per-head lane slices — see
    :func:`_attn_fwd_impl`): el = a_l·z[src] for all heads comes from
    one (h·d, h) block-diagonal contraction of the single flat z tile,
    and the output from the full-lane α-expanded product."""
    n, h, d = z.shape
    f32 = jnp.float32
    zp2 = _pad_nodes(z.reshape(n, h * d), ell.n_nodes)
    er = jnp.einsum("nhd,hd->nh", _pad_nodes(z, ell.n_nodes), a_r,
                    preferred_element_type=f32)
    heads_m = _head_matrix(max(h, 2), d)[: h * d, : h]  # (h·d, h)
    a_l_m = heads_m * a_l.reshape(-1)[:, None]          # blockdiag a_l
    outs, alphas, signs = [], [], []
    for b in ell.buckets:
        zg2 = zp2[b.cols]                              # (R, D, h·d)
        err = er[b.rows]
        mask = b.cols < ell.n_nodes
        el = jnp.einsum("rkc,ch->rkh", zg2, a_l_m,
                        preferred_element_type=f32)
        pre = el + err[:, None, :]
        s = jnp.where(pre > 0, pre, slope * pre)
        sm = jnp.where(mask[:, :, None], s, -1e30)
        m = jnp.max(sm, axis=1, keepdims=True)
        zexp = jnp.where(mask[:, :, None], jnp.exp(sm - m), 0)
        den = jnp.sum(zexp, axis=1, keepdims=True)
        alpha = zexp / jnp.maximum(den, 1e-30)         # (R, D, h)
        # Row-scale intermediates only (see _attn_fwd_impl): the
        # expanded (R, D, h·d) form OOMs at ogbn edge counts.
        out_full = jnp.einsum("rkh,rkc->rhc", alpha, zg2,
                              preferred_element_type=f32)
        outs.append(jnp.einsum("rhc,ch->rc", out_full, heads_m,
                               preferred_element_type=f32
                               ).astype(z.dtype))
        if want_res:
            alphas.append(alpha)
            signs.append(pre > 0)
    y = ell_combine_rows(ell, outs).reshape(-1, h, d)[: n]
    if not want_res:
        return y, None, None
    return y, alphas, signs


@jax.custom_vjp
def _ell_gat(ell, ell_t, a_l, a_r, z, slope):
    if not ell.buckets:
        return jnp.zeros_like(z)
    return _gat_fwd_impl(ell, a_l, a_r, z, slope, False)[0]


def _ell_gat_fwd(ell, ell_t, a_l, a_r, z, slope):
    if not ell.buckets:
        return jnp.zeros_like(z), (
            ell, ell_t, a_l, a_r, z, slope, None, None)
    y, alphas, signs = _gat_fwd_impl(ell, a_l, a_r, z, slope, True)
    return y, (ell, ell_t, a_l, a_r, z, slope, alphas, signs)


def _ell_gat_bwd(res, dy):
    """Backward on the measured layout laws (:func:`_ell_attention_bwd`):
    α and the LeakyReLU sign come from packed forward residuals (no
    score recompute), heads stay batched in the sweep, and α/dpre cross
    to the transpose packing through the twin-slot hop so pass 2's dy
    gather is single-consumer.
    """
    ell, ell_t, a_l, a_r, z, slope, alphas, signs = res
    if not ell.buckets:
        return (None, None, jnp.zeros_like(a_l), jnp.zeros_like(a_r),
                jnp.zeros_like(z), None)
    n, h, d = z.shape
    f32 = jnp.float32
    hd = h * d
    zp2 = _pad_nodes(z.reshape(n, hd), ell.n_nodes)
    dyf = dy.reshape(n, hd).astype(f32)
    dyp2 = _pad_nodes(dyf, ell.n_nodes)
    zpad = _pad_nodes(z, ell.n_nodes)
    er = jnp.einsum("nhd,hd->nh", zpad, a_r,
                    preferred_element_type=f32)          # (n+1, h)
    heads_m = _head_matrix(max(h, 2), d)[: hd, : h]
    a_l_rows = heads_m.T * a_l.reshape(-1)[None, :]      # (h, h·d)

    # ---- pass 1: dst packing — der, d_a_l, and the (α, dpre) hop
    # stack; the z gather feeds the dα product and the d_a_l reduction
    # (2 consumers, as in the forward) ----
    der_cols, packed_both = [], []
    dal_full = jnp.zeros((h, hd), f32)
    for b, alpha, sign in zip(ell.buckets, alphas, signs):
        zg2 = zp2[b.cols]
        dyr2 = dyp2[b.rows]                            # (R, h·d)
        dyh = dyr2[:, :, None] * heads_m[None]         # (R, h·d, h)
        dalpha = jnp.einsum("rkc,rch->rkh", zg2, dyh,
                            preferred_element_type=f32)   # (R, D, h)
        agg = jnp.sum(alpha * dalpha, axis=1, keepdims=True)
        dS = alpha * (dalpha - agg)
        dpre = jnp.where(sign, dS, slope * dS)
        der_cols.append(jnp.sum(dpre, axis=1))         # (R, h)
        dal_full = dal_full + jnp.einsum(
            "rkh,rkc->hc", dpre, zg2, preferred_element_type=f32)
        packed_both.append(
            jnp.concatenate([alpha, dpre], axis=-1))   # (R, D, 2h)
    # d_a_l lives on the block diagonal of the (h, h·d) reduction.
    d_a_l = jnp.diagonal(
        dal_full.reshape(h, h, d), axis1=0, axis2=1
    ).T                                                # (h, d)

    # d_er per node, then its chains: d_a_r and dz's er-contribution.
    der = ell_combine_rows(ell, der_cols)[: n]
    d_a_r = jnp.einsum("nh,nhd->hd", der, z,
                       preferred_element_type=f32).astype(a_r.dtype)
    dz = jnp.einsum("nh,hd->nhd", der, a_r,
                    preferred_element_type=f32).astype(z.dtype)

    # ---- pass 2: src packing — dz[src] += α_t·dy[dst] + (Σ dpre_t)·a_l
    # with α_t/dpre_t arriving through the twin hop (dy gather
    # single-consumer) ----
    both_t = ell_cross_packed_materialized(ell, ell_t, packed_both)
    dz_contribs = []
    for b, bt in zip(ell_t.buckets, both_t):
        dy_c2 = dyp2[b.cols]
        alpha_t = bt[..., :h]
        dpre_t = bt[..., h:]
        agg_v_full = jnp.einsum("rkh,rkc->rhc", alpha_t, dy_c2,
                                preferred_element_type=f32)
        agg_v = jnp.einsum("rhc,ch->rc", agg_v_full, heads_m,
                           preferred_element_type=f32)     # (R, h·d)
        el_chain = jnp.einsum(
            "rh,hc->rc", jnp.sum(dpre_t, axis=1), a_l_rows,
            preferred_element_type=f32)
        dz_contribs.append((agg_v + el_chain).astype(z.dtype))
    dz = dz + ell_combine_rows(ell_t, dz_contribs).reshape(-1, h, d)[: n]
    return (None, None, d_a_l.astype(a_l.dtype), d_a_r.astype(a_r.dtype),
            dz.astype(z.dtype), None)


_ell_gat.defvjp(_ell_gat_fwd, _ell_gat_bwd)


# ---------------------------------------------------------------------------
# Fused edge-bias attention: SDDMM + NodeMulEdge scores → softmax → SpMM
# (the transformer's edge_feat path — round-1 missing #2)
# ---------------------------------------------------------------------------

@jax.custom_vjp
def _ell_eb_attention(ell, ell_t, q, k, v, be, scale):
    return _eb_fwd_impl(ell, q, k, v, be, scale, False)[0]


@jax.custom_vjp
def _ell_eb_attention_packed(ell, ell_t, q, k, v, w, scale):
    """Variant with ``w: PackedEdgeWeights`` of (R, D, d) edge-feature
    tiles resident in both layouts — skips the two per-call (E, d)
    packing gathers, for static/cold-packed edge features."""
    return _eb_fwd_core(ell, q, k, v, w.dst, scale, False)[0]


def _eb_fwd_impl(ell, q, k, v, be, scale, want_res):
    """Canonical-`be` entry: packs (E_pad, d) per bucket, then the
    shared core.

    Multihead lane-tiles ``be`` to (E, h·d) BEFORE packing: at d_h ≤ 32
    the per-bucket packing gathers of (E, d_h) rows are ROW-bound (the
    graph/ell.py narrow-gather law), while the tiled (E, h·d=128) rows
    stream and each wide gather stays a clean single consumer of the
    core's score einsum."""
    if q.ndim == 3:
        be = jnp.concatenate([be] * q.shape[1], axis=-1)
    be_packed = ell_scatter_edges(ell, be)     # (R, D, d|h·d) per bucket
    return _eb_fwd_core(ell, q, k, v, be_packed, scale, want_res)


def _eb_fwd_core(ell, q, k, v, be_packed, scale, want_res):
    """score[e,h] = (<k[src],q[dst]> + <q[src], be[e]>)·scale, softmax
    over in-edges of dst, out[dst] = Σ α·v[src].

    ``be_packed``: per-bucket (R, D, d) edge-carried features shared
    across heads (reference node_mul_edge semantics,
    graphop_kernel.cu:19-34 — "A" indexed by src). ``ell`` must be the
    dst packing. Each per-slot gather feeds one einsum (measured layout
    law).

    Multihead runs HEADS-IN-THE-SWEEP like :func:`_attn_fwd_impl`
    (round-3 verdict #1 — this path used to loop ``lax.slice_in_dim``
    per head, the pattern the repo's laws measured at 2.3×): the SDDMM
    term contracts the slot k-tile against the row-scale (R, h·d, h) q
    expansion, and the NodeMulEdge term lane-broadcasts ``be`` across
    the h·d lanes and reduces per-head blocks through the (h·d, h)
    indicator matmul — full-lane work, no d<128 lane slices. Reference:
    heads loop inside ONE kernel launch (graphop_kernel.cu:25).
    """
    q2, h, d = _heads(q)
    f32 = jnp.float32
    qp = _pad_nodes(q2, ell.n_nodes)
    kp = _pad_nodes(_heads(k)[0], ell.n_nodes)
    vp = _pad_nodes(_heads(v)[0], ell.n_nodes)
    heads_m = _head_matrix(h, d)
    outs, alphas = [], []
    for b, beb in zip(ell.buckets, be_packed):
        kg2 = kp[b.cols]                      # sddmm score einsum only
        vg2 = vp[b.cols]                      # output einsum only
        qg2 = qp[b.cols]                      # nme term: q by SRC
        qr2 = qp[b.rows]
        mask = b.cols < ell.n_nodes
        if h == 1:
            s = (jnp.einsum("rd,rkd->rk", qr2, kg2,
                            preferred_element_type=f32)
                 + jnp.einsum("rkd,rkd->rk", qg2, beb,
                              preferred_element_type=f32)) * scale
            sm = jnp.where(mask, s, -1e30)
            m = jnp.max(sm, axis=1, keepdims=True)
            zexp = jnp.where(mask, jnp.exp(sm - m), 0)
            alpha = zexp / jnp.maximum(
                jnp.sum(zexp, axis=1, keepdims=True), 1e-30)
            outs.append(jnp.einsum(
                "rk,rkd->rd", alpha, vg2,
                preferred_element_type=f32).astype(q.dtype))
        else:
            qh = qr2[:, :, None] * heads_m[None]       # (R, h·d, h)
            # Lane-tile be by CONCATENATION, not broadcast_to+reshape:
            # the broadcast-reshape form, and every batched-contraction
            # form over the slot-scale (R, D, h, d) view, lowered
            # pathologically; the explicit concat + (h·d, h) indicator
            # matmul stays clean. The raw
            # path arrives pre-tiled (wide packing gathers,
            # _eb_fwd_impl); packed (R, D, d) residents tile here.
            be_l = (beb if beb.shape[-1] == h * d
                    else jnp.concatenate([beb] * h, axis=-1))
            s = (jnp.einsum("rkc,rch->rkh", kg2, qh,
                            preferred_element_type=f32)
                 + jnp.einsum("rkc,ch->rkh", qg2 * be_l, heads_m,
                              preferred_element_type=f32)) * scale
            sm = jnp.where(mask[:, :, None], s, -1e30)
            m = jnp.max(sm, axis=1, keepdims=True)
            zexp = jnp.where(mask[:, :, None], jnp.exp(sm - m), 0)
            alpha = zexp / jnp.maximum(
                jnp.sum(zexp, axis=1, keepdims=True), 1e-30)
            out_full = jnp.einsum("rkh,rkc->rhc", alpha, vg2,
                                  preferred_element_type=f32)
            outs.append(jnp.einsum("rhc,ch->rc", out_full, heads_m,
                                   preferred_element_type=f32
                                   ).astype(q.dtype))
        if want_res:
            alphas.append(alpha)                      # (R, D) / (R, D, h)
    y = ell_combine_rows(ell, outs)[: q.shape[0]].reshape(q.shape)
    return y, (alphas if want_res else None)


def _ell_eb_attention_fwd(ell, ell_t, q, k, v, be, scale):
    y, alphas = _eb_fwd_impl(ell, q, k, v, be, scale, True)
    return y, (ell, ell_t, q, k, v, be, scale, alphas)


def _eb_bwd_core(ell, ell_t, q, k, v, be_t, scale, alphas, dy):
    """Shared backward. ``be_t``: per-bucket (R, D, d) edge features in
    the SRC (transpose) layout. Returns (dq, dk, dv, dbe_src_parts)
    with the be cotangent packed per src bucket.

    Same two-pass twin-hop shape as :func:`_ell_attention_bwd`, with
    the NodeMulEdge chains added: dq gains a SRC-side term Σ_h dS·be;
    dbe[e] = Σ_h dS[e,h]·q[src e] is reduced on the transpose packing
    (q[src] is a row lookup there) — no scatters (round 1 shipped this
    op with an XLA-scatter cotangent).
    """
    q2, h, d = _heads(q)
    n = ell.n_nodes
    f32 = jnp.float32
    qp = _pad_nodes(q2.astype(f32), n)
    kp = _pad_nodes(_heads(k)[0], n)
    vp = _pad_nodes(_heads(v)[0], n)
    dyp = _pad_nodes(_heads(dy)[0].astype(f32), n)
    heads_m = _head_matrix(h, d)

    # pass 1 (dst packing): dq[dst] (sddmm chain) + packed (α, dS).
    # Multihead batched exactly like _ell_attention_bwd pass 1 —
    # block-indicator matmuls, no per-head lane slices (round-3 #1).
    dq_contribs, packed_both = [], []
    for b, alpha in zip(ell.buckets, alphas):
        kg2 = kp[b.cols]                       # dq einsum only
        vg2 = vp[b.cols]                       # dα einsum only
        dyr2 = dyp[b.rows]
        if h == 1:
            dalpha = jnp.einsum("rd,rkd->rk", dyr2, vg2,
                                preferred_element_type=f32)
            agg = jnp.sum(alpha * dalpha, axis=1)
            dS = alpha * (dalpha - agg[:, None]) * scale
            dq_contribs.append(jnp.einsum(
                "rk,rkd->rd", dS, kg2, preferred_element_type=f32))
            packed_both.append(jnp.stack([alpha, dS], axis=-1))
        else:
            dyh = dyr2[:, :, None] * heads_m[None]     # (R, h·d, h)
            dalpha = jnp.einsum("rkc,rch->rkh", vg2, dyh,
                                preferred_element_type=f32)
            agg = jnp.sum(alpha * dalpha, axis=1, keepdims=True)
            dS = alpha * (dalpha - agg) * scale
            dq_full = jnp.einsum("rkh,rkc->rhc", dS, kg2,
                                 preferred_element_type=f32)
            dq_contribs.append(jnp.einsum(
                "rhc,ch->rc", dq_full, heads_m,
                preferred_element_type=f32))
            packed_both.append(
                jnp.concatenate([alpha, dS], axis=-1))  # (R, D, 2h)
    dq_dst = ell_combine_rows(ell, dq_contribs)[: q.shape[0]]

    # pass 2 (src packing): dk, dv, dq[src] (nme chain), dbe. The nme
    # chains are clean batched contractions: dq_src contracts dS_t
    # against the slot be-tile over the width axis; dbe contracts dS_t
    # against the ROW-scale q[src] lookup over heads (the same einsums
    # _ell_nme_bwd uses).
    both_t = ell_cross_packed_materialized(ell, ell_t, packed_both)
    dk_c, dv_c, dqs_c, dbe_parts = [], [], [], []
    for b, bt, bet in zip(ell_t.buckets, both_t, be_t):
        q_c2 = qp[b.cols]                      # dk einsum only
        dy_c2 = dyp[b.cols]                    # dv einsum only
        qr2 = qp[b.rows]                       # q[src] row lookup (dbe)
        if h == 1:
            alpha_t = bt[..., 0]
            dS_t = bt[..., 1]
            dk_c.append(jnp.einsum("rk,rkd->rd", dS_t, q_c2,
                                   preferred_element_type=f32))
            dv_c.append(jnp.einsum("rk,rkd->rd", alpha_t, dy_c2,
                                   preferred_element_type=f32))
            dqs_c.append(jnp.einsum("rk,rkd->rd", dS_t, bet,
                                    preferred_element_type=f32))
            dbe_parts.append(jnp.einsum("rk,rd->rkd", dS_t, qr2,
                                        preferred_element_type=f32))
        else:
            alpha_t = bt[..., :h]
            dS_t = bt[..., h:]
            dk_full = jnp.einsum("rkh,rkc->rhc", dS_t, q_c2,
                                 preferred_element_type=f32)
            dk_c.append(jnp.einsum("rhc,ch->rc", dk_full, heads_m,
                                   preferred_element_type=f32))
            dv_full = jnp.einsum("rkh,rkc->rhc", alpha_t, dy_c2,
                                 preferred_element_type=f32)
            dv_c.append(jnp.einsum("rhc,ch->rc", dv_full, heads_m,
                                   preferred_element_type=f32))
            if bet.shape[-1] == d:
                dqs_c.append(jnp.einsum(
                    "rkh,rkd->rhd", dS_t, bet,
                    preferred_element_type=f32).reshape(-1, h * d))
            else:
                # Wide-tiled bet (raw path — (R, D, h·d) from the
                # streaming gather): the per-head block of the rhc
                # contraction IS the per-head dqs (all lane blocks of
                # bet carry the same d values); extract block-diagonal
                # on the ROW-scale output.
                dqs_full = jnp.einsum("rkh,rkc->rhc", dS_t, bet,
                                      preferred_element_type=f32)
                dqs_c.append(jnp.concatenate(
                    [dqs_full[:, i, i * d:(i + 1) * d]
                     for i in range(h)], axis=-1))
            dbe_parts.append(jnp.einsum(
                "rkh,rhd->rkd", dS_t, qr2.reshape(-1, h, d),
                preferred_element_type=f32))
    dk = ell_combine_rows(ell_t, dk_c)[: k.shape[0]].reshape(k.shape)
    dv = ell_combine_rows(ell_t, dv_c)[: v.shape[0]].reshape(v.shape)
    dq_src = ell_combine_rows(ell_t, dqs_c)[: q.shape[0]]
    dq = (dq_dst + dq_src).reshape(q.shape)
    return (dq.astype(q.dtype), dk.astype(k.dtype), dv.astype(v.dtype),
            dbe_parts)


def _wide_hop(parts, hop_fn):
    """Run a cross-layout hop of narrow (…, d) per-slot channels by
    lane-tiling to ≥128 lanes first, hopping WIDE, and slicing back.

    Narrow per-slot gathers are ROW-bound (graph/ell.py law): the
    (S, 32) dst-copy hop dominated the multihead packed eb backward,
    while (S, 128) rows stream."""
    d_w = parts[0].shape[-1]
    reps = -(-128 // d_w)
    if reps == 1:
        return hop_fn(parts)
    tiled = [jnp.concatenate([p] * reps, axis=-1) for p in parts]
    return [t[..., :d_w] for t in hop_fn(tiled)]


def _ell_eb_attention_bwd(res, dy):
    ell, ell_t, q, k, v, be, scale, alphas = res
    if q.ndim == 3 and q.shape[1] > 1:
        # Wide packing gathers (see _eb_fwd_impl): lane-tile canonical
        # be before the transpose packing so the (E, d_h) row-bound
        # gathers become streaming (E, h·d) ones.
        be_t = ell_scatter_edges(
            ell_t, jnp.concatenate([be] * q.shape[1], axis=-1))
    else:
        be_t = ell_scatter_edges(ell_t, be)
    dq, dk, dv, dbe_parts = _eb_bwd_core(
        ell, ell_t, q, k, v, be_t, scale, alphas, dy
    )
    d_w = dbe_parts[0].shape[-1]
    if -(-128 // d_w) > 1:
        tiled = [jnp.concatenate([p] * (-(-128 // d_w)), axis=-1)
                 for p in dbe_parts]
        dbe = ell_gather_edges(ell_t, tiled)[:, :d_w][: be.shape[0]]
    else:
        dbe = ell_gather_edges(ell_t, dbe_parts)[: be.shape[0]]
    return (None, None, dq, dk, dv, dbe.astype(be.dtype), None)


_ell_eb_attention.defvjp(_ell_eb_attention_fwd, _ell_eb_attention_bwd)


def _ell_eb_attention_packed_fwd(ell, ell_t, q, k, v, w, scale):
    y, alphas = _eb_fwd_core(ell, q, k, v, w.dst, scale, True)
    return y, (ell, ell_t, q, k, v, w, scale, alphas)


def _ell_eb_attention_packed_bwd(res, dy):
    ell, ell_t, q, k, v, w, scale, alphas = res
    dq, dk, dv, dbe_parts = _eb_bwd_core(
        ell, ell_t, q, k, v, w.src, scale, alphas, dy
    )
    # Both packed cotangent copies; the dst copy rides the twin hop.
    # dbe_parts has TWO consumers (the src-copy output and the hop) —
    # fence it so XLA materializes pass 2's einsums once; the hop
    # itself goes through _wide_hop (lane-tile + streaming gather +
    # slice — the narrow (S, d_h) hop is row-bound).
    dbe_parts = jax.lax.optimization_barrier(dbe_parts)
    dbe_dst = _wide_hop(dbe_parts,
                        lambda ps: ell_cross_packed(ell_t, ell, ps))
    dw = PackedEdgeWeights(
        src=[g.astype(ws.dtype) for g, ws in zip(dbe_parts, w.src)],
        dst=[g.astype(wd.dtype) for g, wd in zip(dbe_dst, w.dst)],
    )
    return (None, None, dq, dk, dv, dw, None)


_ell_eb_attention_packed.defvjp(
    _ell_eb_attention_packed_fwd, _ell_eb_attention_packed_bwd
)


def ell_edge_bias_attention(ell: EllGraph, ell_t: EllGraph, q, k, v, be,
                            *, scale: float = None):
    """Fused attention with edge-carried (relative-position) score bias:

      score[e] = (<k[src], q[dst]> + <q[src], be[e]>)·scale
      out[dst] = Σ softmax_dst(score)·v[src]

    — the reference's maskedmm + node_mul_edge + sparse_softmax +
    vector_spmm composition (wrapper.py:32-42, graphop_kernel.cu:19-34,
    62-94) fused on the ELL layout with a gather-only VJP, including the
    ``be`` cotangent (canonical order). ``ell`` = dst packing, ``ell_t``
    = src packing; q,k,v: (n, d) or (n, h, d); be: (E, d) shared across
    heads — or a :class:`PackedEdgeWeights` of (R, D, d) tiles from
    ``ell_pack_weights(ell_t, ell, be)`` (note the order: src copy
    first), which skips the two per-call packing gathers for static
    edge features and returns packed cotangents.
    """
    if not ell.buckets:
        return jnp.zeros_like(q)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if isinstance(be, PackedEdgeWeights):
        return _ell_eb_attention_packed(
            ell, ell_t, q, k, v, be, float(scale)
        )
    e_slot = ell.num_edges_padded
    if be.shape[0] < e_slot:
        be = _pad_edges(be, e_slot - 1)
    return _ell_eb_attention(ell, ell_t, q, k, v, be, float(scale))


def ell_gat_attention(ell: EllGraph, ell_t: EllGraph, a_l, a_r, z, *,
                      negative_slope: float = 0.2):
    """Fused GAT layer core on the ELL layout.

    score[e] = LeakyReLU(a_l·z[src(e)] + a_r·z[dst(e)]), α = softmax over
    in-edges of dst, out[dst] = Σ α·z[src] — the additive-attention GAT
    decomposition (reference models it with NodeMulEdge + sparse_softmax
    + vector_spmm; models/gat.py composes the segment ops the same way).

    ``ell`` must be the dst packing, ``ell_t`` the src packing.
    a_l, a_r: (h, d) attention vectors; z: (n, h, d). Returns (n, h, d).
    The src-side scores are computed from the aggregation's own z-tile
    gathers, so the layer costs one z gather + one dy gather per
    direction, not per score term.
    """
    return _ell_gat(ell, ell_t, a_l, a_r, z, float(negative_slope))


def ell_attention(ell: EllGraph, ell_t: EllGraph, q, k, v, *,
                  scale: float = None):
    """Fused masked attention on the ELL layout (general graphs).

    ``ell`` is the packing of the normalization direction (``"dst"`` for
    the GNN convention: out[dst] = Σ softmax over in-edges of
    <q[dst],k[src]>·v[src]); ``ell_t`` its transpose (for the backward
    aggregations). q, k, v: (n, d) or (n, h, d).

    Reference analog: the 6-kernel SDDMM → sparse_softmax → vector_spmm
    pipeline (wrapper.py:201-291), fused with zero canonical-edge-order
    traffic in the forward pass.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _ell_attention(ell, ell_t, q, k, v, float(scale))
