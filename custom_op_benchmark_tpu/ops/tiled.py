"""Public block-sparse (tiled) ops.

Same semantic contracts as ops/primitives.py (SURVEY.md §2.3), but edge
data lives **tile-dense**: ``(T, R, C)`` arrays over the nonzero adjacency
tiles of a :class:`TiledGraph`. Convert with ``tg.scatter_edges`` /
``tg.gather_edges`` at the boundary; inside a model the whole attention
pipeline stays tile-dense (or fully fused, see :func:`tiled_attention`).

Four building blocks carry every forward and backward pass, mirroring how
the reference reuses its forward kernels over the transpose CSR for
backward (graphop_kernel.cu:355-409, 544-600): a per-tile SDDMM, a row
sweep and a column sweep SpMM, and the fused attention. Each runs as
whichever of a Pallas kernel (ops/pallas/, Triton route) and a plain-XLA
form (a tile gather, a batched ``einsum`` with f32 accumulation, a segment
sum) was faster on the H100 (PERF.md): kernels for the SDDMM, the row
sweep and the attention, plain XLA for the column sweep.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from custom_op_benchmark_tpu.graph.tiled import TiledGraph
from custom_op_benchmark_tpu.ops.pallas import (
    feat_block,
    fused_attention_rows,
    sddmm_tiles_kernel,
    spmm_row_sweep_kernel,
)

_F32 = jnp.float32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_rows(x: jax.Array, rows: int) -> jax.Array:
    if x.shape[0] == rows:
        return x
    return jnp.pad(x, [(0, rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def _pad_feat(x: jax.Array) -> Tuple[jax.Array, int]:
    d = x.shape[-1]
    dp = _round_up(max(d, 1), feat_block(d))
    if dp == d:
        return x, d
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, dp - d)]), d


def _tiles_of(x: jax.Array, size: int, idx: jax.Array) -> jax.Array:
    """(nb·size, d) node rows → (T, size, d) blocks ``idx``."""
    return x.reshape(-1, size, x.shape[-1])[idx]


# ---------------------------------------------------------------------------
# The four building blocks.
# ---------------------------------------------------------------------------

def _sddmm_tiles(meta, mask, A, B):
    rows, cols, ptr, perm_c, ptr_c = meta
    dt = jnp.promote_types(A.dtype, B.dtype)
    if mask.shape[0] == 0:
        return jnp.zeros(mask.shape, dt)
    return sddmm_tiles_kernel(rows, cols, mask, A.astype(dt), B.astype(dt))


def _row_sweep(meta, vals, x):
    """y (NRB·R, d) = Σ over each row block's tiles of vals[t] @ x[J(t)]."""
    rows, cols, ptr, perm_c, ptr_c = meta
    t, r, c = vals.shape
    dt = jnp.promote_types(vals.dtype, x.dtype)
    if t == 0:
        return jnp.zeros(((ptr.shape[0] - 1) * r, x.shape[1]), dt)
    return spmm_row_sweep_kernel(ptr, cols, vals.astype(dt), x.astype(dt))


def _col_sweep(meta, vals, y):
    """x' (NCB·C, d) = Σ over each col block's tiles of vals[t]ᵀ @ y[I(t)]
    — plain XLA: one batched einsum over the tiles, then a segment sum by
    column block (measured faster on the H100 than a column-sweep Pallas
    kernel; PERF.md)."""
    rows, cols, ptr, perm_c, ptr_c = meta
    t, r, c = vals.shape
    ncb = ptr_c.shape[0] - 1
    dt = jnp.promote_types(vals.dtype, y.dtype)
    if t == 0:
        return jnp.zeros((ncb * c, y.shape[1]), dt)
    part = jnp.einsum("trc,trd->tcd", vals.astype(dt),
                      _tiles_of(y.astype(dt), r, rows),
                      preferred_element_type=_F32)
    return jax.ops.segment_sum(part, cols, ncb).reshape(
        ncb * c, -1).astype(dt)


def _row_softmax(meta, mask, s):
    """Softmax of (T, R, C) scores over each row's edges across its row
    block's tiles (segment reductions as scans over the row-sorted tile
    order)."""
    rows, cols, ptr, perm_c, ptr_c = meta
    sm = jnp.where(mask, s, jnp.asarray(-1e30, s.dtype))
    segm = _sorted_seg_reduce(jnp.max(sm, axis=2), rows, ptr, "max")
    z = jnp.where(mask, jnp.exp(sm - segm[rows][:, :, None]), 0.0)
    segs = _sorted_seg_reduce(jnp.sum(z, axis=2), rows, ptr, "sum")
    return z / jnp.maximum(segs[rows][:, :, None], 1e-30)


def _attention_rows(meta, mask, q, k, v, scale):
    rows, cols, ptr, perm_c, ptr_c = meta
    if mask.shape[0] == 0:
        return jnp.zeros(((ptr.shape[0] - 1) * mask.shape[1], v.shape[1]),
                         v.dtype)
    return fused_attention_rows(ptr, cols, mask, q, k, v, scale)


# ---------------------------------------------------------------------------
# SDDMM
# ---------------------------------------------------------------------------

@jax.custom_vjp
def _sddmm_t(meta, mask, A, B):
    return _sddmm_tiles(meta, mask, A, B)


def _sddmm_t_fwd(meta, mask, A, B):
    return _sddmm_t(meta, mask, A, B), (meta, mask, A, B)


def _sddmm_t_bwd(res, dS):
    meta, mask, A, B = res
    dS = jnp.where(mask, dS, 0.0)
    dA = _row_sweep(meta, dS, B).astype(A.dtype)
    dB = _col_sweep(meta, dS, A).astype(B.dtype)
    return None, None, dA, dB


_sddmm_t.defvjp(_sddmm_t_fwd, _sddmm_t_bwd)


def _meta(tg: TiledGraph):
    return (
        tg.tile_rows, tg.tile_cols, tg.tile_ptr, tg.tile_perm_c,
        tg.tile_ptr_c,
    )


def tiled_sddmm(tg: TiledGraph, A: jax.Array, B: jax.Array) -> jax.Array:
    """scores (T, R, C) = mask ⊙ (A[rows] @ B[cols]ᵀ).  A, B: (n, d)."""
    A, _ = _pad_feat(_pad_rows(A, tg.n_rows_padded))
    B, _ = _pad_feat(_pad_rows(B, tg.n_cols_padded))
    return _sddmm_t(_meta(tg), tg.mask, A, B)


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------

@jax.custom_vjp
def _spmm_t(meta, mask, vals, x):
    return _row_sweep(meta, vals, x)


def _spmm_t_fwd(meta, mask, vals, x):
    return _spmm_t(meta, mask, vals, x), (meta, mask, vals, x)


def _spmm_t_bwd(res, dy):
    meta, mask, vals, x = res
    dvals = _sddmm_tiles(meta, mask, dy, x).astype(vals.dtype)
    dx = _col_sweep(meta, vals, dy).astype(x.dtype)
    return None, None, dvals, dx


_spmm_t.defvjp(_spmm_t_fwd, _spmm_t_bwd)


def tiled_spmm(tg: TiledGraph, vals: jax.Array, x: jax.Array,
               out_rows: int = None) -> jax.Array:
    """y[u] = Σ_{e=(u,v)} vals[e]·x[v] with vals tile-dense (T, R, C).

    Returns (out_rows or tg.n_nodes, d).
    """
    xp, d = _pad_feat(_pad_rows(x, tg.n_cols_padded))
    y = _spmm_t(_meta(tg), tg.mask, vals, xp)
    n = out_rows or tg.n_nodes
    return y[:n, :d]


# ---------------------------------------------------------------------------
# Softmax over tile-dense scores (pure XLA on small per-tile reductions —
# bandwidth-bound elementwise, no kernel needed; fully differentiable).
# ---------------------------------------------------------------------------

def _sorted_seg_reduce(local, ids, ptr, kind):
    """Scatter-free segment reduce over SORTED tile ids (round-2 verdict
    #9 — the old ``.at[ids].max/.add`` were the design's banned scatter,
    small but unprincipled; a one-hot matmul would need (T, nblk) and
    blow up at large tile counts).

    A segmented associative scan: combine((va, ia), (vb, ib)) keeps the
    running reduction while the segment id is unchanged and RESETS when
    it increases (ids are sorted, so segment starts are the only id
    changes). The per-segment result then sits at each segment's LAST
    tile, gathered via ``ptr[1:] - 1``. Differentiable (plain lax ops);
    empty segments return the init value and are never consumed (no tile
    carries their id).

    local: (T, lanes); ids: (T,) sorted; ptr: (nblk+1,) segment offsets.
    Returns (nblk, lanes).
    """
    if local.shape[0] == 0:
        init = -1e9 if kind == "max" else 0.0
        return jnp.full((ptr.shape[0] - 1, local.shape[1]), init,
                        local.dtype)
    idc = ids[:, None]

    def comb(a, b):
        va, ia = a
        vb, ib = b
        same = ia == ib
        if kind == "max":
            v = jnp.where(same, jnp.maximum(va, vb), vb)
        else:
            v = jnp.where(same, va + vb, vb)
        return v, jnp.maximum(ia, ib)

    scanned, _ = jax.lax.associative_scan(comb, (local, idc), axis=0)
    ends = jnp.maximum(ptr[1:] - 1, 0)
    return scanned[ends]


def _tsm_axes(tg, by):
    if by == "src":
        return tg.tile_rows, 2, None, tg.tile_ptr
    if by == "dst":
        return tg.tile_cols, 1, tg.tile_perm_c, tg.tile_ptr_c
    raise ValueError(f"by must be 'src' or 'dst', got {by!r}")


def _tsm_fwd_impl(tg, scores, by):
    mask = tg.mask
    neg = jnp.asarray(-1e30, scores.dtype)
    s = jnp.where(mask, scores, neg)
    ids, axis, perm, ptr = _tsm_axes(tg, by)

    def seg(local, kind):
        if perm is None:
            return _sorted_seg_reduce(local, ids, ptr, kind)
        return _sorted_seg_reduce(local[perm], ids[perm], ptr, kind)

    local_max = jnp.max(s, axis=axis)                      # (T, lanes)
    m = seg(local_max, "max")[ids]                         # (T, lanes)
    mexp = jnp.expand_dims(m, axis)
    z = jnp.where(mask, jnp.exp(s - mexp), 0.0)
    local_sum = jnp.sum(z, axis=axis)
    denom = jnp.expand_dims(seg(local_sum, "sum")[ids], axis)
    return z / jnp.maximum(denom, 1e-30)


@partial(jax.custom_vjp, nondiff_argnums=(0, 2))
def _tiled_softmax(tg, scores, by):
    return _tsm_fwd_impl(tg, scores, by)


def _tiled_softmax_fwd(tg, scores, by):
    y = _tsm_fwd_impl(tg, scores, by)
    return y, y


def _tiled_softmax_bwd(tg, by, y, dy):
    """Hand VJP so the backward is scatter-free too (autodiff transposes
    the segment gathers into scatter-adds): dS = y ⊙ (dy − Σ_seg y·dy)
    with the segment sum as the same segmented scan."""
    ids, axis, perm, ptr = _tsm_axes(tg, by)
    local = jnp.sum(y * dy, axis=axis)                     # (T, lanes)
    if perm is None:
        agg = _sorted_seg_reduce(local, ids, ptr, "sum")
    else:
        agg = _sorted_seg_reduce(local[perm], ids[perm], ptr, "sum")
    dS = y * (dy - jnp.expand_dims(agg[ids], axis))
    return (dS.astype(y.dtype),)


_tiled_softmax.defvjp(_tiled_softmax_fwd, _tiled_softmax_bwd)


def tiled_softmax(tg: TiledGraph, scores: jax.Array, *,
                  by: str = "src") -> jax.Array:
    """Segment softmax on (T, R, C) scores over row (src) or col (dst)
    segments, numerically stable, masked to real edges. Scatter-free in
    BOTH directions (round-2 verdict #9): segment max/sum run as
    segmented scans over the row- or col-sorted tile order (``tile_ptr``
    / ``tile_perm_c`` + ``tile_ptr_c``), and the hand VJP reduces
    ``Σ_seg y·dy`` the same way."""
    return _tiled_softmax(tg, scores, by)


# ---------------------------------------------------------------------------
# Fused attention
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(3,))
def _fused_attn(meta, mask, qkv, scale):
    return _attention_rows(meta, mask, *qkv, scale)


def _fused_attn_fwd(meta, mask, qkv, scale):
    return _fused_attn(meta, mask, qkv, scale), (meta, mask, qkv)


def _fused_attn_bwd(scale, res, dy):
    """Recompute-based backward through the three other building blocks
    (the flash-attention backward shape: scores/α rematerialized, never
    stored)."""
    meta, mask, (q, k, v) = res
    rows, cols, ptr, perm_c, ptr_c = meta
    alpha = _row_softmax(meta, mask, _sddmm_tiles(meta, mask, q, k) * scale)
    dv = _col_sweep(meta, alpha, dy).astype(v.dtype)
    dalpha = _sddmm_tiles(meta, mask, dy, v)
    # softmax VJP per row segment: dS = α ⊙ (dα − Σ_seg α·dα)
    agg = _sorted_seg_reduce(jnp.sum(alpha * dalpha, axis=2), rows, ptr,
                             "sum")
    dS = alpha * (dalpha - agg[rows][:, :, None]) * scale
    dq = _row_sweep(meta, dS, k).astype(q.dtype)
    dk = _col_sweep(meta, dS, q).astype(k.dtype)
    return None, None, (dq, dk, dv)


_fused_attn.defvjp(_fused_attn_fwd, _fused_attn_bwd)


def tiled_attention(tg: TiledGraph, q: jax.Array, k: jax.Array,
                    v: jax.Array, *, scale: float = None,
                    normalize: str = "src") -> jax.Array:
    """Fused masked attention over the graph's adjacency tiles.

    ``normalize="src"``: out[u] = Σ_{e=(u,v)} softmax_u(<q[u],k[v]>)·v[v]
    (softmax over out-edges). ``normalize="dst"`` runs the same kernel on
    the transposed tiling: out[v] = Σ_{e=(u,v)} softmax_v(<q[v],k[u]>)·v[u]
    — the GNN attention direction.

    q, k, v: (n, h, d) or (n, d). Returns same rank with n rows.
    """
    if normalize == "dst":
        return tiled_attention(
            tg.transpose(), q, k, v, scale=scale, normalize="src"
        )
    if normalize != "src":
        raise ValueError(f"normalize must be 'src'/'dst', got {normalize!r}")

    multi = q.ndim == 3
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)

    def one_head(qh, kh, vh):
        qp, d = _pad_feat(_pad_rows(qh, tg.n_rows_padded))
        kp, _ = _pad_feat(_pad_rows(kh, tg.n_cols_padded))
        vp, _ = _pad_feat(_pad_rows(vh, tg.n_cols_padded))
        out = _fused_attn(_meta(tg), tg.mask, (qp, kp, vp), float(scale))
        return out[: tg.n_nodes, :d]

    if not multi:
        return one_head(q, k, v)
    # Heads run as a vmap batch axis, leading: (n, h, d) → (h, n, d).
    out = jax.vmap(one_head)(
        jnp.swapaxes(q, 0, 1), jnp.swapaxes(k, 0, 1), jnp.swapaxes(v, 0, 1)
    )
    return jnp.swapaxes(out, 0, 1)
