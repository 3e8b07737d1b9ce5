"""Fused block-sparse graph attention (flash attention over adjacency
tiles), Pallas Triton route.

One kernel computes the whole composition the reference benchmarks as
three separate op launches — SDDMM → edge-softmax → vector-SpMM
(wrapper.py:201-291; graphop_kernel.cu launches *six* kernels for that
forward: 1 + 3 + 1 plus a transpose) — with **no device-memory traffic
for edge scores**: scores and softmax statistics stay in registers while
a program loops over its row block's tiles (online softmax, the standard
flash recurrence):

    s      = (Q[I] @ K[J(t)]ᵀ) · scale,  masked to the tile's edges
    m_new  = max(m, rowmax(s))
    p      = exp(s − m_new)
    l      = l·exp(m − m_new) + rowsum(p)
    acc    = acc·exp(m − m_new) + p @ V[J(t)]
    out[I] = acc / l            (after the last tile)

Grid ``(row blocks, R/BR, d/BD)``: a program owns ``BR`` rows and one
``BD``-wide chunk of the output features; with several chunks each
recomputes the scores (they contract over all of d). Softmax normalizes
over each *row* segment (the src direction — pass the transposed tiling
for dst-normalized attention, see ops/tiled.py). The structure follows
the library kernel ``jax.experimental.pallas.ops.gpu.attention``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from custom_op_benchmark_tpu.ops.pallas.common import triton_call
from custom_op_benchmark_tpu.ops.pallas.tiled_kernels import (
    SUB_BLOCK,
    _dot,
    _slot,
    feat_block,
)

_NEG_INF = -1e30
_M_INIT = -1e9   # matches the reference's max init (graphop_kernel.cu:428)
_F32 = jnp.float32


def _body(ptr_ref, cols_ref, mask_ref, q_ref, k_ref, v_ref, out_ref, *,
          r, c, br, bd, nd, scale):
    i, rs, dc = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    sub, feats = _slot(rs, br), _slot(dc, bd)
    qrows = _slot(i * (r // br) + rs, br)
    q_whole = q_ref[qrows, :] if nd == 1 else None

    def tile(t, carry):
        acc, m, l = carry
        kv = _slot(cols_ref[t], c)
        if nd == 1:
            s = _dot(q_whole, k_ref[kv, :], ((1,), (1,)))
        else:
            s = jax.lax.fori_loop(
                0, nd,
                lambda kk, s: s + _dot(q_ref[qrows, _slot(kk, bd)],
                                       k_ref[kv, _slot(kk, bd)],
                                       ((1,), (1,))),
                jnp.zeros((br, c), _F32))
        s = jnp.where(mask_ref[t, sub, :], s * scale, _NEG_INF)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        p = jnp.exp(s - m_new[:, None])
        corr = jnp.exp(m - m_new)
        v = v_ref[kv, feats]
        acc = acc * corr[:, None] + _dot(p.astype(v.dtype), v)
        return acc, m_new, l * corr + jnp.sum(p, axis=1)

    acc, _, l = jax.lax.fori_loop(
        ptr_ref[i], ptr_ref[i + 1], tile,
        (jnp.zeros((br, bd), _F32), jnp.full((br,), _M_INIT, _F32),
         jnp.zeros((br,), _F32)))
    out = jnp.where(l[:, None] > 0, acc / jnp.maximum(l, 1e-30)[:, None],
                    0.0)
    out_ref[qrows, feats] = out.astype(out_ref.dtype)


def fused_attention_rows(tile_ptr, tile_cols, mask, q, k, v, scale: float):
    """q: (NRB·R, d), k/v: (NCB·C, d), mask: (T, R, C) → out (NRB·R, d).

    Softmax over row segments. d must be a multiple of
    ``feat_block(d)``."""
    _, r, c = mask.shape
    d = q.shape[1]
    nrb = tile_ptr.shape[0] - 1
    br, bd = min(SUB_BLOCK, r), feat_block(d)
    body = functools.partial(_body, r=r, c=c, br=br, bd=bd, nd=d // bd,
                             scale=scale)
    return triton_call(
        body, grid=(nrb, r // br, d // bd),
        out_shape=jax.ShapeDtypeStruct((nrb * r, d), q.dtype),
        name="tiled_attention", num_warps=8, num_stages=1,
    )(tile_ptr, tile_cols, mask, q, k, v)
