"""Pallas kernels (Triton route) on the block-sparse (BSR) tiling.

With the fused attention (pallas/attention.py) these carry the op
family's forward and backward passes (SURVEY.md §2.3 VJP contracts); the
transpose sweep is plain XLA (ops/tiled.py ``_col_sweep``). Tiles are
``R × C`` adjacency blocks; node arrays are padded to whole blocks and
features to ``feat_block`` multiples. Each program finds its tiles through the index arrays it is
given (whole-array refs, no scalar prefetch) and loops over them with
``fori_loop``; accumulators are loop carries, so one program owns each
output block and no atomics are needed.

- :func:`sddmm_tiles_kernel` — grid ``(T, R/BR)``:
  ``S[t] = mask[t] ⊙ (A[I·R:(I+1)·R] @ B[J·C:(J+1)·C]ᵀ)``. Forward of
  SDDMM; also dvals of SpMM (with A=dy, B=x).
  (reference: maskedmm_csr_forward_kernel, graphop_kernel.cu:41-55 —
  there per-edge serial dot products; here one R×d×C product per tile.)

- :func:`spmm_row_sweep_kernel` — grid ``(row blocks, R/BR, d/BD)``,
  each program sweeping its row block's tiles:
  ``Y[I] = Σ_t S[t] @ X[J(t)]``. Forward of vector-SpMM; also dA of
  SDDMM. Row-owned accumulation replaces the reference's AtomicAdd
  scatters (graphop_kernel.cu:119-130 + atomic.cuh).

An empty block sweeps no tiles and writes zeros.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from custom_op_benchmark_tpu.ops.pallas.common import triton_call

# Rows of a tile one program handles: 64-row operands keep the
# accumulator in registers and two pipeline stages of operand tiles
# inside a block's shared memory at f32.
SUB_BLOCK = 64
_F32 = jnp.float32


def feat_block(d: int) -> int:
    """Feature chunk a program works on: a power of two, at least 16 (the
    tensor cores' smallest operand side), at most 128."""
    return min(128, max(16, pl.next_power_of_2(d)))


def _dot(a, b, contract=((1,), (0,))):
    return jax.lax.dot_general(a, b, (contract, ((), ())),
                               preferred_element_type=_F32)


def _slot(i, size):
    return pl.ds(pl.multiple_of(i * size, size), size)


# ---------------------------------------------------------------------------
# SDDMM over tiles
# ---------------------------------------------------------------------------

def _sddmm_body(rows_ref, cols_ref, mask_ref, a_ref, b_ref, out_ref, *,
                r, c, br, bd, nd):
    t, rs = pl.program_id(0), pl.program_id(1)
    arow = rows_ref[t] * (r // br) + rs
    bcol = cols_ref[t]

    def chunk(kk, s):
        a = a_ref[_slot(arow, br), _slot(kk, bd)]
        b = b_ref[_slot(bcol, c), _slot(kk, bd)]
        return s + _dot(a, b, ((1,), (1,)))            # A @ Bᵀ

    s = jax.lax.fori_loop(0, nd, chunk, jnp.zeros((br, c), _F32))
    sub = _slot(rs, br)
    out_ref[t, sub, :] = jnp.where(mask_ref[t, sub, :], s,
                                   0.0).astype(out_ref.dtype)


def sddmm_tiles_kernel(tile_rows, tile_cols, mask, A, B):
    """A: (NRB·R, d), B: (NCB·C, d) → scores (T, R, C), masked.

    d must be a multiple of ``feat_block(d)`` (callers pad)."""
    t, r, c = mask.shape
    d = A.shape[1]
    br, bd = min(SUB_BLOCK, r), feat_block(d)
    body = functools.partial(_sddmm_body, r=r, c=c, br=br, bd=bd,
                             nd=d // bd)
    return triton_call(
        body, grid=(t, r // br),
        out_shape=jax.ShapeDtypeStruct((t, r, c), A.dtype),
        name="tiled_sddmm",
    )(tile_rows, tile_cols, mask, A, B)


# ---------------------------------------------------------------------------
# SpMM row sweep
# ---------------------------------------------------------------------------

def _row_sweep_body(ptr_ref, cols_ref, vals_ref, x_ref, out_ref, *,
                    r, c, br, bd):
    i, rs, dc = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    sub, feats = _slot(rs, br), _slot(dc, bd)

    def tile(t, acc):
        v = vals_ref[t, sub, :]                          # (br, c)
        x = x_ref[_slot(cols_ref[t], c), feats]          # (c, bd)
        return acc + _dot(v, x)

    acc = jax.lax.fori_loop(ptr_ref[i], ptr_ref[i + 1], tile,
                            jnp.zeros((br, bd), _F32))
    out_ref[_slot(i * (r // br) + rs, br), feats] = acc.astype(
        out_ref.dtype)


def spmm_row_sweep_kernel(tile_ptr, tile_cols, vals, x):
    """vals: (T, R, C) tile-dense, x: (NCB·C, d) → y (NRB·R, d)."""
    _, r, c = vals.shape
    d = x.shape[1]
    nrb = tile_ptr.shape[0] - 1
    br, bd = min(SUB_BLOCK, r), feat_block(d)
    body = functools.partial(_row_sweep_body, r=r, c=c, br=br, bd=bd)
    return triton_call(
        body, grid=(nrb, r // br, d // bd),
        out_shape=jax.ShapeDtypeStruct((nrb * r, d), x.dtype),
        name="tiled_spmm_rows",
    )(tile_ptr, tile_cols, vals, x)
