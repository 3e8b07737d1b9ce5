"""The tiled strategy's building blocks vs dense numpy references, and the
explicit interpreter switch of the Pallas kernels.

Each block (ops/tiled.py) runs the implementation the repo keeps for it —
a Pallas kernel (in the interpreter here) or plain XLA — and is checked
against a dense reference built from the tile arrays alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custom_op_benchmark_tpu.graph import from_coo
from custom_op_benchmark_tpu.graph.tiled import tile_graph
from custom_op_benchmark_tpu.ops import pallas as ops_pallas
from custom_op_benchmark_tpu.ops import tiled
from custom_op_benchmark_tpu.ops import vector_spmm

T = 8   # tile side: small tiles keep interpreter runs fast


@pytest.fixture(scope="module")
def tg():
    rng = np.random.default_rng(5)
    n = 40
    mask = rng.random((n, n)) < 0.15
    # Leave rows 8..15 without out-edges and cols 16..23 without
    # in-edges: an empty row block and an empty col block must write 0.
    mask[8:16, :] = False
    mask[:, 16:24] = False
    src, dst = np.nonzero(mask)
    return tile_graph(from_coo(src, dst, n), T, T)


def _dense(tg, tiles):
    """(T, R, C) tile values → dense (n_rows_padded, n_cols_padded)."""
    out = np.zeros((tg.n_rows_padded, tg.n_cols_padded), np.float64)
    rows = np.asarray(tg.tile_rows)
    cols = np.asarray(tg.tile_cols)
    for t, (i, j) in enumerate(zip(rows, cols)):
        out[i * T:(i + 1) * T, j * T:(j + 1) * T] += np.asarray(tiles[t])
    return out


def _inputs(tg, d, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(tg.n_rows_padded, d)).astype(np.float32)
    B = rng.normal(size=(tg.n_cols_padded, d)).astype(np.float32)
    vals = rng.normal(size=tg.mask.shape).astype(np.float32)
    vals = np.where(np.asarray(tg.mask), vals, 0).astype(np.float32)
    return A, B, vals


@pytest.mark.parametrize("d", [16, 32])
def test_sddmm_block_matches_dense(tg, d):
    A, B, _ = _inputs(tg, d)
    got = tiled._sddmm_tiles(tiled._meta(tg), tg.mask, jnp.asarray(A),
                             jnp.asarray(B))
    dense_mask = _dense(tg, np.asarray(tg.mask, np.float64)) > 0
    want = np.where(dense_mask, A.astype(np.float64) @ B.T, 0)
    np.testing.assert_allclose(_dense(tg, got), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d", [16, 32])
def test_row_sweep_block_matches_dense(tg, d):
    _, B, vals = _inputs(tg, d, seed=1)
    got = tiled._row_sweep(tiled._meta(tg), jnp.asarray(vals),
                           jnp.asarray(B))
    want = _dense(tg, vals) @ B.astype(np.float64)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5)
    assert not np.asarray(got)[8:16].any()        # empty row block


@pytest.mark.parametrize("d", [16, 32])
def test_col_sweep_block_matches_dense(tg, d):
    A, _, vals = _inputs(tg, d, seed=2)
    got = tiled._col_sweep(tiled._meta(tg), jnp.asarray(vals),
                           jnp.asarray(A))
    want = _dense(tg, vals).T @ A.astype(np.float64)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5)
    assert not np.asarray(got)[16:24].any()       # empty col block


def test_attention_block_matches_dense(tg):
    d = 16
    A, B, _ = _inputs(tg, d, seed=3)
    V = np.random.default_rng(4).normal(
        size=(tg.n_cols_padded, d)).astype(np.float32)
    scale = 0.25
    got = tiled._attention_rows(tiled._meta(tg), tg.mask, jnp.asarray(A),
                                jnp.asarray(B), jnp.asarray(V), scale)
    mask = _dense(tg, np.asarray(tg.mask, np.float64)) > 0
    s = np.where(mask, A.astype(np.float64) @ B.T * scale, -np.inf)
    m = np.max(s, axis=1, keepdims=True)
    p = np.where(mask, np.exp(s - np.where(np.isfinite(m), m, 0)), 0)
    den = p.sum(1, keepdims=True)
    alpha = np.where(den > 0, p / np.where(den > 0, den, 1), 0)
    np.testing.assert_allclose(np.asarray(got), alpha @ V, rtol=1e-5,
                               atol=1e-5)
    assert not np.asarray(got)[8:16].any()        # rows with no edges


@pytest.mark.parametrize("d,want", [(1, 16), (8, 16), (16, 16), (24, 32),
                                    (64, 64), (100, 128), (128, 128),
                                    (300, 128)])
def test_feat_block_and_padding(d, want):
    """Feature chunks are powers of two in [16, 128]; padded widths are
    whole chunks."""
    assert ops_pallas.feat_block(d) == want
    x, d0 = tiled._pad_feat(jnp.zeros((3, d)))
    assert d0 == d and x.shape[1] % want == 0 and x.shape[1] >= d


def test_kernels_raise_without_interpreter_off_gpu(tg):
    """Off the GPU a Pallas kernel raises an error that names the cause
    unless the interpreter was switched on; it never falls back."""
    _, B, vals = _inputs(tg, 16)
    ops_pallas.interpret_mode(False)
    try:
        with pytest.raises(RuntimeError, match="interpret_mode"):
            ops_pallas.spmm_row_sweep_kernel(
                tg.tile_ptr, tg.tile_cols, jnp.asarray(vals),
                jnp.asarray(B))
    finally:
        ops_pallas.interpret_mode(True)


def test_public_tiled_op_raises_without_interpreter_off_gpu():
    """The same through the public API: impl="tiled" on a CPU backend."""
    from custom_op_benchmark_tpu.graph import clique_batch

    g = clique_batch(3, 7)
    x = jnp.ones((g.n_nodes, 24))
    ed = jnp.ones((g.num_edges_padded,))
    ops_pallas.interpret_mode(False)
    try:
        with pytest.raises(RuntimeError, match="GPU"):
            jax.jit(lambda e, x: vector_spmm(g, e, x, impl="tiled"))(ed, x)
    finally:
        ops_pallas.interpret_mode(True)
