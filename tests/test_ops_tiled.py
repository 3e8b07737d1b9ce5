"""Tiled op path vs the segment-op oracle.

Pallas kernels run in the interpreter on CPU (switched on in conftest;
small tiles keep interpret runs fast); the same code paths compile for the
GPU (exercised by chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.helpers import assert_allclose

from custom_op_benchmark_tpu.graph import clique_batch, from_coo
from custom_op_benchmark_tpu.graph.tiled import tile_graph
from custom_op_benchmark_tpu.ops import sddmm, edge_softmax, vector_spmm
from custom_op_benchmark_tpu.ops.tiled import (
    tiled_attention,
    tiled_sddmm,
    tiled_softmax,
    tiled_spmm,
)

TR = TC = 8  # small tiles: fast in interpret mode


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    n = 30
    mask = rng.random((n, n)) < 0.25
    np.fill_diagonal(mask, True)
    src, dst = np.nonzero(mask)
    g = from_coo(src, dst, n)
    tg = tile_graph(g, TR, TC)
    return g, tg


def test_tiled_sddmm_matches_segment(setup):
    g, tg = setup
    n, d = g.n_nodes, 16
    A = jax.random.normal(jax.random.PRNGKey(0), (n, d))
    B = jax.random.normal(jax.random.PRNGKey(1), (n, d))
    want = np.asarray(sddmm(g, A, B))
    tiles = tiled_sddmm(tg, A, B)
    got = np.asarray(tg.gather_edges(tiles))
    assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_tiled_sddmm_grads(setup):
    g, tg = setup
    n, d = g.n_nodes, 16
    A = jax.random.normal(jax.random.PRNGKey(0), (n, d))
    B = jax.random.normal(jax.random.PRNGKey(1), (n, d))
    cot = jax.random.normal(jax.random.PRNGKey(2), (g.n_edges,))

    def loss_tiled(A, B):
        return (tg.gather_edges(tiled_sddmm(tg, A, B)) * cot).sum()

    def loss_seg(A, B):
        return (sddmm(g, A, B) * cot).sum()

    gt = jax.grad(loss_tiled, argnums=(0, 1))(A, B)
    gs = jax.grad(loss_seg, argnums=(0, 1))(A, B)
    for a, b in zip(gt, gs):
        assert_allclose(np.asarray(a)[:n], b, atol=1e-4, rtol=1e-4)


def test_tiled_spmm_matches_segment(setup):
    g, tg = setup
    n, d = g.n_nodes, 16
    edata = jax.random.normal(jax.random.PRNGKey(0), (g.n_edges,))
    x = jax.random.normal(jax.random.PRNGKey(1), (n, d))
    want = np.asarray(vector_spmm(g, edata, x))
    vals = tg.scatter_edges(edata)[: tg.num_tiles]
    got = np.asarray(tiled_spmm(tg, vals, x))
    assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_tiled_spmm_grads(setup):
    g, tg = setup
    n, d = g.n_nodes, 16
    edata = jax.random.normal(jax.random.PRNGKey(0), (g.n_edges,))
    x = jax.random.normal(jax.random.PRNGKey(1), (n, d))
    cot = jax.random.normal(jax.random.PRNGKey(2), (n, d))

    def loss_tiled(edata, x):
        vals = tg.scatter_edges(edata)[: tg.num_tiles]
        return (tiled_spmm(tg, vals, x) * cot).sum()

    def loss_seg(edata, x):
        return (vector_spmm(g, edata, x) * cot).sum()

    gt = jax.grad(loss_tiled, argnums=(0, 1))(edata, x)
    gs = jax.grad(loss_seg, argnums=(0, 1))(edata, x)
    for a, b in zip(gt, gs):
        assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("by", ["src", "dst"])
def test_tiled_softmax_matches_segment(setup, by):
    g, tg = setup
    x = jax.random.normal(jax.random.PRNGKey(0), (g.n_edges,))
    want = np.asarray(edge_softmax(g, x, by=by))
    tiles = tg.scatter_edges(x)[: tg.num_tiles]
    got = np.asarray(tg.gather_edges(tiled_softmax(tg, tiles, by=by)))
    assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_tiled_transpose_roundtrip(setup):
    g, tg = setup
    tgT = tg.transpose()
    assert tgT.num_tiles == tg.num_tiles
    assert int(np.asarray(tgT.mask).sum()) == tg.n_edges
    # Edge values survive scatter through the transposed tiling.
    vals = jnp.arange(1.0, g.n_edges + 1)
    tiles_T = tgT.scatter_edges(vals)[: tg.num_tiles]
    back = tgT.gather_edges(tiles_T)
    assert_allclose(back[: g.n_edges], vals, atol=0, rtol=0)
    # Double transpose = identity on the mask.
    tgTT = tgT.transpose()
    assert_allclose(
        np.asarray(tgTT.mask), np.asarray(tg.mask), atol=0, rtol=0
    )


@pytest.mark.parametrize("normalize", ["src", "dst"])
def test_tiled_attention_matches_composition(setup, normalize):
    g, tg = setup
    n, d = g.n_nodes, 16
    q = jax.random.normal(jax.random.PRNGKey(0), (n, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (n, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (n, d))
    scale = 1.0 / np.sqrt(d)

    def composition(q, k, v):
        if normalize == "src":
            scores = sddmm(g, q, k) * scale
            alpha = edge_softmax(g, scores, by="src")
            return vector_spmm(g, alpha, v)
        scores = sddmm(g, k, q) * scale   # <k[src], q[dst]>
        alpha = edge_softmax(g, scores, by="dst")
        rev = g.reverse()
        return vector_spmm(rev, alpha[g.csc_perm], v)

    want = np.asarray(composition(q, k, v))
    got = np.asarray(tiled_attention(tg, q, k, v, normalize=normalize))
    assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_tiled_attention_grads(setup):
    g, tg = setup
    n, d = g.n_nodes, 16
    q = jax.random.normal(jax.random.PRNGKey(0), (n, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (n, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (n, d))
    cot = jax.random.normal(jax.random.PRNGKey(3), (n, d))
    scale = 1.0 / np.sqrt(d)

    def loss_tiled(q, k, v):
        return (tiled_attention(tg, q, k, v, normalize="src") * cot).sum()

    def loss_seg(q, k, v):
        scores = sddmm(g, q, k) * scale
        alpha = edge_softmax(g, scores, by="src")
        return (vector_spmm(g, alpha, v) * cot).sum()

    gt = jax.grad(loss_tiled, argnums=(0, 1, 2))(q, k, v)
    gs = jax.grad(loss_seg, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(gt, gs):
        assert_allclose(a, b, atol=1e-4, rtol=1e-3)


def test_tiled_attention_multihead(setup):
    g, tg = setup
    n, h, d = g.n_nodes, 3, 8
    q = jax.random.normal(jax.random.PRNGKey(0), (n, h, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (n, h, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (n, h, d))
    out = tiled_attention(tg, q, k, v, normalize="src")
    assert out.shape == (n, h, d)
    # Spot-check one head against the single-head path.
    out0 = tiled_attention(tg, q[:, 0], k[:, 0], v[:, 0], normalize="src")
    assert_allclose(out[:, 0], out0, atol=1e-5, rtol=1e-4)


def test_tiled_on_clique_workload():
    """The reference workload: block-diagonal cliques tile perfectly."""
    g = clique_batch(4, 8)
    tg = tile_graph(g, 8, 8)
    assert tg.density == 1.0   # cliques of 8 == the tile size
    n, d = g.n_nodes, 16
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d))
    edata = jnp.ones(g.n_edges)
    vals = tg.scatter_edges(edata)[: tg.num_tiles]
    got = np.asarray(tiled_spmm(tg, vals, x))
    want = np.asarray(vector_spmm(g, edata, x))
    assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("by", ["src", "dst"])
def test_tiled_softmax_never_scatters(setup, by):
    """Round-2 verdict #9: the segment max/sum inside tiled_softmax must
    run as segmented scans over the sorted tile order — no scatter in
    the jaxpr, forward or backward."""
    g, tg = setup
    x = jax.random.normal(jax.random.PRNGKey(0), (g.n_edges,))
    tiles = tg.scatter_edges(x)[: tg.num_tiles]
    jaxpr_fwd = str(jax.make_jaxpr(
        lambda t: tiled_softmax(tg, t, by=by))(tiles))
    assert "scatter" not in jaxpr_fwd
    jaxpr_bwd = str(jax.make_jaxpr(jax.grad(
        lambda t: (tiled_softmax(tg, t, by=by) ** 2).sum()))(tiles))
    assert "scatter" not in jaxpr_bwd
