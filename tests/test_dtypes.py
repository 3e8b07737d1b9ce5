"""Mixed-precision behavior: the op family must accept bf16 inputs.

Idiom: bf16 storage/matmul inputs with f32 accumulation
(preferred_element_type) — the reference is fp32/fp64-only
(AT_DISPATCH_FLOATING_TYPES, graphop_kernel.cu:254).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custom_op_benchmark_tpu.graph import block_graph, clique_batch
from custom_op_benchmark_tpu.ops import (
    block_attention,
    block_spmm,
    edge_softmax,
    sddmm,
    vector_spmm,
)


@pytest.fixture(scope="module")
def setup():
    g = clique_batch(4, 10)
    rng = np.random.default_rng(0)
    return g, rng


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_op_family_dtypes(setup, dtype):
    g, rng = setup
    n, e, d = g.n_nodes, g.n_edges, 16
    A = jnp.asarray(rng.normal(size=(n, d)), dtype)
    B = jnp.asarray(rng.normal(size=(n, d)), dtype)
    s = sddmm(g, A, B)
    assert s.dtype == dtype
    a = edge_softmax(g, s, by="src")
    assert a.dtype == dtype
    y = vector_spmm(g, a, B)
    assert y.dtype == dtype and y.shape == (n, d)
    assert bool(jnp.isfinite(y.astype(jnp.float32)).all())


def test_bf16_matches_f32_loosely(setup):
    g, rng = setup
    n, d = g.n_nodes, 16
    A32 = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    B32 = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    y32 = vector_spmm(g, jnp.ones((g.n_edges,), jnp.float32), A32)
    y16 = vector_spmm(
        g, jnp.ones((g.n_edges,), jnp.bfloat16), A32.astype(jnp.bfloat16)
    )
    np.testing.assert_allclose(
        np.asarray(y16.astype(jnp.float32)), np.asarray(y32),
        rtol=2e-2, atol=2e-2,
    )
    del B32


def test_block_ops_bf16(setup):
    g, rng = setup
    bg = block_graph(g)
    n, d = g.n_nodes, 16
    q = jnp.asarray(rng.normal(size=(n, d)), jnp.bfloat16)
    ed = jnp.asarray(rng.uniform(size=(g.n_edges,)), jnp.bfloat16)
    y = block_spmm(bg, bg.scatter_edges(ed), bg.scatter_nodes(q))
    assert y.dtype == jnp.bfloat16
    out = block_attention(bg, *(bg.scatter_nodes(q),) * 3)
    assert out.dtype == jnp.bfloat16
    assert bool(jnp.isfinite(out.astype(jnp.float32)).all())


def test_mixed_precision_models_train():
    """GAT(dtype=bf16) / GraphTransformer(dtype=bf16): f32 params, bf16
    activations through the fused ops, f32 logits — forward close to the
    f32 model at bf16 tolerance, and training converges."""
    import jax

    from custom_op_benchmark_tpu.data.synthetic import planted_partition
    from custom_op_benchmark_tpu.models import GAT, GraphTransformer
    from custom_op_benchmark_tpu.ops import ell_dual
    from custom_op_benchmark_tpu.train.loop import fit_full_graph

    ds = planted_partition(num_classes=4, nodes_per_class=60, seed=3)
    se, de = ell_dual(ds.graph)
    x = jnp.asarray(ds.features)

    for make in (
        lambda dt: GAT(hidden_dim=16, out_dim=4, num_layers=2,
                       num_heads=2, dtype=dt),
        lambda dt: GraphTransformer(dim=16, num_heads=2, num_layers=2,
                                    out_dim=4, dtype=dt),
    ):
        m32, m16 = make(None), make(jnp.bfloat16)
        params = m32.init(jax.random.PRNGKey(0), ds.graph, x,
                          ell=(se, de))["params"]
        y32 = m32.apply({"params": params}, ds.graph, x, ell=(se, de))
        y16 = m16.apply({"params": params}, ds.graph, x, ell=(se, de))
        assert y16.dtype == jnp.float32          # logits come back f32
        np.testing.assert_allclose(np.asarray(y16), np.asarray(y32),
                                   rtol=0.1, atol=0.15)

    _, metrics = fit_full_graph(
        GAT(hidden_dim=16, out_dim=4, num_layers=2, num_heads=2,
            dtype=jnp.bfloat16),
        ds, epochs=60, strategy="ell",
    )
    assert metrics["val_acc"] > 0.9, metrics
