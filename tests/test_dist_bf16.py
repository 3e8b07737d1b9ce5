"""bf16 on the distributed halo path (round-4 verdict #2).

The repo's mixed-precision policy (GAT(dtype=bf16): params f32,
activations + gathered tiles bf16) extended to
the halo plan: with bf16 q/k/v the forward k‖v all_to_all, the
backward's re-exchange AND the reverse dk‖dv all_to_all all carry bf16
(parallel/halo.py wire-dtype casts), halving comm bytes. These tests
gate the numerics on the 8-fake-device CPU mesh at the same tolerance
tiers as tests/test_dtypes.py (reference dtype breadth:
graphop_kernel.cu:254 AT_DISPATCH_FLOATING_TYPES, translated to bf16
storage + f32 accumulation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custom_op_benchmark_tpu.graph import clique_batch, random_graph
from custom_op_benchmark_tpu.parallel import make_mesh
from custom_op_benchmark_tpu.parallel.halo import (
    halo_attention_ell,
    halo_edge_data,
    halo_ell,
    halo_graph,
    halo_spmm_ell,
    shard_halo_nodes,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs a multi-device mesh"
)


@pytest.fixture(scope="module", params=["power_law", "clique"])
def setup(request):
    if request.param == "power_law":
        g = random_graph(96, 800, seed=2, power_law=True)
    else:
        g = clique_batch(8, 11)
    mesh = make_mesh((4,), ("edge",))
    hg = halo_graph(g, mesh, hub_threshold="auto")
    he = halo_ell(hg, mesh)
    rng = np.random.default_rng(0)
    return g, mesh, hg, he, rng


def _qkv(hg, mesh, rng, n, h, d, dtype):
    arrs = [rng.normal(size=(n, h, d)).astype(np.float32)
            for _ in range(3)]
    return [shard_halo_nodes(hg, mesh, a).astype(dtype) for a in arrs]


def test_halo_attention_bf16_forward(setup):
    g, mesh, hg, he, rng = setup
    n, h, d = g.n_nodes, 2, 8
    q32, k32, v32 = _qkv(hg, mesh, rng, n, h, d, jnp.float32)
    y32 = halo_attention_ell(hg, he, mesh, q32, k32, v32)
    y16 = halo_attention_ell(
        hg, he, mesh,
        q32.astype(jnp.bfloat16), k32.astype(jnp.bfloat16),
        v32.astype(jnp.bfloat16))
    assert y16.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(y16.astype(jnp.float32))[:n],
        np.asarray(y32)[:n], rtol=5e-2, atol=5e-2,
    )


def test_halo_attention_bf16_grads(setup):
    """The hand VJP with bf16 storage: dq/dk/dv close to the f32 VJP at
    bf16 tolerance — this exercises the bf16 wire on BOTH directions
    (forward k‖v exchange and the reverse dk‖dv all_to_all +
    psum_scatter landing with f32 accumulation)."""
    g, mesh, hg, he, rng = setup
    n, h, d = g.n_nodes, 2, 8
    q32, k32, v32 = _qkv(hg, mesh, rng, n, h, d, jnp.float32)

    def loss(q, k, v):
        y = halo_attention_ell(hg, he, mesh, q, k, v)
        return (y.astype(jnp.float32) ** 2).sum()

    g32 = jax.grad(loss, argnums=(0, 1, 2))(q32, k32, v32)
    g16 = jax.grad(loss, argnums=(0, 1, 2))(
        q32.astype(jnp.bfloat16), k32.astype(jnp.bfloat16),
        v32.astype(jnp.bfloat16))
    for a16, a32, name in zip(g16, g32, "qkv"):
        assert a16.dtype == jnp.bfloat16, name
        ref = np.asarray(a32)[:n]
        got = np.asarray(a16.astype(jnp.float32))[:n]
        # bf16 has ~3 decimal digits; grads pass through exp/softmax so
        # compare with a scale-aware tolerance.
        tol = 6e-2 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=6e-2, atol=tol,
                                   err_msg=f"d{name}")


def test_halo_spmm_bf16_grads(setup):
    g, mesh, hg, he, rng = setup
    n, d = g.n_nodes, 8
    x32 = shard_halo_nodes(
        hg, mesh, rng.normal(size=(n, d)).astype(np.float32))
    ed = rng.uniform(size=g.num_edges_padded).astype(np.float32)
    ed_h = halo_edge_data(hg, mesh, ed)

    def loss(ed_, x):
        y = halo_spmm_ell(hg, he, mesh, ed_, x)
        return (y.astype(jnp.float32) ** 2).sum()

    de32, dx32 = jax.grad(loss, argnums=(0, 1))(ed_h, x32)
    de16, dx16 = jax.grad(loss, argnums=(0, 1))(
        ed_h, x32.astype(jnp.bfloat16))
    assert dx16.dtype == jnp.bfloat16
    ref = np.asarray(dx32)
    tol = 6e-2 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(
        np.asarray(dx16.astype(jnp.float32)), ref,
        rtol=6e-2, atol=tol)
    np.testing.assert_allclose(
        np.asarray(de16), np.asarray(de32), rtol=6e-2, atol=tol)


@pytest.mark.parametrize("arch", ["gat", "transformer"])
def test_fit_edge_partitioned_bf16(arch):
    """End-to-end distributed training with dtype=bf16: params stay
    f32, loss decreases, metrics finite (the round-4 verdict #2 gate)."""
    from custom_op_benchmark_tpu.data.synthetic import planted_partition
    from custom_op_benchmark_tpu.parallel.train_dist import (
        fit_edge_partitioned,
    )

    ds = planted_partition(nodes_per_class=48, num_classes=3,
                           feat_dim=16, avg_degree=6, seed=0)
    mesh = make_mesh((4,), ("edge",))
    params, metrics = fit_edge_partitioned(
        ds, mesh, hidden=16, num_heads=2, num_layers=2, epochs=8,
        arch=arch, dtype=jnp.bfloat16)
    assert np.isfinite(metrics["loss"])
    assert metrics["train_acc"] >= 0.5, metrics
    # Mixed precision: master params stay f32.
    leaves = jax.tree_util.tree_leaves(
        {k: v for k, v in params.items()
         if k not in ("num_heads", "head_dim")})
    assert all(leaf.dtype == jnp.float32 for leaf in leaves
               if hasattr(leaf, "dtype") and jnp.issubdtype(
                   leaf.dtype, jnp.floating))
