"""Distributed (8 fake CPU devices) vs single-device op parity.

The multi-host test strategy SURVEY.md §4 prescribes: fake an 8-device
mesh with --xla_force_host_platform_device_count and check the
edge-partitioned ops — outputs and gradients — against the single-device
segment implementations.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.helpers import assert_allclose

from custom_op_benchmark_tpu.graph import random_graph
from custom_op_benchmark_tpu.ops import sddmm, edge_softmax, vector_spmm
from custom_op_benchmark_tpu.parallel import (
    dist_graph,
    dist_sddmm,
    dist_edge_softmax,
    dist_vector_spmm,
    dist_gat_attention,
    make_mesh,
)
from custom_op_benchmark_tpu.parallel.shard_ops import shard_nodes


@pytest.fixture(scope="module")
def setup():
    g = random_graph(50, 400, seed=0)
    mesh = make_mesh(axis_names=("edge",))
    dg = dist_graph(g, mesh)
    return g, mesh, dg


def _canon_scores(g, dg, y_dist):
    """Map edge-sharded scores back to canonical order for comparison."""
    # dist edges are the canonical list split contiguously with per-part
    # padding; rebuild canonical order from the partition plan.
    from custom_op_benchmark_tpu.graph.partition import edge_partition

    plan = edge_partition(g, dg.num_parts, pad_multiple=8)
    eid = plan.eid.reshape(-1)
    out = np.zeros((g.n_edges,) + y_dist.shape[1:], np.float32)
    y = np.asarray(y_dist)
    real = eid < g.n_edges
    out[eid[real]] = y[real]
    return out


def test_mesh_has_8_devices(setup):
    _, mesh, dg = setup
    assert mesh.shape["edge"] == 8
    assert dg.num_parts == 8


def test_dist_sddmm_matches_single(setup):
    g, mesh, dg = setup
    n, h, d = g.n_nodes, 2, 8
    A = jax.random.normal(jax.random.PRNGKey(0), (n, h, d))
    B = jax.random.normal(jax.random.PRNGKey(1), (n, h, d))
    y = np.asarray(sddmm(g, A, B))[: g.n_edges]
    As = shard_nodes(dg, mesh, A)
    Bs = shard_nodes(dg, mesh, B)
    yd = dist_sddmm(dg, mesh, As, Bs)
    assert_allclose(_canon_scores(g, dg, yd), y, atol=1e-5, rtol=1e-4)


def test_dist_softmax_matches_single(setup):
    g, mesh, dg = setup
    h = 2
    # Build edge data in the distributed layout from canonical data.
    x_canon = jax.random.normal(jax.random.PRNGKey(2), (g.n_edges, h))
    from custom_op_benchmark_tpu.graph.partition import edge_partition

    plan = edge_partition(g, dg.num_parts, pad_multiple=8)
    eid = plan.eid.reshape(-1)
    xn = np.zeros((len(eid), h), np.float32)
    real = eid < g.n_edges
    xn[real] = np.asarray(x_canon)[eid[real]]
    xd = jax.device_put(
        xn, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("edge"))
    )
    for by in ("src", "dst"):
        want = np.asarray(edge_softmax(g, x_canon, by=by))
        got = _canon_scores(g, dg, dist_edge_softmax(dg, mesh, xd, by=by))
        assert_allclose(got, want, atol=1e-5, rtol=1e-3)


def test_dist_spmm_matches_single(setup):
    g, mesh, dg = setup
    n, h, d = g.n_nodes, 2, 8
    edata_canon = jax.random.normal(jax.random.PRNGKey(3), (g.n_edges, h))
    x = jax.random.normal(jax.random.PRNGKey(4), (n, h, d))
    want = np.asarray(vector_spmm(g, edata_canon, x))

    from custom_op_benchmark_tpu.graph.partition import edge_partition

    plan = edge_partition(g, dg.num_parts, pad_multiple=8)
    eid = plan.eid.reshape(-1)
    en = np.zeros((len(eid), h), np.float32)
    real = eid < g.n_edges
    en[real] = np.asarray(edata_canon)[eid[real]]
    ed = jax.device_put(
        en, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("edge"))
    )
    xs = shard_nodes(dg, mesh, x)
    out = dist_vector_spmm(dg, mesh, ed, xs)
    assert_allclose(np.asarray(out)[:n], want, atol=1e-4, rtol=1e-4)


def test_dist_attention_matches_single_and_differentiates(setup):
    g, mesh, dg = setup
    n, h, d = g.n_nodes, 2, 8

    q = jax.random.normal(jax.random.PRNGKey(0), (n, h, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (n, h, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (n, h, d))

    def single(q, k, v):
        scores = sddmm(g, k, q) / jnp.sqrt(jnp.asarray(d, jnp.float32))
        alpha = edge_softmax(g, scores, by="dst")
        alpha = jnp.where(g.edge_mask[:, None], alpha, 0.0)
        rev = g.reverse()
        return vector_spmm(rev, alpha[g.csc_perm], v)

    want = np.asarray(single(q, k, v))

    qs = shard_nodes(dg, mesh, q)
    ks = shard_nodes(dg, mesh, k)
    vs = shard_nodes(dg, mesh, v)

    @jax.jit
    def dist(qs, ks, vs):
        return dist_gat_attention(dg, mesh, qs, ks, vs)

    got = np.asarray(dist(qs, ks, vs))[:n]
    assert_allclose(got, want, atol=1e-4, rtol=1e-3)

    # Gradients flow through collectives.
    def loss_d(qs, ks, vs):
        return (dist(qs, ks, vs) ** 2).sum()

    def loss_s(q, k, v):
        return (single(q, k, v) ** 2).sum()

    gd = jax.grad(loss_d, argnums=(0, 1, 2))(qs, ks, vs)
    gs = jax.grad(loss_s, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(gd, gs):
        assert_allclose(np.asarray(a)[:n], np.asarray(b), atol=1e-4,
                        rtol=1e-3)


def test_fit_edge_partitioned_transformer():
    """Distributed graph transformer (pre-LN attention + MLP blocks over
    the halo plan) trains to separation on the CPU mesh, both plans."""
    import numpy as np

    from custom_op_benchmark_tpu.data import planted_partition
    from custom_op_benchmark_tpu.parallel import (
        fit_edge_partitioned,
        make_mesh,
    )

    ds = planted_partition(num_classes=3, nodes_per_class=80, feat_dim=16,
                           avg_degree=8, seed=2)
    mesh = make_mesh((4,), ("edge",))
    _, m_halo = fit_edge_partitioned(
        ds, mesh, hidden=32, num_heads=2, num_layers=2, epochs=60,
        learning_rate=2e-3, plan="halo", arch="transformer")
    assert m_halo["val_acc"] > 0.85, m_halo
    _, m_gather = fit_edge_partitioned(
        ds, mesh, hidden=32, num_heads=2, num_layers=2, epochs=30,
        learning_rate=2e-3, plan="gather", arch="transformer")
    assert np.isfinite(m_gather["loss"]), m_gather


def test_pick_order_by_graph_structure():
    """fit_edge_partitioned's order="auto" must pick
    degree_balanced_order on a locality-free power-law graph (waste-
    bound: striping cuts max-shard padded slots up to 1.5x) and
    cluster_order on a uniform-degree graph
    with perfect locality (disjoint cliques: striping can't improve
    identical degree profiles but blows every clique across shards)."""
    from custom_op_benchmark_tpu.graph import (
        clique_batch, cluster_order, degree_balanced_order, random_graph,
    )
    from custom_op_benchmark_tpu.parallel.train_dist import _pick_order

    g_pl = random_graph(2048, 40_000, seed=0, power_law=True)
    assert np.array_equal(
        _pick_order(g_pl, 4).perm, degree_balanced_order(g_pl, 4).perm)

    g_cl = clique_batch(64, 16)
    assert np.array_equal(
        _pick_order(g_cl, 4).perm, cluster_order(g_cl, 4).perm)
