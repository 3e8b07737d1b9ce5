"""Model-layer tests: shapes, gradients, and end-to-end convergence.

The convergence test is the golden-accuracy gate SURVEY.md §4 calls for
(BASELINE.md config 1: single-chip GAT trained to convergence).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.helpers import assert_allclose

from custom_op_benchmark_tpu.data import planted_partition
from custom_op_benchmark_tpu.graph import clique_batch
from custom_op_benchmark_tpu.models import (
    GAT,
    GCN,
    GATLayer,
    GCNLayer,
    GraphSAGE,
    GraphTransformer,
)
from custom_op_benchmark_tpu.train import (
    create_train_state,
    fit_full_graph,
    make_train_step,
)


@pytest.fixture(scope="module")
def tiny_ds():
    return planted_partition(
        num_classes=4, nodes_per_class=40, feat_dim=16, avg_degree=8,
        seed=0, pad_multiple=256,
    )


@pytest.mark.parametrize("model_cls,kw", [
    (GAT, dict(hidden_dim=8, out_dim=4, num_heads=2)),
    (GCN, dict(hidden_dim=8, out_dim=4)),
    (GraphSAGE, dict(hidden_dim=8, out_dim=4)),
    (GraphTransformer, dict(dim=8, num_heads=2, num_layers=1, out_dim=4)),
])
def test_model_forward_and_grad(tiny_ds, model_cls, kw):
    ds = tiny_ds
    model = model_cls(**kw)
    x = jnp.asarray(ds.features)
    params = model.init(jax.random.PRNGKey(0), ds.graph, x)["params"]
    logits = model.apply({"params": params}, ds.graph, x)
    assert logits.shape == (ds.graph.n_nodes, 4)
    assert bool(jnp.all(jnp.isfinite(logits)))

    def loss(p):
        out = model.apply({"params": p}, ds.graph, x)
        return (out ** 2).mean()

    grads = jax.grad(loss)(params)
    flat = jax.tree_util.tree_leaves(grads)
    assert all(bool(jnp.all(jnp.isfinite(g))) for g in flat)
    # At least one nonzero gradient per leaf group.
    assert any(float(jnp.abs(g).max()) > 0 for g in flat)


def test_gat_converges(tiny_ds):
    """Golden end-to-end gate: 2-layer GAT separates the planted classes."""
    ds = tiny_ds
    model = GAT(hidden_dim=16, out_dim=ds.num_classes, num_heads=2)
    state, metrics = fit_full_graph(
        model, ds, epochs=60, learning_rate=5e-3
    )
    assert metrics["val_acc"] > 0.75, metrics


def test_gcn_converges(tiny_ds):
    ds = tiny_ds
    model = GCN(hidden_dim=16, out_dim=ds.num_classes)
    state, metrics = fit_full_graph(model, ds, epochs=60,
                                    learning_rate=1e-2)
    assert metrics["val_acc"] > 0.75, metrics


def test_transformer_runs_on_clique_batch():
    """The transformer on the reference workload shape (scaled down)."""
    g = clique_batch(8, 12)
    x = jax.random.normal(jax.random.PRNGKey(0), (g.n_nodes, 16))
    model = GraphTransformer(dim=16, num_heads=4, num_layers=2)
    params = model.init(jax.random.PRNGKey(1), g, x)["params"]
    y = model.apply({"params": params}, g, x)
    assert y.shape == (g.n_nodes, 16)
    assert bool(jnp.all(jnp.isfinite(y)))


def test_train_step_is_jittable_and_donatable(tiny_ds):
    ds = tiny_ds
    model = GCN(hidden_dim=8, out_dim=ds.num_classes)
    x = jnp.asarray(ds.features)
    state = create_train_state(model, ds.graph, x, jax.random.PRNGKey(0))
    step = make_train_step()
    labels = jnp.asarray(ds.labels)
    mask = jnp.asarray(ds.train_mask)
    s1, loss1, _ = step(state, ds.graph, x, labels, mask)
    s2, loss2, _ = step(s1, ds.graph, x, labels, mask)
    assert float(loss2) < float(loss1) * 1.5  # sane, decreasing-ish
    assert int(s2.step) == 2


def test_transformer_block_path_matches_segment_path():
    """block=/tiled= execution strategies must be numerically equivalent
    to the segment path (same params, same outputs)."""
    from custom_op_benchmark_tpu.graph import block_graph
    from custom_op_benchmark_tpu.graph.tiled import tile_graph

    g = clique_batch(6, 10)
    bg = block_graph(g)
    tg = tile_graph(g, 16, 16)
    x = jax.random.normal(jax.random.PRNGKey(0), (g.n_nodes, 16))
    model = GraphTransformer(dim=16, num_heads=2, num_layers=2)
    params = model.init(jax.random.PRNGKey(1), g, x)["params"]

    with jax.default_matmul_precision("highest"):
        y_seg = model.apply({"params": params}, g, x)
        y_blk = model.apply({"params": params}, g, x, block=bg)
        y_til = model.apply({"params": params}, g, x, tiled=tg)
    np.testing.assert_allclose(np.asarray(y_blk), np.asarray(y_seg),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(y_til), np.asarray(y_seg),
                               rtol=2e-3, atol=2e-3)


def test_transformer_ell_path_matches_segment_path():
    from custom_op_benchmark_tpu.graph import random_graph
    from custom_op_benchmark_tpu.ops import ell_dual

    g = random_graph(80, 600, seed=3, power_law=True)
    ell = ell_dual(g)
    x = jax.random.normal(jax.random.PRNGKey(0), (g.n_nodes, 16))
    model = GraphTransformer(dim=16, num_heads=2, num_layers=2)
    params = model.init(jax.random.PRNGKey(1), g, x)["params"]
    with jax.default_matmul_precision("highest"):
        y_seg = model.apply({"params": params}, g, x)
        y_ell = model.apply({"params": params}, g, x, ell=ell)
    np.testing.assert_allclose(np.asarray(y_ell), np.asarray(y_seg),
                               rtol=2e-3, atol=2e-3)


def test_transformer_edge_features_relative_position():
    """NodeMulEdge-backed relative-position scores (reference use case,
    graphop_kernel.cu:17 comment) change the output and stay finite."""
    g = clique_batch(4, 8)
    x = jax.random.normal(jax.random.PRNGKey(0), (g.n_nodes, 16))
    ef = jax.random.normal(jax.random.PRNGKey(1),
                           (g.num_edges_padded, 8))
    model = GraphTransformer(dim=16, num_heads=2, num_layers=1)
    params = model.init(jax.random.PRNGKey(2), g, x, ef)["params"]
    y_with = model.apply({"params": params}, g, x, ef)
    y_without = model.apply({"params": params}, g, x)
    assert bool(jnp.all(jnp.isfinite(y_with)))
    assert float(jnp.max(jnp.abs(y_with - y_without))) > 1e-6
    # Gradients flow through the edge features.
    gef = jax.grad(lambda ef: (model.apply(
        {"params": params}, g, x, ef) ** 2).sum())(ef)
    assert float(jnp.abs(gef).sum()) > 0


def test_training_with_dropout(tiny_ds):
    ds = tiny_ds
    model = GAT(hidden_dim=16, out_dim=ds.num_classes, num_heads=2,
                dropout_rate=0.3)
    x = jnp.asarray(ds.features)
    labels = jnp.asarray(ds.labels)
    mask = jnp.asarray(ds.train_mask)
    state = create_train_state(model, ds.graph, x, jax.random.PRNGKey(0))
    step = make_train_step(dropout=True)
    losses = []
    for i in range(8):
        state, loss, _ = step(state, ds.graph, x, labels, mask,
                              rng=jax.random.PRNGKey(i))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    # Tolerant of dropout-mask noise (masks are stochastic per step).
    assert np.mean(losses[-3:]) < losses[0] * 1.2


def test_gin_converges_and_ell_path_matches(tiny_ds):
    from custom_op_benchmark_tpu.models import GIN
    from custom_op_benchmark_tpu.ops import ell_dual
    from custom_op_benchmark_tpu.train import fit_full_graph

    ds = tiny_ds
    model = GIN(hidden_dim=32, out_dim=ds.num_classes)
    _, metrics = fit_full_graph(model, ds, epochs=60, learning_rate=5e-3)
    assert metrics["val_acc"] > 0.75, metrics

    g = ds.graph
    x = jnp.asarray(ds.features)
    params = model.init(jax.random.PRNGKey(0), g, x)["params"]
    with jax.default_matmul_precision("highest"):
        y_seg = model.apply({"params": params}, g, x)
        y_ell = model.apply({"params": params}, g, x, ell=ell_dual(g))
    np.testing.assert_allclose(np.asarray(y_ell), np.asarray(y_seg),
                               rtol=2e-3, atol=2e-3)


def test_fit_full_graph_auto_strategy():
    """strategy='auto' consults the structural advisor and trains."""
    from custom_op_benchmark_tpu.data.synthetic import planted_partition
    from custom_op_benchmark_tpu.models import GAT
    from custom_op_benchmark_tpu.train.loop import fit_full_graph

    ds = planted_partition(num_classes=3, nodes_per_class=60, feat_dim=8,
                           avg_degree=6, seed=1)
    m = GAT(hidden_dim=16, out_dim=3, num_layers=2, num_heads=2)
    _, metrics = fit_full_graph(m, ds, epochs=25, strategy="auto")
    assert metrics["val_acc"] > 0.8, metrics


def test_gat_block_path_matches_segment_path():
    """GAT's dense-block fast path (block_gat_attention + whole-stack
    layout) must match the segment path — outputs AND parameter grads."""
    from custom_op_benchmark_tpu.graph import block_graph

    g = clique_batch(6, 10)
    bg = block_graph(g)
    x = jax.random.normal(jax.random.PRNGKey(0), (g.n_nodes, 16))
    model = GAT(hidden_dim=8, out_dim=5, num_layers=2, num_heads=2)
    params = model.init(jax.random.PRNGKey(1), g, x)["params"]

    def loss(p, **kw):
        return (model.apply({"params": p}, g, x, **kw) ** 2).sum()

    with jax.default_matmul_precision("highest"):
        y_seg = model.apply({"params": params}, g, x)
        y_blk = model.apply({"params": params}, g, x, block=bg)
        g_seg = jax.grad(loss)(params)
        g_blk = jax.grad(loss)(params, block=bg)
    np.testing.assert_allclose(np.asarray(y_blk), np.asarray(y_seg),
                               rtol=2e-3, atol=2e-3)
    jax.tree_util.tree_map(
        lambda va, vb: np.testing.assert_allclose(
            np.asarray(vb), np.asarray(va), rtol=5e-3, atol=5e-3),
        g_seg, g_blk)


def test_copy_aggregation_models_block_path_matches_segment():
    """GCN/GraphSAGE/GIN dense-block fast paths (block_copy_spmm +
    whole-stack layout) match their segment paths, outputs and grads."""
    from custom_op_benchmark_tpu.graph import block_graph
    from custom_op_benchmark_tpu.models import GCN, GIN, GraphSAGE

    g = clique_batch(5, 9)
    bg = block_graph(g)
    x = jax.random.normal(jax.random.PRNGKey(0), (g.n_nodes, 12))
    for model in (GCN(hidden_dim=8, out_dim=4),
                  GraphSAGE(hidden_dim=8, out_dim=4),
                  GIN(hidden_dim=8, out_dim=4)):
        params = model.init(jax.random.PRNGKey(1), g, x)["params"]

        def loss(p, **kw):
            return (model.apply({"params": p}, g, x, **kw) ** 2).sum()

        with jax.default_matmul_precision("highest"):
            y_seg = model.apply({"params": params}, g, x)
            y_blk = model.apply({"params": params}, g, x, block=bg)
            g_seg = jax.grad(loss)(params)
            g_blk = jax.grad(loss)(params, block=bg)
        np.testing.assert_allclose(np.asarray(y_blk), np.asarray(y_seg),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=type(model).__name__)
        jax.tree_util.tree_map(
            lambda va, vb: np.testing.assert_allclose(
                np.asarray(vb), np.asarray(va), rtol=5e-3, atol=5e-3),
            g_seg, g_blk)


def test_fit_full_graph_block_strategy_end_to_end():
    """On a blocky dataset, strategy='auto' reaches dense_block and the
    whole-stack GAT trains to separation (strategy='block' explicit too)."""
    from custom_op_benchmark_tpu.data.synthetic import (
        NodeClassificationDataset,
    )
    from custom_op_benchmark_tpu.ops.dispatch import resolve
    from custom_op_benchmark_tpu.train.loop import fit_full_graph

    rng = np.random.default_rng(0)
    g = clique_batch(24, 12)                  # 24 cliques of 12
    n, c = g.n_nodes, 4
    labels = (np.arange(n) // 12 % c).astype(np.int32)
    feats = (np.eye(c, dtype=np.float32)[labels] * 2.0
             + rng.normal(size=(n, c)).astype(np.float32) * 0.3)
    tr = rng.random(n) < 0.6
    va = ~tr
    ds = NodeClassificationDataset(
        graph=g, features=feats, labels=labels, train_mask=tr,
        val_mask=va, test_mask=np.zeros(n, bool), num_classes=c,
        name="cliques",
    )
    # auto reaches dense_block once past the small-graph cutoff
    assert resolve(clique_batch(512, 30), "auto") == "dense_block"
    m = GAT(hidden_dim=16, out_dim=c, num_layers=2, num_heads=2)
    _, metrics = fit_full_graph(m, ds, epochs=40, strategy="block")
    assert metrics["val_acc"] > 0.9, metrics


@pytest.mark.parametrize("model", [
    GAT(hidden_dim=8, out_dim=4, num_heads=2, num_layers=3, remat=True),
    GraphTransformer(dim=8, num_heads=2, num_layers=2, out_dim=4,
                     remat=True),
])
def test_remat_matches_plain_stack(tiny_ds, model):
    """remat=True (jax.checkpoint per layer) changes memory, not math:
    same params, same outputs and parameter gradients."""
    import dataclasses

    ds = tiny_ds
    x = jnp.asarray(ds.features)
    plain = dataclasses.replace(model, remat=False)
    params = model.init(jax.random.PRNGKey(0), ds.graph, x)["params"]
    params_plain = plain.init(jax.random.PRNGKey(0), ds.graph, x)["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, params,
                           params_plain)

    def loss(m):
        return lambda p: (m.apply({"params": p}, ds.graph, x) ** 2).sum()

    g_remat = jax.grad(loss(model))(params)
    g_plain = jax.grad(loss(plain))(params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5,
                                                atol=1e-6),
        g_remat, g_plain)


def test_models_hash_by_value_and_init_deterministically(tiny_ds):
    """The model is a jit-static field of TrainState: equal configs must
    hash equal, and init must be a pure function of the key."""
    x = jnp.asarray(tiny_ds.features)
    a, b = GCN(hidden_dim=8, out_dim=4), GCN(hidden_dim=8, out_dim=4)
    assert a == b and hash(a) == hash(b)
    p1 = a.init(jax.random.PRNGKey(3), tiny_ds.graph, x)["params"]
    p2 = b.init(jax.random.PRNGKey(3), tiny_ds.graph, x)["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, p1, p2)
    assert set(p1) == {"layer0", "layer1"}
    assert set(p1["layer0"]) == {"W", "b"}


def test_dropout_needs_a_key_and_varies_with_it(tiny_ds):
    ds = tiny_ds
    x = jnp.asarray(ds.features)
    model = GAT(hidden_dim=8, out_dim=4, num_heads=2, dropout_rate=0.5)
    params = model.init(jax.random.PRNGKey(0), ds.graph, x)["params"]
    with pytest.raises(ValueError, match="dropout"):
        model.apply({"params": params}, ds.graph, x, deterministic=False)

    def run(seed):
        return model.apply({"params": params}, ds.graph, x,
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(seed)})

    np.testing.assert_array_equal(run(1), run(1))
    assert float(jnp.abs(run(1) - run(2)).max()) > 0
    y_eval = model.apply({"params": params}, ds.graph, x)
    np.testing.assert_array_equal(
        y_eval, model.apply({"params": params}, ds.graph, x))
