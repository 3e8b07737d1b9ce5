"""Arxiv-scale full-graph GAT epoch time on the card, and the halo plan's
1-device-mesh backward vs the single-device path.

    python scripts/bench_epoch.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from custom_op_benchmark_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def epoch_time():
    from custom_op_benchmark_tpu.data.synthetic import planted_partition
    from custom_op_benchmark_tpu.models import GAT
    from custom_op_benchmark_tpu.train.loop import (
        create_train_state,
        masked_cross_entropy,
    )
    from custom_op_benchmark_tpu.ops import ell_dual
    from custom_op_benchmark_tpu.utils.benchlib import bench_fn

    # ogbn-arxiv's shape: n=169,343, e≈2.5M, 128 feats, 40 classes.
    ds = planted_partition(num_classes=40, nodes_per_class=4234,
                           feat_dim=128, avg_degree=7, seed=0)
    g = ds.graph
    print(f"arxiv-like: n={g.n_nodes} e={g.n_edges}", flush=True)
    se, de = ell_dual(g, profile="train")
    y = jnp.asarray(ds.labels)
    mask = jnp.asarray(ds.train_mask)

    for name, dt in (("f32", None), ("bf16 mixed", jnp.bfloat16)):
        model = GAT(hidden_dim=128, out_dim=40, num_layers=3,
                    num_heads=4, dtype=dt)
        x = jnp.asarray(ds.features)
        if dt is not None:
            x = x.astype(dt)
        state = create_train_state(model, g, x, jax.random.PRNGKey(0),
                                   ell=(se, de))

        def train_step(params, opt_state, x, model=model, state=state):
            def loss_fn(p):
                logits = model.apply({"params": p}, g, x, ell=(se, de))
                return masked_cross_entropy(logits, y, mask)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            upd, opt_state = state.tx.update(grads, opt_state, params)
            import optax

            return optax.apply_updates(params, upd), opt_state, loss

        rec = bench_fn(
            lambda params, x: train_step(params, state.opt_state, x)[0],
            (state.params, x), warmup=1, iters=(2, 6),
            name=f"epoch_{name}", edges=g.n_edges,
        )
        print(f"arxiv GAT epoch [{name}] (fwd+bwd+adamw): "
              f"{rec.time_s:.3f} s", flush=True)


def transformer_epoch():
    """Masked graph-transformer full-graph epoch at the same arxiv-like
    scale — the reference's implied model (SURVEY §2.3: its clique graph
    IS a batched attention mask; NodeMulEdge carries the relative-
    position scores). Two rows: plain masked attention, and edge-bias
    attention with static (relative-position) edge features packed in
    both ELL layouts (PackedEdgeWeights — no per-call packing gathers).
    """
    import optax

    from custom_op_benchmark_tpu.data.synthetic import planted_partition
    from custom_op_benchmark_tpu.models import GraphTransformer
    from custom_op_benchmark_tpu.ops import ell_dual, ell_pack_weights
    from custom_op_benchmark_tpu.train.loop import (
        create_train_state,
        masked_cross_entropy,
    )
    from custom_op_benchmark_tpu.utils.benchlib import bench_fn

    ds = planted_partition(num_classes=40, nodes_per_class=4234,
                           feat_dim=128, avg_degree=7, seed=0)
    g = ds.graph
    print(f"arxiv-like: n={g.n_nodes} e={g.n_edges}", flush=True)
    se, de = ell_dual(g, profile="train")
    model = GraphTransformer(dim=128, num_heads=4, num_layers=3,
                             out_dim=40)
    # Edge-bias tiles at e=2.5M × 3 layers OOM without remat.
    model_eb = GraphTransformer(dim=128, num_heads=4, num_layers=3,
                                out_dim=40, remat=True)
    x = jnp.asarray(ds.features)
    y = jnp.asarray(ds.labels)
    mask = jnp.asarray(ds.train_mask)
    rng = np.random.default_rng(0)
    be = jnp.asarray(
        rng.normal(size=(g.n_edges, 32)).astype(np.float32) * 0.1)
    w = ell_pack_weights(se, de, be)

    for name, ef, mdl in (("plain", None, model),
                          ("edge-bias packed", w, model_eb)):
        state = create_train_state(mdl, g, x, jax.random.PRNGKey(0),
                                   ell=(se, de), edge_feat=ef)

        # Pass the packed weights as a jit ARGUMENT — closing over them
        # embeds ~1 GB of HLO constants in the executable.
        def train_step(params, x, ef, state=state, mdl=mdl):
            def loss_fn(p):
                logits = mdl.apply({"params": p}, g, x, ef,
                                   ell=(se, de))
                return masked_cross_entropy(logits, y, mask)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            upd, _ = state.tx.update(grads, state.opt_state, params)
            return optax.apply_updates(params, upd)

        rec = bench_fn(train_step, (state.params, x, ef), warmup=1,
                       iters=(2, 6), name=f"tx_epoch_{name}",
                       edges=g.n_edges)
        print(f"transformer epoch [{name}]: {rec.time_s:.3f} s",
              flush=True)


def halo_backward():
    from custom_op_benchmark_tpu.graph import random_graph
    from custom_op_benchmark_tpu.parallel import (
        halo_attention_ell,
        halo_ell,
        halo_graph,
        make_mesh,
    )
    from custom_op_benchmark_tpu.parallel.halo import shard_halo_nodes
    from custom_op_benchmark_tpu.utils.benchlib import bench_fn

    n, e, h, d = 131072, 2_000_000, 4, 32
    g = random_graph(n, e, seed=0, power_law=True)
    mesh = make_mesh((1,), ("edge",))
    hg = halo_graph(g, mesh)
    he = halo_ell(hg, mesh)
    rng = np.random.default_rng(0)
    q = shard_halo_nodes(hg, mesh,
                         rng.normal(size=(n, h, d)).astype(np.float32))

    rec = bench_fn(
        lambda q: halo_attention_ell(hg, he, mesh, q, q, q), (q,),
        warmup=1, iters=(2, 8), name="halo_fwd", edges=e)
    print(f"halo attention fwd (1-dev mesh):  {rec.time_s*1e3:9.2f} ms",
          flush=True)
    rec = bench_fn(
        jax.grad(lambda q: (halo_attention_ell(
            hg, he, mesh, q, q, q) ** 2).sum()), (q,),
        warmup=1, iters=(2, 6), name="halo_bwd", edges=e)
    print(f"halo attention bwd (1-dev mesh):  {rec.time_s*1e3:9.2f} ms "
          f"(single-chip gat_bwd for 2x bound: see bench_attn_bwd)",
          flush=True)


if __name__ == "__main__":
    epoch_time()
    halo_backward()
