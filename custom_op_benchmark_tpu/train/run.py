"""CLI entry points for the BASELINE.json end-to-end configs.

    python -m custom_op_benchmark_tpu.train.run --config <name> [--scale S]

Configs (BASELINE.json `configs`; datasets are synthetic stand-ins at the
named scales — this environment has no network egress, see
data/synthetic.py — with real loaders pluggable via ``from_numpy_files``):

  cora_gat            — single-layer GAT, full graph, with the per-layer
                        allclose validation vs a dense masked-attention
                        oracle (config 1: "CPU reference vs graphop
                        allclose").
  arxiv_gat           — 3-layer GAT, full-graph training, single chip.
  reddit_sage         — GraphSAGE, neighbor sampling fanout 25/10,
                        host-overlap minibatch pipeline.
  products_gat_dist   — edge-partitioned distributed GAT over all local
                        devices (one host).
  papers100m_gat_dist — the same path at the multi-host layout; validated
                        here on a fake N-device CPU mesh
                        (xla_force_host_platform_device_count), the
                        standard JAX multi-host dry-run.

Each run prints one JSON line with the config, dataset size, and final
metrics. ``--scale`` shrinks node counts for smoke runs; ``--log-every N``
adds per-epoch loss and accuracy every N epochs to the full-graph
configs' ``history``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _ds(num_classes, nodes_per_class, feat_dim, scale, **kw):
    from custom_op_benchmark_tpu.data.synthetic import planted_partition

    return planted_partition(
        num_classes=num_classes,
        nodes_per_class=max(8, int(nodes_per_class * scale)),
        feat_dim=feat_dim,
        **kw,
    )


def _load(path):
    """Real on-disk dataset (OGB dir / canonical .npz / Planetoid .npz)."""
    from custom_op_benchmark_tpu.data.datasets import load_dataset

    return load_dataset(path)


def run_cora_gat(scale, epochs, data=None, log_every=0):
    import jax
    import jax.numpy as jnp

    from custom_op_benchmark_tpu.models import GAT
    from custom_op_benchmark_tpu.ops import (
        edge_softmax, sddmm, vector_spmm,
    )
    from custom_op_benchmark_tpu.train import fit_full_graph

    ds = _load(data) if data else _ds(
        7, 387, 1433 if scale >= 1 else 64, scale, name="cora-like")
    g = ds.graph

    # Config-1 validation: one attention layer, segment path vs dense
    # masked oracle, forward AND grads (reference discipline,
    # wrapper.py:174-209).
    n, d = g.n_nodes, 16
    q = jax.random.normal(jax.random.PRNGKey(0), (n, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (n, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (n, d))
    adj = np.zeros((n, n), bool)
    adj[np.asarray(g.src)[: g.n_edges], np.asarray(g.dst)[: g.n_edges]] = 1
    adj = jnp.asarray(adj)

    def layer_seg(q, k, v):
        s = sddmm(g, q, k) / jnp.sqrt(float(d))
        a = edge_softmax(g, s, by="src")
        return (vector_spmm(g, a, v) ** 2).sum()

    def layer_dense(q, k, v):
        s = (q @ k.T) / jnp.sqrt(float(d))
        s = jnp.where(adj, s, -1e30)
        a = jnp.where(adj, jax.nn.softmax(s, -1), 0)
        return ((a @ v) ** 2).sum()

    with jax.default_matmul_precision("highest"):
        ok = bool(np.isclose(float(layer_seg(q, k, v)),
                             float(layer_dense(q, k, v)), rtol=1e-3))
        gs = jax.grad(layer_seg, argnums=(0, 1, 2))(q, k, v)
        gd = jax.grad(layer_dense, argnums=(0, 1, 2))(q, k, v)
        for a, b in zip(gs, gd):
            ok &= bool(np.allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-4))

    model = GAT(hidden_dim=64, out_dim=ds.num_classes, num_layers=2,
                num_heads=8)
    _, metrics = fit_full_graph(model, ds, epochs=epochs,
                                learning_rate=5e-3, log_every=log_every)
    return dict(layer_allclose_ok=ok, **metrics)


def run_arxiv_gat(scale, epochs, data=None, log_every=0):
    from custom_op_benchmark_tpu.models import GAT
    from custom_op_benchmark_tpu.train import fit_full_graph

    ds = _load(data) if data else _ds(
        40, 4000, 128, scale, avg_degree=13, name="arxiv-like")
    model = GAT(hidden_dim=128, out_dim=ds.num_classes, num_layers=3,
                num_heads=4)
    # Fused degree-bucketed attention (ops/ell.py) — the general-graph
    # fast path.
    _, metrics = fit_full_graph(model, ds, epochs=epochs,
                                learning_rate=2e-3, strategy="ell",
                                log_every=log_every)
    return metrics


def run_arxiv_transformer(scale, epochs, data=None, log_every=0):
    """Beyond-BASELINE config: the masked graph transformer (the model
    the reference's clique workload implies — SURVEY §2.3) trained
    full-graph on the arxiv-like dataset via the fused ELL attention."""
    from custom_op_benchmark_tpu.models import GraphTransformer
    from custom_op_benchmark_tpu.train import fit_full_graph

    ds = _load(data) if data else _ds(
        40, 4000, 128, scale, avg_degree=13, name="arxiv-like")
    model = GraphTransformer(dim=128, num_heads=4, num_layers=3,
                             out_dim=ds.num_classes)
    _, metrics = fit_full_graph(model, ds, epochs=epochs,
                                learning_rate=1e-3, strategy="ell",
                                log_every=log_every)
    return metrics


def run_reddit_sage(scale, epochs, data=None, log_every=0):
    from custom_op_benchmark_tpu.models import GraphSAGE
    from custom_op_benchmark_tpu.train import fit_sampled

    ds = _load(data) if data else _ds(
        41, 5700, 300 if scale >= 1 else 64, scale,
        avg_degree=50 if scale >= 1 else 15, name="reddit-like")
    model = GraphSAGE(hidden_dim=128, out_dim=ds.num_classes, num_layers=2)
    _, metrics = fit_sampled(model, ds, fanouts=(25, 10),
                             batch_size=256, epochs=epochs,
                             learning_rate=1e-3)
    metrics.pop("losses", None)
    return metrics


def _dist(scale, epochs, want_devices, data=None, arch="gat"):
    import jax

    from custom_op_benchmark_tpu.parallel import (
        fit_edge_partitioned, make_mesh,
    )

    n_dev = min(want_devices, len(jax.devices()))
    mesh = make_mesh((n_dev,), ("edge",))
    ds = _load(data) if data else _ds(
        47, 5200, 100 if scale >= 1 else 32, scale,
        avg_degree=20, name="products-like")
    _, metrics = fit_edge_partitioned(ds, mesh, hidden=64, num_heads=4,
                                      num_layers=2, epochs=epochs,
                                      arch=arch)
    return metrics


def run_products_gat_dist(scale, epochs, data=None, log_every=0):
    return _dist(scale, epochs, want_devices=8, data=data)


def run_products_transformer_dist(scale, epochs, data=None,
                                  log_every=0):
    """Beyond-BASELINE: the distributed graph transformer
    (fit_edge_partitioned arch='transformer') on the products config."""
    return _dist(scale, epochs, want_devices=8, data=data,
                 arch="transformer")


def run_papers100m_gat_dist(scale, epochs, data=None, log_every=0):
    # Multi-host layout: ≥2 "hosts" = ≥2 mesh parts; on one machine this
    # exercises the identical shard_map program over a fake device mesh.
    return _dist(scale, epochs, want_devices=16, data=data)


CONFIGS = {
    "cora_gat": (run_cora_gat, 100),
    "arxiv_gat": (run_arxiv_gat, 60),
    "arxiv_transformer": (run_arxiv_transformer, 40),
    "reddit_sage": (run_reddit_sage, 2),
    "products_gat_dist": (run_products_gat_dist, 30),
    "products_transformer_dist": (run_products_transformer_dist, 30),
    "papers100m_gat_dist": (run_papers100m_gat_dist, 10),
}


def main(argv=None):
    from custom_op_benchmark_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, choices=sorted(CONFIGS))
    ap.add_argument("--scale", type=float, default=1.0,
                    help="dataset size multiplier (use <1 for smoke runs)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=0,
                    help="record loss/accuracy every N epochs "
                         "(full-graph configs)")
    ap.add_argument("--data", type=str, default=None,
                    help="path to a real dataset (OGB directory, "
                         "canonical .npz, or Planetoid-style .npz); "
                         "omits the synthetic stand-in")
    args = ap.parse_args(argv)
    fn, default_epochs = CONFIGS[args.config]
    metrics = fn(args.scale, args.epochs or default_epochs,
                 data=args.data, log_every=args.log_every)
    print(json.dumps({"config": args.config, "scale": args.scale,
                      "data": args.data, **metrics}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
