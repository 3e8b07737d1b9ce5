"""Distributed graph-transformer train step on the 1-device mesh.

The full train step (3 layers, h=4 d=32, adam) at the 2M-edge power-law
scale: halo attention + node-local matmuls, timed with bench_fn slope
timing, the plan built exactly as fit_edge_partitioned(plan="halo",
arch="transformer") does, hub_threshold="auto".

    python scripts/bench_dist_transformer.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from custom_op_benchmark_tpu.graph import random_graph
from custom_op_benchmark_tpu.parallel import make_mesh
from custom_op_benchmark_tpu.parallel.halo import (
    halo_ell, halo_graph, shard_halo_nodes,
)
from custom_op_benchmark_tpu.parallel.train_dist import (
    dist_transformer_forward, init_dist_transformer,
)
from custom_op_benchmark_tpu.utils.benchlib import bench_fn  # noqa: E402
from custom_op_benchmark_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    n, e, feat_dim, classes = 131072, 2_000_000, 128, 16
    heads, dim, layers = 4, 128, 3   # head_dim 32
    g = random_graph(n, e, seed=0, power_law=True)
    mesh = make_mesh((1,), ("edge",), devices=jax.devices()[:1])
    hgr = halo_graph(g, mesh, hub_threshold="auto")
    dg = (hgr, halo_ell(hgr, mesh))
    rng = np.random.default_rng(0)
    x = shard_halo_nodes(
        hgr, mesh, rng.normal(size=(n, feat_dim)).astype(np.float32))
    labels = shard_halo_nodes(
        hgr, mesh, rng.integers(0, classes, size=n).astype(np.int32))
    mask = shard_halo_nodes(hgr, mesh, np.ones(n, np.float32))

    params = init_dist_transformer(
        jax.random.PRNGKey(0), feat_dim, dim, classes, heads, layers)
    nh, hd = params.pop("num_heads"), params.pop("head_dim")

    def with_static(p):
        return {**p, "num_heads": nh, "head_dim": hd}

    def loss_fn(p, x_, labels_, mask_):
        logits = dist_transformer_forward(dg, mesh, with_static(p), x_)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(
            logp, labels_[:, None].astype(jnp.int32), axis=-1)[:, 0]
        return (nll * mask_).sum() / jnp.maximum(mask_.sum(), 1.0)

    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    def train_step(p, opt_state, x_, labels_, mask_):
        loss, grads = jax.value_and_grad(loss_fn)(p, x_, labels_, mask_)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    rec = bench_fn(train_step, (params, opt_state, x, labels, mask),
                   warmup=1, iters="auto", name="dist_transformer_step",
                   edges=e)
    print(json.dumps({"dist_transformer_step": dict(
        n=n, e=e, layers=layers, heads=heads, dim=dim,
        time_ms=round(rec.time_s * 1e3, 1),
        edges_per_s=round(e * layers / rec.time_s, 1),
        round3_ms=438.0,
    )}))


if __name__ == "__main__":
    main()
