"""Model-level strategy benchmarks on the card, on the reference clique
workload (512×30 cliques — n=15,360, e=460,800): the GraphTransformer's
whole-stack block layout vs per-layer scatter/gather, and GAT on the
segment, fused ELL and dense-block strategies (forward and train step).

    python scripts/bench_models.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from custom_op_benchmark_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from custom_op_benchmark_tpu.graph import block_graph, clique_batch
from custom_op_benchmark_tpu.models import GAT, GraphTransformer
from custom_op_benchmark_tpu.ops import ell_dual
from custom_op_benchmark_tpu.train.loop import (
    create_train_state,
    masked_cross_entropy,
)
from custom_op_benchmark_tpu.utils.benchlib import bench_fn


def _bench_model(name, model, g, x, y, mask, kw):
    state = create_train_state(model, g, x, jax.random.PRNGKey(0), **kw)

    def fwd(params, x):
        return model.apply({"params": params}, g, x, **kw)

    def step(params, x):
        def loss_fn(p):
            logits = model.apply({"params": p}, g, x, **kw)
            return masked_cross_entropy(logits, y, mask)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, _ = state.tx.update(grads, state.opt_state, params)
        return optax.apply_updates(params, upd)

    r1 = bench_fn(fwd, (state.params, x), warmup=1, iters="auto",
                  name=f"fwd_{name}")
    r2 = bench_fn(step, (state.params, x), warmup=1, iters=(2, 6),
                  name=f"step_{name}")
    print(f"{name:42s} fwd {r1.time_s*1e3:8.3f} ms   "
          f"train step {r2.time_s*1e3:8.3f} ms", flush=True)
    return fwd(state.params, x)


def main():
    g = clique_batch(512, 30)
    bg = block_graph(g)
    se, de = ell_dual(g)
    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.integers(0, 10, size=g.n_nodes).astype(np.int32))
    mask = jnp.ones((g.n_nodes,), bool)

    x512 = jnp.asarray(rng.normal(size=(g.n_nodes, 512)).astype(np.float32))
    for whole in (False, True):
        model = GraphTransformer(dim=512, num_heads=8, num_layers=3,
                                 out_dim=10, block_whole_stack=whole)
        _bench_model(f"transformer/block whole_stack={whole}", model,
                     g, x512, y, mask, dict(block=bg))
    from custom_op_benchmark_tpu.graph.tiled import tile_graph

    tgv = tile_graph(g, 128, 128)
    _bench_model("transformer/tiled (Pallas)",
                 GraphTransformer(dim=512, num_heads=8, num_layers=3,
                                  out_dim=10),
                 g, x512, y, mask, dict(tiled=tgv))

    x128 = jnp.asarray(rng.normal(size=(g.n_nodes, 128)).astype(np.float32))
    gat = GAT(hidden_dim=64, out_dim=10, num_layers=3, num_heads=8)
    outs = {}
    for name, kw in (("gat/segment", {}), ("gat/ell", dict(ell=(se, de))),
                     ("gat/block", dict(block=bg))):
        outs[name] = _bench_model(name, gat, g, x128, y, mask, kw)
    err = float(jnp.max(jnp.abs(outs["gat/block"] - outs["gat/segment"])))
    print(f"gat block-vs-segment max err: {err:.2e}", flush=True)


if __name__ == "__main__":
    main()
