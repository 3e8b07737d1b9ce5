"""Verify user story: public-API ops + grads + dispatch + training.

Step 1 of .claude/skills/verify/SKILL.md, extended with the impl=
dispatch and packed-weight SpMM.

    python scripts/verify_story.py
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


def main():
    from custom_op_benchmark_tpu.graph import block_graph, clique_batch
    from custom_op_benchmark_tpu.ops import (
        block_attention,
        dispatch,
        edge_softmax,
        ell_dual,
        ell_pack_weights,
        ell_spmm,
        sddmm,
        vector_spmm,
    )

    g = clique_batch(32, 30)
    n, d = g.n_nodes, 64
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    k = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))

    with jax.default_matmul_precision("highest"):
        def attn(q, k, v):
            s = sddmm(g, k, q) / jnp.sqrt(float(d))
            a = edge_softmax(g, s, by="dst")
            a = jnp.where(g.edge_mask, a, 0.0)
            return vector_spmm(g.reverse(), a[g.csc_perm], v)

        y = jax.jit(attn)(q, k, v)
        grads = jax.jit(jax.grad(
            lambda q, k, v: (attn(q, k, v) ** 2).sum(), argnums=(0, 1, 2)
        ))(q, k, v)
        assert all(bool(jnp.isfinite(t).all()) for t in grads)

        bg = block_graph(g)
        yb = bg.gather_nodes(jax.jit(lambda q, k, v: block_attention(
            bg, bg.scatter_nodes(q), bg.scatter_nodes(k),
            bg.scatter_nodes(v), normalize="dst"))(q, k, v))
        np.testing.assert_allclose(np.asarray(y), np.asarray(yb),
                                   rtol=2e-3, atol=2e-3)
        print("composed attention + grads vs dense_block: OK")

        # Round-2: public dispatch. auto on this graph → dense_block.
        assert dispatch.resolve(g, "auto") == "dense_block", \
            dispatch.resolve(g, "auto")
        ed = jnp.asarray(
            rng.uniform(size=g.num_edges_padded).astype(np.float32))
        y_auto = jax.jit(
            lambda ed, x: vector_spmm(g, ed, x, impl="auto"))(ed, q)
        y_xla = jax.jit(
            lambda ed, x: vector_spmm(g, ed, x, impl="xla"))(ed, q)
        np.testing.assert_allclose(np.asarray(y_auto), np.asarray(y_xla),
                                   rtol=2e-3, atol=2e-3)
        jaxpr = jax.make_jaxpr(
            lambda a, b: sddmm(g, a, b, impl="pallas"))(q, k)
        assert "pallas_call" in str(jaxpr)
        print("impl=auto → dense_block, impl=pallas → pallas_call: OK")

        # Round-2: packed-weight SpMM matches canonical weights.
        se, de = ell_dual(g)
        w = ell_pack_weights(se, de, ed)
        yp = jax.jit(lambda w, x: ell_spmm(se, de, w, x))(w, q)
        np.testing.assert_allclose(np.asarray(yp), np.asarray(y_xla)[: n],
                                   rtol=2e-3, atol=2e-3)
        print("packed-weight ELL SpMM vs oracle: OK")

    # Training end-to-end.
    from custom_op_benchmark_tpu.data.synthetic import planted_partition
    from custom_op_benchmark_tpu.models import GAT
    from custom_op_benchmark_tpu.train.loop import fit_full_graph

    data = planted_partition(num_classes=4, nodes_per_class=200, seed=0)
    model = GAT(hidden_dim=32, out_dim=4, num_heads=2, num_layers=2)
    state, metrics = fit_full_graph(model, data, epochs=30, seed=0)
    acc = metrics["val_acc"]
    assert acc > 0.75, f"val_acc {acc}"
    print(f"GAT training val_acc={acc:.3f}: OK")


if __name__ == "__main__":
    main()
