"""Micro-bench on the card: ELL attention/GAT fwd+bwd on the 2M-edge
power-law graph.

    python scripts/bench_attn_bwd.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax
import jax.numpy as jnp
import numpy as np

from custom_op_benchmark_tpu.ops import (
    ell_attention,
    ell_dual,
    ell_edge_bias_attention,
    ell_gat_attention,
    ell_pack_weights,
)
from custom_op_benchmark_tpu.graph import random_graph
from custom_op_benchmark_tpu.utils.benchlib import bench_fn
from custom_op_benchmark_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    n, e, d = 131072, 2_000_000, 128
    g = random_graph(n, e, seed=0, power_law=True)
    se, de = ell_dual(g)
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    k = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))

    def bench(name, fn, *args):
        rec = bench_fn(fn, args, warmup=1, iters="auto", name=name,
                       edges=e)
        print(f"{name:36s} {rec.time_s * 1e3:9.2f} ms  "
              f"{rec.edges_per_s / 1e6:8.1f} Medges/s", flush=True)

    bench("attn_fwd", lambda q, k, v: ell_attention(de, se, q, k, v),
          q, k, v)
    bench("attn_bwd", jax.grad(
        lambda q, k, v: (ell_attention(de, se, q, k, v) ** 2).sum(),
        argnums=(0, 1, 2)), q, k, v)

    h, dh = 4, 32
    a_l = jnp.asarray(rng.normal(size=(h, dh)).astype(np.float32))
    a_r = jnp.asarray(rng.normal(size=(h, dh)).astype(np.float32))
    zf = jnp.asarray(rng.normal(size=(n, h, dh)).astype(np.float32))
    bench("gat_fwd",
          lambda a, b, z: ell_gat_attention(de, se, a, b, z), a_l, a_r, zf)
    bench("gat_bwd", jax.grad(
        lambda a, b, z: (ell_gat_attention(de, se, a, b, z) ** 2).sum(),
        argnums=(0, 1, 2)), a_l, a_r, zf)

    # Multihead fused attention.
    qm = zf
    bench("attn_mh_fwd",
          lambda q, k, v: ell_attention(de, se, q, k, v), qm, qm, qm)
    bench("attn_mh_bwd", jax.grad(
        lambda q, k, v: (ell_attention(de, se, q, k, v) ** 2).sum(),
        argnums=(0, 1, 2)), qm, qm, qm)

    # Edge-bias attention, raw and packed edge weights.
    be = jnp.asarray(rng.normal(size=(e, d)).astype(np.float32))
    bench("eb_fwd",
          lambda q, k, v, be: ell_edge_bias_attention(de, se, q, k, v,
                                                      be),
          q, k, v, be)
    bench("eb_bwd", jax.grad(
        lambda q, k, v, be: (
            ell_edge_bias_attention(de, se, q, k, v, be) ** 2).sum(),
        argnums=(0, 1, 2, 3)), q, k, v, be)
    w = ell_pack_weights(se, de, be)
    bench("eb_packed_fwd",
          lambda q, k, v, w: ell_edge_bias_attention(de, se, q, k, v,
                                                     w),
          q, k, v, w)
    bench("eb_packed_bwd", jax.grad(
        lambda q, k, v, w: (
            ell_edge_bias_attention(de, se, q, k, v, w) ** 2).sum(),
        argnums=(0, 1, 2, 3)), q, k, v, w)

    # Multihead edge-bias rows (round-3 verdict #1 — heads-batched
    # sweep at h=4·d_h=32, same e·d as the h=1 rows: the pair measures
    # the multihead tax directly; target ≤ ~1.3× of the h=1 grad).
    beh = jnp.asarray(rng.normal(size=(e, dh)).astype(np.float32))
    bench("eb_mh_fwd",
          lambda q, k, v, be: ell_edge_bias_attention(de, se, q, k, v,
                                                      be),
          zf, zf, zf, beh)
    bench("eb_mh_bwd", jax.grad(
        lambda q, k, v, be: (
            ell_edge_bias_attention(de, se, q, k, v, be) ** 2).sum(),
        argnums=(0, 1, 2, 3)), zf, zf, zf, beh)
    wh = ell_pack_weights(se, de, beh)
    bench("eb_mh_packed_fwd",
          lambda q, k, v, w: ell_edge_bias_attention(de, se, q, k, v,
                                                     w),
          zf, zf, zf, wh)
    bench("eb_mh_packed_bwd", jax.grad(
        lambda q, k, v, w: (
            ell_edge_bias_attention(de, se, q, k, v, w) ** 2).sum(),
        argnums=(0, 1, 2, 3)), zf, zf, zf, wh)

    # Same rows on the training ladder (fine bucket widths).
    se_t, de_t = ell_dual(g, profile="train")
    w_t = ell_pack_weights(se_t, de_t, be)
    bench("eb_bwd[train]", jax.grad(
        lambda q, k, v, be: (
            ell_edge_bias_attention(de_t, se_t, q, k, v, be) ** 2
        ).sum(), argnums=(0, 1, 2, 3)), q, k, v, be)
    bench("eb_packed_bwd[train]", jax.grad(
        lambda q, k, v, w: (
            ell_edge_bias_attention(de_t, se_t, q, k, v, w) ** 2
        ).sum(), argnums=(0, 1, 2, 3)), q, k, v, w_t)


if __name__ == "__main__":
    main()
