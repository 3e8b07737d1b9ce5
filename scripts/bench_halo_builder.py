"""Cold-path scale probe: halo plan + halo-ELL pack time at P=64 on a
100M+-edge synthetic (round-2 verdict #8 — the round-2 builder looped
shards per bucket and shard-pairs for recv_pos; this measures the
vectorized rewrite at the papers100M-config scale class).

Graph: clustered locality (90% of edges within the owner's node range —
the post-cluster_order regime the production path runs in), plus a 10%
uniform remote tail that exercises the halo machinery.

Run (CPU, 64 fake devices):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=64 \
  python scripts/bench_halo_builder.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np


def main():
    import jax

    from custom_op_benchmark_tpu.graph.graph import from_coo
    from custom_op_benchmark_tpu.parallel import (
        halo_ell,
        halo_graph,
        make_mesh,
    )

    p = int(os.environ.get("HB_P", 64))
    n = int(os.environ.get("HB_N", 1 << 23))          # 8.39M nodes
    e = int(os.environ.get("HB_E", 100_000_000))
    local_frac = 0.9
    rng = np.random.default_rng(0)

    t0 = time.time()
    n_per = -(-n // p)
    dst = rng.integers(0, n, size=e)
    owner = dst // n_per
    local = rng.random(e) < local_frac
    src = np.where(
        local,
        owner * n_per + rng.integers(0, n_per, size=e),
        rng.integers(0, n, size=e),
    )
    np.minimum(src, n - 1, out=src)
    t_gen = time.time() - t0
    print(f"edge gen: {t_gen:.1f}s", flush=True)

    t0 = time.time()
    g = from_coo(src, dst, n_nodes=n)
    t_coo = time.time() - t0
    print(f"from_coo (dual CSR): {t_coo:.1f}s", flush=True)

    mesh = make_mesh((p,), ("edge",))
    t0 = time.time()
    hg = halo_graph(g, mesh)
    t_hg = time.time() - t0
    print(f"halo_graph: {t_hg:.1f}s  M={hg.halo} "
          f"halo_frac={hg.halo_fraction:.3f}", flush=True)

    t0 = time.time()
    he = halo_ell(hg, mesh)
    t_he = time.time() - t0
    total = sum(int(np.asarray(jax.device_get(r)).shape[1])
                for r in he.rows_b)
    print(f"halo_ell: {t_he:.1f}s  buckets={len(he.widths)} "
          f"bnd_rows={sum(he.n_bnd)}/{total} "
          f"halo_rows_t={he.halo_rows_t}", flush=True)
    print(json.dumps(dict(
        p=p, n=n, e=e, gen_s=round(t_gen, 1), from_coo_s=round(t_coo, 1),
        halo_graph_s=round(t_hg, 1), halo_ell_s=round(t_he, 1),
        halo=int(hg.halo), halo_fraction=round(hg.halo_fraction, 4),
        interior_row_frac=round(1 - sum(he.n_bnd) / max(total, 1), 4),
    )), flush=True)


if __name__ == "__main__":
    main()
