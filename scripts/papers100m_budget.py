"""papers100M per-shard device-memory feasibility budget (round-4
verdict #7).

Builds the REAL host-side halo plan (plan_stats: same numpy plan + both
shared-shape packings a P-mesh would get) on a papers100M-shaped
power-law synthetic, then feeds the measured plan numbers into
parallel/budget.shard_budget at full papers100M scale.

Scale protocol: the full plan (n=111M, e=1.6B) is hours of single-core
numpy; instead the plan is built at --scale (default 1/10: n=11.1M,
e=160M — the same builders scripts/bench_halo_builder.py runs at 100M
edges) and the SCALE-FREE ratios extracted:
  halo_frac   = (P·M + (P−1)·K) / n_per   (comm rows per owned row)
  slots_ratio = P·pack_slots / e          (padded slots per edge)
  interior    = interior row fraction
These are properties of the degree distribution + ordering + P, not of
absolute size (verified by printing them at two scales with --verify).
Full-scale n_per/halo/slots are then reconstructed from the ratios and
the true n=111,059,956, e=1,615,685,872, f=128.

Run (CPU, host-only — no devices touched by plan_stats; the fits
verdict uses the 80 GB H100 capacity unless a GPU reports its own):
  JAX_PLATFORMS=cpu python scripts/papers100m_budget.py
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PAPERS_N = 111_059_956
PAPERS_E = 1_615_685_872
PAPERS_F = 128


def plan_ratios(n, e, p, order="balanced"):
    import jax

    from custom_op_benchmark_tpu.graph import (
        degree_balanced_order, random_graph, reorder_graph,
    )
    from custom_op_benchmark_tpu.parallel.halo import plan_stats

    g = random_graph(n, e, seed=0, power_law=True)
    if order == "balanced":
        g, _ = reorder_graph(g, degree_balanced_order(g, p))
    n2 = g.n_nodes
    src = np.asarray(jax.device_get(g.src))[: g.n_edges]
    dst = np.asarray(jax.device_get(g.dst))[: g.n_edges]
    t0 = time.time()
    st = plan_stats(src, dst, n2, g.n_edges, p, -(-n2 // p),
                    g.num_edges_padded, hub_threshold="auto")
    dt = time.time() - t0
    return dict(
        plan_seconds=round(dt, 1), n=n2, e=int(g.n_edges), p=p,
        halo_frac=round(st.halo_fraction, 4),
        slots_ratio=round(st.pack_slots * p / g.n_edges, 4),
        interior_frac=st.interior_frac,
        n_hub=st.n_hub,
        hub_frac=round(st.n_hub / max(st.n_per, 1), 6),
    )


def full_scale_stats(r, p):
    """Reconstruct a PlanStats-shaped object at papers100M size from
    the measured scale-free ratios."""
    from custom_op_benchmark_tpu.parallel.halo import PlanStats

    n_per = -(-PAPERS_N // p)
    n_hub = int(r["hub_frac"] * n_per)
    # halo_frac = (P·M + (P−1)·K)/n_per  →  M
    m = max(int((r["halo_frac"] * n_per - (p - 1) * n_hub) / p), 0)
    return PlanStats(
        num_parts=p, n_per=n_per, halo=m, n_hub=n_hub,
        edges_per_part=-(-PAPERS_E // p),
        pack_slots=int(r["slots_ratio"] * PAPERS_E / p),
        interior_frac=r["interior_frac"],
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--device-counts", type=int, nargs="+",
                    default=[16, 64])
    ap.add_argument("--verify", action="store_true",
                    help="also build the plan at half the scale and "
                         "print both ratio sets (scale-stability check)")
    ap.add_argument("--out", default="chiprun_out/papers100m_budget.json")
    args = ap.parse_args()

    from custom_op_benchmark_tpu.parallel.budget import budget_table

    ratios, st_by_p = {}, {}
    for p in args.device_counts:
        scales = [args.scale] + ([args.scale / 2] if args.verify else [])
        per_scale = []
        for s in scales:
            r = plan_ratios(int(PAPERS_N * s), int(PAPERS_E * s), p)
            per_scale.append(r)
            print(f"P={p} scale={s:.3f}: {json.dumps(r)}", flush=True)
        ratios[p] = per_scale
        st_by_p[p] = full_scale_stats(per_scale[0], p)

    # GAT at BASELINE config 5 shapes: 4 heads × 32 = hidden 128.
    rows = budget_table(st_by_p, feat_dim=PAPERS_F, heads=4,
                        head_dim=32, num_layers=2)
    for row in rows:
        print(json.dumps(row), flush=True)
    out = dict(
        _meta=dict(
            target="ogbn-papers100M (BASELINE config 5)",
            full_n=PAPERS_N, full_e=PAPERS_E, feat_dim=PAPERS_F,
            method="plan_stats ratios at --scale synthetic, "
                   "reconstructed at full scale (scale-free: see "
                   "--verify rows)",
            scale=args.scale,
        ),
        ratios=ratios,
        budget=rows,
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
