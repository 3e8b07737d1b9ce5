"""Stage-by-stage bisection of the halo backward's residual P=1 overhead.

At P=1 the halo plan's gradient is slower than the single-device fused
op although its exchange and combine terms are small. This script times
the backward COMPUTATION alone (alphas precomputed via the forward
residual path, fixed cotangent) truncated after each stage:

  p1        dq + packed (alpha, dS) materialized (fenced)
  p1_hop    + the twin_pos_t gather (fenced both sides)
  p1_hop_p2 + dk||dv per transpose bucket (no landing)
  full      + halo/local landing gathers + reverse a2a + recv_pos sum

Deltas between stages locate the expensive term; p1..p2 can be compared
against the single-device per-pass times.

Run on the card: python scripts/exp_halo_bwd_bisect.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from custom_op_benchmark_tpu.graph import random_graph  # noqa: E402
from custom_op_benchmark_tpu.parallel import (  # noqa: E402
    halo_ell, halo_graph, make_mesh, shard_halo_nodes,
)
from custom_op_benchmark_tpu.parallel.halo import (  # noqa: E402
    _attn_ell_fwd_impl, _exchange_parts, _halo_return_packed,
)
from custom_op_benchmark_tpu.utils.benchlib import bench_fn  # noqa: E402
from custom_op_benchmark_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()


def build_bwd_stage(hg, he, mesh, d, stage, stack_kv=True):
    """The _halo_attn_ell_bwd body (h=1), truncated after ``stage``."""
    ax = hg.axis
    n_per = hg.n_per
    scale = 1.0 / np.sqrt(d)
    f32 = jnp.float32

    def f(send_idx, hub_idx, hub_pos, row_pos, rows_b, cols_b, rows_t_b,
          cols_t_b, twin_pos_t, row_pos_t, halo_pos_t, recv_pos, alphas,
          q, k, v, dy):
        q2 = q.reshape(n_per, d).astype(f32)
        k2 = k.reshape(n_per, d)
        v2 = v.reshape(n_per, d)
        dy2 = dy.reshape(n_per, d).astype(f32)
        kp, k_ext = _exchange_parts(hg, send_idx, k2, hub_idx)
        vp, v_ext = _exchange_parts(hg, send_idx, v2, hub_idx)
        qp = jnp.pad(q2, ((0, 1), (0, 0)))
        dyp = jnp.pad(dy2, ((0, 1), (0, 0)))

        def p1(r, c, alpha, kt, vt):
            kg2 = kt[c]
            vg2 = vt[c]
            dyr2 = dyp[r]
            dalpha = jnp.einsum("rd,rkd->rk", dyr2, vg2,
                                preferred_element_type=f32)
            agg = jnp.sum(alpha * dalpha, axis=1)
            dS = alpha * (dalpha - agg[:, None]) * scale
            dqp = jnp.einsum("rk,rkd->rd", dS, kg2,
                             preferred_element_type=f32)
            return dqp, jnp.stack([alpha, dS], axis=-1)

        dq_parts, packed_parts = [], []
        for rows, cols, al, n_bnd in zip(rows_b, cols_b, alphas,
                                         he.n_bnd):
            r_all, c_all, a_all = rows[0], cols[0], al[0]
            cut = r_all.shape[0] - n_bnd
            b_secs = []
            if cut > 0:
                dqp, pk = p1(r_all[:cut], c_all[:cut], a_all[:cut],
                             kp, vp)
                dq_parts.append(dqp)
                b_secs.append(pk)
            if n_bnd > 0:
                dqp, pk = p1(r_all[cut:], c_all[cut:], a_all[cut:],
                             k_ext, v_ext)
                dq_parts.append(dqp)
                b_secs.append(pk)
            packed_parts.append(
                jnp.concatenate(b_secs, axis=0).reshape(-1, 2))
        zero_dq = jnp.zeros((1, d), f32)
        dq = jnp.concatenate(dq_parts + [zero_dq], axis=0)[row_pos[0]]

        packed_flat = jnp.concatenate(
            packed_parts + [jnp.zeros((1, 2), f32)], axis=0)
        packed_flat = jax.lax.optimization_barrier(packed_flat)
        if stage == "p1":
            # packed_flat is behind the barrier, so it is materialized;
            # the scalar sum just ties it into the output.
            return dq + jnp.sum(packed_flat)

        both_t = [packed_flat[tp[0]] for tp in twin_pos_t]
        both_t = jax.lax.optimization_barrier(both_t)
        if stage == "p1_hop":
            acc = dq
            for bt in both_t:           # barriered => gather materialized
                acc = acc + jnp.sum(bt)
            return acc

        def p2(ct, bt):
            q_c2 = qp[ct]
            dy_c2 = dyp[ct]
            alpha_t = bt[..., 0]
            dS_t = bt[..., 1]
            dkp = jnp.einsum("rk,rkd->rd", dS_t, q_c2,
                             preferred_element_type=f32)
            dvp = jnp.einsum("rk,rkd->rd", alpha_t, dy_c2,
                             preferred_element_type=f32)
            if stack_kv:
                return jnp.concatenate([dkp, dvp], axis=-1)
            return dkp, dvp

        if stack_kv:
            halo_parts, all_parts = [], []
            for cols_t, bt_full, n_halo in zip(cols_t_b, both_t,
                                               he.n_halo_t):
                ct = cols_t[0]
                if n_halo > 0:
                    head = p2(ct[:n_halo], bt_full[:n_halo])
                    halo_parts.append(head)
                    all_parts.append(head)
                if ct.shape[0] - n_halo > 0:
                    all_parts.append(p2(ct[n_halo:], bt_full[n_halo:]))
            if stage == "p1_hop_p2":
                acc = dq
                for ap in all_parts:
                    acc = acc + jnp.sum(ap)
                return acc
            zero2 = jnp.zeros((1, 2 * d), f32)
            dkv_halo = jnp.concatenate(
                halo_parts + [zero2], axis=0)[halo_pos_t[0]]
            dkv_local = jnp.concatenate(
                all_parts + [zero2], axis=0)[row_pos_t[0][:n_per]]
            dkv = _halo_return_packed(hg, recv_pos[0], hub_pos,
                                      dkv_local, dkv_halo, 2 * d)
            return dq + dkv[:, :d] + dkv[:, d:]

        # stack_kv=False: single-chip-style separate dk/dv landings
        # (two width-d returns instead of one width-2d).
        halo_k, halo_v, all_k, all_v = [], [], [], []
        for cols_t, bt_full, n_halo in zip(cols_t_b, both_t,
                                           he.n_halo_t):
            ct = cols_t[0]
            if n_halo > 0:
                hk, hv = p2(ct[:n_halo], bt_full[:n_halo])
                halo_k.append(hk)
                halo_v.append(hv)
                all_k.append(hk)
                all_v.append(hv)
            if ct.shape[0] - n_halo > 0:
                lk, lv = p2(ct[n_halo:], bt_full[n_halo:])
                all_k.append(lk)
                all_v.append(lv)
        zero1 = jnp.zeros((1, d), f32)
        dk = _halo_return_packed(
            hg, recv_pos[0], hub_pos,
            jnp.concatenate(all_k + [zero1], axis=0)[row_pos_t[0][:n_per]],
            jnp.concatenate(halo_k + [zero1], axis=0)[halo_pos_t[0]], d)
        dv = _halo_return_packed(
            hg, recv_pos[0], hub_pos,
            jnp.concatenate(all_v + [zero1], axis=0)[row_pos_t[0][:n_per]],
            jnp.concatenate(halo_v + [zero1], axis=0)[halo_pos_t[0]], d)
        return dq + dk + dv

    ax_specs = P(ax)
    return jax.shard_map(
        f, mesh=mesh,
        in_specs=(ax_specs, ax_specs, ax_specs, ax_specs,
                  [ax_specs] * len(he.rows_b), [ax_specs] * len(he.cols_b),
                  [ax_specs] * len(he.rows_t_b),
                  [ax_specs] * len(he.cols_t_b),
                  [ax_specs] * len(he.twin_pos_t), ax_specs, ax_specs,
                  ax_specs, [ax_specs] * len(he.rows_b),
                  ax_specs, ax_specs, ax_specs, ax_specs),
        out_specs=ax_specs,
    )


def main():
    n, e, d = 131072, 2_000_000, 128
    g = random_graph(n, e, seed=0, power_law=True)
    mesh = make_mesh((1,), ("edge",), devices=jax.devices()[:1])
    hg = halo_graph(g, mesh)
    he = halo_ell(hg, mesh)
    rng = np.random.default_rng(0)
    q = shard_halo_nodes(hg, mesh,
                         rng.normal(size=(n, d)).astype(np.float32))
    dy = shard_halo_nodes(hg, mesh,
                          rng.normal(size=(n, d)).astype(np.float32))
    _, alphas = _attn_ell_fwd_impl(hg, he, mesh, q, q, q, want_res=True)
    alphas = [jax.block_until_ready(a) for a in alphas]

    rows = {}
    for stage, stack in [("p1", True), ("p1_hop", True),
                         ("p1_hop_p2", True), ("full", True),
                         ("full_separate_kv", False)]:
        fn = build_bwd_stage(hg, he, mesh, d,
                             "full" if stage == "full_separate_kv"
                             else stage, stack_kv=stack)
        rec = bench_fn(
            lambda a, q, dy: fn(
                hg.send_idx, hg.hub_idx, hg.hub_pos, he.row_pos,
                he.rows_b, he.cols_b, he.rows_t_b, he.cols_t_b,
                he.twin_pos_t, he.row_pos_t, he.halo_pos_t, he.recv_pos,
                a, q, q, q, dy),
            (list(alphas), q, dy), warmup=1, iters="auto",
            name=f"halo_bwd_{stage}", edges=e)
        rows[stage] = round(rec.time_s * 1e3, 2)
        print(f"halo_bwd[{stage:18s}] {rec.time_s * 1e3:9.2f} ms",
              flush=True)
    print(json.dumps({"halo_bwd_bisect_h1d128": rows}))


if __name__ == "__main__":
    main()
