#!/usr/bin/env python
"""Tiled strategy on the card: each Pallas kernel vs its plain-XLA form,
and the tiled ops vs ELL, on the 1024x1024 grid at d=128 (f32, default
matmul precision). The plain forms live here as the baselines the
kernels have to beat; ops/tiled.py keeps the faster of each pair.

    python scripts/bench_tiled.py [--only RE] [--budget S]

Rows (each timed with ``utils.benchlib.bench_fn``, warmed):

- ``block/<name>/{kernel,plain}``: the building block alone (forward);
- ``grad/<op>/<name>={kernel,plain}``: the forward+grad of the op whose
  forward the block is, under the library's custom_vjp rules;
- ``op/<op>/{fwd,grad}/{tiled,ell}``: whole ops, tiled and ELL.

Prints the card's name and power limit first; writes all rows to
``chiprun_out/bench_tiled.json`` as they come.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from custom_op_benchmark_tpu.graph import grid_graph  # noqa: E402
from custom_op_benchmark_tpu.graph.reorder import (  # noqa: E402
    reorder_graph,
    tile_aligned_order,
)
from custom_op_benchmark_tpu.graph.tiled import tile_graph  # noqa: E402
from custom_op_benchmark_tpu.ops import ell  # noqa: E402
from custom_op_benchmark_tpu.ops import tiled  # noqa: E402
from custom_op_benchmark_tpu.utils.benchlib import bench_fn  # noqa: E402
from custom_op_benchmark_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

GRID, D = 1024, 128


# Plain-XLA forms of the blocks that run as Pallas kernels in ops/tiled.py
# (a tile gather, a batched einsum with f32 accumulation, a segment sum):
# the baselines each kernel has to beat. The column sweep is plain XLA in
# the library itself.
def plain_sddmm(meta, mask, A, B):
    rows, cols = meta[0], meta[1]
    _, r, c = mask.shape
    s = jnp.einsum("trd,tcd->trc", tiled._tiles_of(A, r, rows),
                   tiled._tiles_of(B, c, cols),
                   preferred_element_type=jnp.float32)
    return jnp.where(mask, s, 0.0).astype(A.dtype)


def plain_row_sweep(meta, vals, x):
    rows, cols, ptr = meta[0], meta[1], meta[2]
    _, r, c = vals.shape
    nrb = ptr.shape[0] - 1
    part = jnp.einsum("trc,tcd->trd", vals, tiled._tiles_of(x, c, cols),
                      preferred_element_type=jnp.float32)
    y = jax.ops.segment_sum(part, rows, nrb, indices_are_sorted=True)
    return y.reshape(nrb * r, -1).astype(x.dtype)


def plain_attention(meta, mask, q, k, v, scale):
    alpha = tiled._row_softmax(meta, mask,
                               plain_sddmm(meta, mask, q, k) * scale)
    return plain_row_sweep(meta, alpha, v)


# The same custom_vjp rules as ops/tiled.py, with the plain forward.
@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def plain_fused_attn(meta, mask, qkv, scale):
    return plain_attention(meta, mask, *qkv, scale)


plain_fused_attn.defvjp(
    lambda meta, mask, qkv, scale: (
        plain_fused_attn(meta, mask, qkv, scale), (meta, mask, qkv)),
    tiled._fused_attn_bwd)


@jax.custom_vjp
def plain_spmm(meta, mask, vals, x):
    return plain_row_sweep(meta, vals, x)


plain_spmm.defvjp(
    lambda meta, mask, vals, x: (plain_spmm(meta, mask, vals, x),
                                 (meta, mask, vals, x)),
    tiled._spmm_t_bwd)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="regular expression: time only the rows whose "
                         "name it matches")
    ap.add_argument("--budget", type=float, default=1e9,
                    help="start no new measurement after this many "
                         "seconds")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        sys.exit("bench_tiled: needs a GPU")
    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    g = grid_graph(GRID, GRID)
    g2, _ = reorder_graph(g, tile_aligned_order(g, block=128))
    tg = tile_graph(g2, 128, 128)
    se, de = ell.ell_dual(g2)
    n, d, e = g2.n_nodes, D, g2.n_edges
    print(f"grid {GRID}^2: n={n} e={e} tiles={tg.num_tiles} "
          f"density={tg.density:.4f} d={d}", flush=True)
    meta, mask = tiled._meta(tg), tg.mask
    keys = jax.random.split(jax.random.PRNGKey(0), 7)
    A, B, V = (jax.random.normal(k, (n, d)) for k in keys[:3])
    ed = jax.random.uniform(keys[3], (g2.num_edges_padded,))
    vals = jax.jit(lambda w: tg.scatter_edges(w)[: tg.num_tiles])(ed)
    ct_n = jax.random.normal(keys[4], (n, d))
    ct_t = jax.random.normal(keys[5], vals.shape)
    ct_e = jax.random.normal(keys[6], (g2.num_edges_padded,))
    scale = 1.0 / np.sqrt(d)
    rows_out = []

    def emit(name, rec=None, **extra):
        row = dict(name=name, **extra)
        if rec is not None:
            row.update(ms=rec.time_s * 1e3, times_ms=[t * 1e3 for t in
                                                      rec.times])
        rows_out.append(row)
        print(json.dumps(row), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open("chiprun_out/bench_tiled.json", "w") as f:
            json.dump(dict(card=smi, rows=rows_out), f, indent=1)

    # Every array enters the timed functions as an argument: closed-over
    # device arrays would be embedded in the executables as constants.
    T = (meta, mask)
    t_start = time.perf_counter()
    only = re.compile(args.only)

    def bench(name, fn, xs):
        if not only.search(name):
            return
        if time.perf_counter() - t_start > args.budget:
            emit(name, skipped="time budget spent")
            return
        try:
            rec = bench_fn(fn, xs, iters=(2, 10), repeats=3, name=name)
            emit(name, rec)
        except Exception as ex:   # record and go on: one OOM is a finding
            emit(name, error=f"{type(ex).__name__}: {str(ex)[:300]}")

    def with_grad(f):
        def run(t, *xs):
            *xs, ct = xs
            y, vjp = jax.vjp(lambda *a: f(t, *a), *xs)
            return y, vjp(ct)
        return run

    spmm = {"kernel": lambda t, v, x: tiled._spmm_t(*t, v, x),
            "plain": lambda t, v, x: plain_spmm(*t, v, x)}
    attn = {"kernel": lambda t, q, k, v: tiled._fused_attn(
                *t, (q, k, v), float(scale)),
            "plain": lambda t, q, k, v: plain_fused_attn(
                *t, (q, k, v), float(scale))}
    blocks = {
        "sddmm": {"kernel": lambda t, a, b: tiled._sddmm_tiles(*t, a, b),
                  "plain": lambda t, a, b: plain_sddmm(*t, a, b)},
        "rows": {"kernel": lambda t, v, x: tiled._row_sweep(t[0], v, x),
                 "plain": lambda t, v, x: plain_row_sweep(t[0], v, x)},
        "attention": {"kernel": lambda t, q, k, v: tiled._attention_rows(
                          *t, q, k, v, scale),
                      "plain": lambda t, q, k, v: plain_attention(
                          *t, q, k, v, scale)},
    }
    block_args = {"sddmm": (T, A, B), "rows": (T, vals, V),
                  "attention": (T, A, B, V)}
    for name, forms in blocks.items():
        for tag, fn in forms.items():
            bench(f"block/{name}/{tag}", fn, block_args[name])
    bench("block/cols/plain", lambda t, v, y: tiled._col_sweep(t[0], v, y),
          (T, vals, A))
    for tag in ("kernel", "plain"):
        bench(f"grad/spmm/rows={tag}", with_grad(spmm[tag]),
              (T, vals, V, ct_n))
        bench(f"grad/attention/attention={tag}", with_grad(attn[tag]),
              (T, A, B, V, ct_n))
    bench("op/sddmm/grad/tiled",
          with_grad(lambda t, a, b: tiled._sddmm_t(*t, a, b)),
          (T, A, B, ct_t))

    # The ELL strategy on the same graph.
    E = (se, de)

    def ell_attn(el, q, k, v):
        return ell.ell_attention(el[1], el[0], q, k, v, scale=scale)

    def ell_spmm(el, w, x):
        return ell.ell_spmm(*el, w, x)[: x.shape[0]]

    def ell_sddmm(el, a, b):
        return ell.ell_sddmm(*el, a, b)

    bench("op/spmm/fwd/ell", ell_spmm, (E, ed, V))
    bench("op/spmm/grad/ell", with_grad(ell_spmm), (E, ed, V, ct_n))
    bench("op/sddmm/fwd/ell", ell_sddmm, (E, A, B))
    bench("op/sddmm/grad/ell", with_grad(ell_sddmm), (E, A, B, ct_e))
    bench("op/attention/fwd/ell", ell_attn, (E, A, B, V))
    bench("op/attention/grad/ell", with_grad(ell_attn), (E, A, B, V, ct_n))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)


if __name__ == "__main__":
    main()
