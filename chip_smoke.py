#!/usr/bin/env python
"""Smoke run of the whole system on one NVIDIA GPU, in one process.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # only the edge-partitioned phase

Phases (each prints its own ``phase ...`` line; any failure raises and
the script exits non-zero without printing a result):

1. device: platform, device kind and count, the card's name and power
   limit from ``nvidia-smi``, and whether the native host library
   (``libgraphcore.so``) or its numpy fallback is in use;
2. the op family at the reference's widths (512 cliques of 30 nodes;
   single-head d=1024 and 8 heads x 64) through every strategy each op
   supports, forward and gradient, against the ``ops/xla.py`` segment
   path; then ELL attention and GAT attention on a 2M-edge power-law
   graph at d=128, and the random row-gather rate on that graph;
3. the tiled Pallas kernels compiled for the card on the 1024x1024 grid
   at d=128, forward and gradient, against the segment path;
4. the full-width trainer (``train.run --config arxiv_gat``, 3 epochs)
   and the jitted ``__graft_entry__.entry()`` step;
5. one forward of phase 2 and one of phase 4 at default matmul
   precision (TF32 / the bf16 policy), with their own tolerance.

Phases 2-3 compare under ``jax.default_matmul_precision("highest")``:
forwards at rtol 1e-4, atol 1e-4*max|ref|; gradients at rtol 1e-3, atol
1e-3*max|ref| (the segment path's scatter-adds run as GPU atomics in no
fixed order, and gradients sum over more terms). Phase 5 allows 2e-2 of
max|ref|: a float32 matmul at default precision may run in TF32, which
keeps about three decimal digits.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np

HIGHEST = dict(fwd=(1e-4, 1e-4), grad=(1e-3, 1e-3))
DEFAULT_PRECISION_TOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name: str, got, ref, rtol: float, atol_frac: float) -> float:
    """Assert ``got ≈ ref`` (atol = atol_frac·max|ref|); returns the max
    error relative to max|ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: non-finite values")
    scale = max(float(np.max(np.abs(ref))), 1e-30) if ref.size else 1.0
    err = float(np.max(np.abs(got - ref))) / scale if ref.size else 0.0
    if not np.allclose(got, ref, rtol=rtol, atol=atol_frac * scale):
        raise AssertionError(
            f"{name}: max |got-ref|/max|ref| = {err:.3e} "
            f"(rtol {rtol}, atol {atol_frac}*max|ref|)")
    return err


class Tally:
    """Worst forward / gradient error of a phase, for its summary line."""

    def __init__(self):
        self.n = 0
        self.fwd = 0.0
        self.grad = 0.0

    def check(self, name, fn, ref_fn, inputs, edges=None, consts=()):
        """Forward and VJP of ``fn`` vs ``ref_fn`` on ``inputs``.
        ``edges=(e_pad, e)``: arrays over the padded edge list are compared
        on their ``e`` real edges only (padding is not in the contract).
        ``consts`` (graph views) are passed first to both functions as jit
        arguments, not embedded in the executables, and not
        differentiated."""
        import jax
        import jax.numpy as jnp

        def real(a):
            a = np.asarray(a)
            if edges is not None and a.shape[:1] == (edges[0],):
                return a[: edges[1]]
            return a

        def run(f):
            def go(consts, *xs):
                y, vjp = jax.vjp(lambda *xs: f(*consts, *xs), *xs)
                ct = jax.random.normal(jax.random.PRNGKey(7), y.shape,
                                       y.dtype)
                if edges is not None and y.shape[0] == edges[0]:
                    keep = (jnp.arange(y.shape[0]) < edges[1]).reshape(
                        (-1,) + (1,) * (y.ndim - 1))
                    ct = jnp.where(keep, ct, 0)
                return y, vjp(ct)
            return jax.jit(go)(consts, *inputs)

        t0 = time.perf_counter()
        y, grads = run(fn)
        y_ref, grads_ref = run(ref_fn)
        ef = compare(f"{name} fwd", real(y), real(y_ref), *HIGHEST["fwd"])
        eg = 0.0
        for i, (a, b) in enumerate(zip(grads, grads_ref)):
            eg = max(eg, compare(f"{name} grad[{i}]", real(a), real(b),
                                 *HIGHEST["grad"]))
        self.n += 1
        self.fwd, self.grad = max(self.fwd, ef), max(self.grad, eg)
        log(f"  {name:44s} fwd {ef:.2e}  grad {eg:.2e}  "
            f"({time.perf_counter() - t0:.1f} s)")

    def summary(self) -> str:
        f, g = HIGHEST["fwd"], HIGHEST["grad"]
        return (f"checks={self.n} max_err fwd={self.fwd:.3e} "
                f"grad={self.grad:.3e} tol fwd rtol={f[0]} "
                f"atol={f[1]}*max|ref| grad rtol={g[0]} "
                f"atol={g[1]}*max|ref| precision=highest")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    import jax

    from custom_op_benchmark_tpu.graph import native

    devs = jax.devices()
    log(f"platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    host = ("native libgraphcore.so" if native.available()
            else "numpy fallback (libgraphcore.so not loaded)")
    log(f"phase 1 device: ok host_graph_library={host}")


def op_family_suite(tally, g, heads, d, *, strategies):
    """Every public op under each strategy vs the segment path."""
    import jax
    import jax.numpy as jnp

    from custom_op_benchmark_tpu.ops import (
        attention,
        edge_softmax,
        gat_attention,
        node_mul_edge,
        sddmm,
        vector_spmm,
    )

    n, e_pad, e = g.n_nodes, g.num_edges_padded, g.n_edges
    shape = (n, d) if heads is None else (n, heads, d)
    eshape = (e_pad,) if heads is None else (e_pad, heads)
    h = heads or 1
    keys = iter(jax.random.split(jax.random.PRNGKey(0), 16))

    def rnd(shape_, scale=1.0):
        return jax.random.normal(next(keys), shape_, jnp.float32) * scale

    A, B, V = rnd(shape), rnd(shape), rnd(shape)
    ed, xe, be = rnd(eshape), rnd(eshape), rnd((e_pad, d))
    a_l, a_r = rnd((h, d), 0.1), rnd((h, d), 0.1)
    z = A if heads is not None else A[:, None, :]
    tag = f"h={heads or 1} d={d}"
    ops = [
        ("sddmm", lambda i: lambda a, b: sddmm(g, a, b, impl=i), (A, B)),
        ("edge_softmax src",
         lambda i: lambda x: edge_softmax(g, x, by="src", impl=i), (xe,)),
        ("edge_softmax dst",
         lambda i: lambda x: edge_softmax(g, x, by="dst", impl=i), (xe,)),
        ("vector_spmm",
         lambda i: lambda w, x: vector_spmm(g, w, x, impl=i), (ed, V)),
        ("node_mul_edge",
         lambda i: lambda a, b: node_mul_edge(g, a, b, impl=i), (A, be)),
        ("attention",
         lambda i: lambda q, k, v: attention(g, q, k, v, impl=i),
         (A, B, V)),
        ("gat_attention",
         lambda i: lambda al, ar, zz: gat_attention(g, al, ar, zz, impl=i),
         (a_l, a_r, z)),
    ]
    # node_mul_edge and gat_attention have no tiled form: the tiled
    # strategy routes them to ELL (ops/primitives.py), so it is not run
    # twice here.
    no_tiled = {"node_mul_edge", "gat_attention"}
    for name, make, inputs in ops:
        for strat in strategies:
            if strat == "tiled" and name in no_tiled:
                continue
            tally.check(f"{name} {strat} {tag}", make(strat), make("xla"),
                        inputs, edges=(e_pad, e))


def phase_op_family(clique=(512, 30), powerlaw=(131072, 2_000_000),
                    d_single=1024, heads=8, d_head=64, d_pl=128):
    import jax
    import jax.numpy as jnp

    from custom_op_benchmark_tpu.graph import clique_batch, random_graph
    from custom_op_benchmark_tpu.ops import (
        attention,
        ell_attention,
        ell_dual,
        ell_gat_attention,
        gat_attention,
    )
    from custom_op_benchmark_tpu.utils.benchlib import bench_fn

    tally = Tally()
    with jax.default_matmul_precision("highest"):
        g = clique_batch(*clique)
        log(f"  clique_batch{clique}: n={g.n_nodes} e={g.n_edges}")
        strategies = ("dense_block", "ell", "tiled")
        op_family_suite(tally, g, None, d_single, strategies=strategies)
        op_family_suite(tally, g, heads, d_head, strategies=strategies)

        gp = random_graph(*powerlaw, seed=0, power_law=True)
        n = gp.n_nodes
        log(f"  random_graph{powerlaw} power-law: n={n} e={gp.n_edges}")
        keys = jax.random.split(jax.random.PRNGKey(1), 4)
        q, k, v = (jax.random.normal(kk, (n, d_pl)) for kk in keys[:3])
        a = jax.random.normal(keys[3], (2, 1, d_pl)) * 0.1
        se, de = ell_dual(gp)
        tally.check(
            f"ell_attention power-law d={d_pl}",
            lambda se, de, gp, q, k, v: ell_attention(de, se, q, k, v),
            lambda se, de, gp, q, k, v: attention(gp, q, k, v, impl="xla"),
            (q, k, v), consts=(se, de, gp))
        tally.check(
            f"ell_gat_attention power-law d={d_pl}",
            lambda se, de, gp, al, ar, z: ell_gat_attention(
                de, se, al, ar, z, negative_slope=0.2),
            lambda se, de, gp, al, ar, z: gat_attention(
                gp, al, ar, z, negative_slope=0.2, impl="xla"),
            (a[0], a[1], q[:, None, :]), consts=(se, de, gp))

    # Random row gathers at the power-law graph's edge order: the rate at
    # which an ELL sweep fetches neighbour rows.
    idx = gp.dst[: gp.n_edges]
    rec = bench_fn(lambda x, i: x[i], (q, idx), iters=(2, 12), repeats=3,
                   name="row_gather")
    gbs = idx.shape[0] * d_pl * 4 / rec.time_s / 1e9
    log(f"  row gather: {idx.shape[0]} rows x {d_pl} f32 in "
        f"{rec.time_s * 1e3:.4f} ms = {gbs:.1f} GB/s")
    log(f"phase 2 op_family: ok {tally.summary()} row_gather_gb_s={gbs:.1f}")


def phase_tiled(grid=(1024, 1024), d=128):
    import jax

    from custom_op_benchmark_tpu.graph import grid_graph
    from custom_op_benchmark_tpu.graph.reorder import (
        reorder_graph,
        tile_aligned_order,
    )
    from custom_op_benchmark_tpu.graph.tiled import tile_graph
    from custom_op_benchmark_tpu.ops import attention, sddmm, vector_spmm
    from custom_op_benchmark_tpu.ops.tiled import (
        tiled_attention,
        tiled_sddmm,
        tiled_spmm,
    )

    tally = Tally()
    g = grid_graph(*grid)
    g2, _ = reorder_graph(g, tile_aligned_order(g, block=128))
    tg = tile_graph(g2, 128, 128)
    n, e = g2.n_nodes, g2.n_edges
    log(f"  grid_graph{grid}: n={n} e={e} tiles={tg.num_tiles} "
        f"density={tg.density:.3f}")
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    A, B, V = (jax.random.normal(kk, (n, d)) for kk in keys[:3])
    ed = jax.random.normal(keys[3], (g2.num_edges_padded,))
    with jax.default_matmul_precision("highest"):
        edges = (g2.num_edges_padded, e)
        tally.check(
            f"tiled_sddmm grid d={d}",
            lambda tg, g2, a, b: tg.gather_edges(tiled_sddmm(tg, a, b)),
            lambda tg, g2, a, b: sddmm(g2, a, b, impl="xla"), (A, B),
            edges, consts=(tg, g2))
        tally.check(
            f"tiled_spmm grid d={d}",
            lambda tg, g2, w, x: tiled_spmm(
                tg, tg.scatter_edges(w)[: tg.num_tiles], x),
            lambda tg, g2, w, x: vector_spmm(g2, w, x, impl="xla"),
            (ed, V), edges, consts=(tg, g2))
        tally.check(
            f"tiled_attention dst grid d={d}",
            lambda tg, g2, q, k, v: tiled_attention(tg, q, k, v,
                                                    normalize="dst"),
            lambda tg, g2, q, k, v: attention(g2, q, k, v, impl="xla"),
            (A, B, V), consts=(tg, g2))
    log(f"phase 3 tiled_kernels: ok {tally.summary()}")


def _run_cli(argv):
    """``train.run.main(argv)`` in this process; returns its JSON."""
    from custom_op_benchmark_tpu.train import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    if rc != 0:
        raise AssertionError(f"train.run {argv} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _falling(losses):
    losses = [float(v) for v in losses]
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return losses


def phase_trainer(scale=1.0, epochs=3):
    import jax

    import __graft_entry__

    t0 = time.perf_counter()
    out = _run_cli(["--config", "arxiv_gat", "--epochs", str(epochs),
                    "--scale", str(scale), "--log-every", "1"])
    losses = _falling([h["loss"] for h in out["history"]])
    log(f"  arxiv_gat scale={scale}: losses={losses} "
        f"val_acc={out['val_acc']:.4f} ({time.perf_counter() - t0:.1f} s)")

    fn, args = __graft_entry__.entry()
    logits, attn = jax.block_until_ready(jax.jit(fn)(*args))
    for name, a in (("logits", logits), ("attention", attn)):
        if not np.all(np.isfinite(np.asarray(a, np.float32))):
            raise AssertionError(f"entry(): non-finite {name}")
    log(f"phase 4 trainer: ok arxiv_gat losses={losses} entry logits "
        f"{tuple(logits.shape)} attention {tuple(attn.shape)} finite")
    return fn, args


def phase_precision(entry_fn, entry_args, clique=(512, 30), d=1024):
    import jax

    from custom_op_benchmark_tpu.graph import clique_batch
    from custom_op_benchmark_tpu.ops import attention

    g = clique_batch(*clique)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    q, k, v = (jax.random.normal(kk, (g.n_nodes, d)) for kk in keys)
    tol = DEFAULT_PRECISION_TOL
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda q, k, v: attention(g, q, k, v, impl="xla"))(
            q, k, v)
        ref_entry = jax.jit(entry_fn)(*entry_args)
    got = jax.jit(lambda q, k, v: attention(g, q, k, v, impl="tiled"))(
        q, k, v)
    e1 = compare("tiled attention default precision", got, ref, tol, tol)
    got_entry = jax.jit(entry_fn)(*entry_args)
    e2 = max(compare(f"entry {i} default precision", a, b, tol, tol)
             for i, (a, b) in enumerate(zip(got_entry, ref_entry)))
    log(f"phase 5 precision: ok tiled_attention d={d} max_err={e1:.3e} "
        f"entry max_err={e2:.3e} tol rtol={tol} atol={tol}*max|ref| "
        "precision=default (TF32 / bf16 policy) vs highest")


def phase_four_cards(scale=1.0, epochs=3, heads=4, d=16, devices=4):
    """Halo attention vs the single-card segment path, then
    edge-partitioned training, on a 4-device mesh."""
    import jax

    from custom_op_benchmark_tpu.ops import attention
    from custom_op_benchmark_tpu.parallel import (
        halo_attention_ell,
        halo_ell,
        halo_graph,
        make_mesh,
        shard_halo_nodes,
    )
    from custom_op_benchmark_tpu.train import run

    ds = run._ds(47, 5200, 100 if scale >= 1 else 32, scale,
                 avg_degree=20, name="products-like")
    g = ds.graph
    mesh = make_mesh((devices,), ("edge",))
    hg = halo_graph(g, mesh)
    he = halo_ell(hg, mesh)
    n = g.n_nodes
    log(f"  halo plan: n={n} e={g.n_edges} parts={devices} "
        f"halo_fraction={hg.halo_fraction:.4f} hubs={hg.n_hub}")
    rng = np.random.default_rng(4)
    qkv = [rng.normal(size=(n, heads, d)).astype(np.float32)
           for _ in range(3)]
    ct = rng.normal(size=(hg.n_pad, heads, d)).astype(np.float32)
    ct[n:] = 0
    sharded = [shard_halo_nodes(hg, mesh, a) for a in qkv]
    cts = shard_halo_nodes(hg, mesh, ct)

    def dist(q, k, v, ct):
        y, vjp = jax.vjp(
            lambda q, k, v: halo_attention_ell(hg, he, mesh, q, k, v),
            q, k, v)
        return y, vjp(ct)

    def single(q, k, v, ct):
        y, vjp = jax.vjp(
            lambda q, k, v: attention(g, q, k, v, impl="xla"), q, k, v)
        return y, vjp(ct)

    with jax.default_matmul_precision("highest"):
        y, grads = jax.jit(dist)(*sharded, cts)
        dev0 = jax.devices()[0]
        y_ref, grads_ref = jax.jit(single)(
            *(jax.device_put(a, dev0) for a in qkv),
            jax.device_put(ct[:n], dev0))
    placed = {s.device for s in y.addressable_shards}
    if len(y.sharding.device_set) != devices or len(placed) != devices:
        raise AssertionError(f"output on devices {placed}")
    rows = {s.data.shape[0] for s in y.addressable_shards}
    ef = compare("halo_attention_ell fwd", np.asarray(y)[:n], y_ref,
                 *HIGHEST["fwd"])
    eg = max(compare(f"halo_attention_ell grad[{i}]", np.asarray(a)[:n], b,
                     *HIGHEST["grad"])
             for i, (a, b) in enumerate(zip(grads, grads_ref)))
    log(f"  halo_attention_ell on {sorted(str(dv) for dv in placed)} "
        f"rows/shard={rows}: max_err fwd={ef:.3e} grad={eg:.3e}")
    t0 = time.perf_counter()
    out = _run_cli(["--config", "products_gat_dist", "--epochs", str(epochs),
                    "--scale", str(scale)])
    if out["num_devices"] != devices:
        raise AssertionError(f"trained on {out['num_devices']} devices")
    losses = _falling(out["losses"])
    log(f"  products_gat_dist scale={scale}: devices={out['num_devices']} "
        f"losses={losses} val_acc={out['val_acc']:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"phase 4-card edge_partitioned: ok devices={devices} "
        f"max_err fwd={ef:.3e} grad={eg:.3e} vs single-card segment path "
        f"tol fwd rtol={HIGHEST['fwd'][0]} atol={HIGHEST['fwd'][1]}"
        f"*max|ref| grad rtol={HIGHEST['grad'][0]} "
        f"atol={HIGHEST['grad'][1]}*max|ref| precision=highest")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the edge-partitioned phase on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX backend is "
              f"{backend!r}", file=sys.stderr)
        return 1
    devs = jax.devices()
    want = 4 if args.four_cards else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1

    from custom_op_benchmark_tpu.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    phase_device()
    if args.four_cards:
        phase_four_cards(devices=want)
    else:
        phase_op_family()
        phase_tiled()
        entry_fn, entry_args = phase_trainer()
        phase_precision(entry_fn, entry_args)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
