"""Edge-partitioned distributed training (BASELINE configs 4-5).

A multi-layer GAT whose attention runs through the ``shard_map`` ops of
parallel/shard_ops.py: node features and edge lists sharded over a 1-D
``("edge",)`` mesh, parameters replicated (data-parallel gradient psum
falls out of jit's partitioner), segment softmax healed across shards
with pmax/psum, aggregation with psum_scatter — the multi-chip
generalization of the reference's single-GPU row chunking
(part_csr.py:13-27; SURVEY.md §2.4, §7.6).

Plain param-dict model (not flax): inside/outside shard_map boundaries
are explicit, and the training step stays a single jit over global
sharded arrays.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from custom_op_benchmark_tpu.parallel.shard_ops import (
    DistGraph,
    dist_gat_attention,
    dist_graph,
    shard_nodes,
)


def init_dist_gat(rng, in_dim: int, hidden: int, num_classes: int,
                  num_heads: int = 4, num_layers: int = 2):
    """Replicated GAT parameters: per layer Wq/Wk/Wv, plus output head."""
    rngs = jax.random.split(rng, 3 * num_layers + 1)
    head_dim = hidden // num_heads
    params = {"layers": [], "num_heads": num_heads, "head_dim": head_dim}
    d_in = in_dim
    scale = lambda d: 1.0 / np.sqrt(d)  # noqa: E731
    for i in range(num_layers):
        params["layers"].append({
            "wq": jax.random.normal(rngs[3 * i], (d_in, hidden)) * scale(d_in),
            "wk": jax.random.normal(rngs[3 * i + 1], (d_in, hidden))
            * scale(d_in),
            "wv": jax.random.normal(rngs[3 * i + 2], (d_in, hidden))
            * scale(d_in),
        })
        d_in = hidden
    params["wo"] = jax.random.normal(rngs[-1], (hidden, num_classes)) * scale(
        hidden
    )
    return params


def _cast(a, dt):
    return a if dt is None else a.astype(dt)


def dist_gat_forward(dg, mesh: Mesh, params, x, dtype=None):
    """x: (n_pad, f) node-sharded → logits (n_pad, classes) node-sharded.

    ``dg`` is either a :class:`DistGraph` (all_gather + psum_scatter
    plan) or a :class:`parallel.halo.HaloGraph` (owner-computes halo
    all_to_all plan — less communication, fully local softmax).

    ``dtype=jnp.bfloat16`` runs the measured mixed-precision policy on
    the distributed path (params stay f32, logits return f32): q/k/v —
    and therefore the k‖v halo exchange AND the reverse dk‖dv exchange
    — carry bf16, halving both the gathered tiles and the wire bytes
    (round-4 verdict #2 extends the single-device policy to the halo
    plan).
    """
    from custom_op_benchmark_tpu.parallel.halo import (
        HaloGraph, halo_attention_ell, halo_gat_attention,
    )

    h = params["num_heads"]
    d = params["head_dim"]
    npad = x.shape[0]
    if isinstance(dg, tuple):            # (HaloGraph, HaloEll): fast local
        hgr, he = dg
        attn = lambda q, k, v: halo_attention_ell(   # noqa: E731
            hgr, he, mesh, q, k, v)
    elif isinstance(dg, HaloGraph):
        attn = lambda q, k, v: halo_gat_attention(   # noqa: E731
            dg, mesh, q, k, v)
    else:
        attn = lambda q, k, v: dist_gat_attention(   # noqa: E731
            dg, mesh, q, k, v)
    for layer in params["layers"]:
        xc = _cast(x, dtype)
        q = (xc @ _cast(layer["wq"], dtype)).reshape(npad, h, d)
        k = (xc @ _cast(layer["wk"], dtype)).reshape(npad, h, d)
        v = (xc @ _cast(layer["wv"], dtype)).reshape(npad, h, d)
        x = jax.nn.elu(attn(q, k, v).reshape(npad, h * d))
    return _cast(x, jnp.float32) @ params["wo"]


def init_dist_transformer(rng, in_dim: int, dim: int, num_classes: int,
                          num_heads: int = 4, num_layers: int = 2,
                          mlp_dim: int = None):
    """Replicated graph-transformer parameters (pre-LN blocks)."""
    mlp_dim = mlp_dim or 4 * dim
    head_dim = dim // num_heads
    keys = iter(jax.random.split(rng, 6 * num_layers + 2))
    scale = lambda d: 1.0 / np.sqrt(d)  # noqa: E731
    params = {
        "proj_in": jax.random.normal(next(keys), (in_dim, dim))
        * scale(in_dim),
        "layers": [],
        "wo_head": None,
        "num_heads": num_heads, "head_dim": head_dim,
    }
    for _ in range(num_layers):
        params["layers"].append({
            "ln1s": jnp.ones((dim,)), "ln1b": jnp.zeros((dim,)),
            "wq": jax.random.normal(next(keys), (dim, dim)) * scale(dim),
            "wk": jax.random.normal(next(keys), (dim, dim)) * scale(dim),
            "wv": jax.random.normal(next(keys), (dim, dim)) * scale(dim),
            "wo": jax.random.normal(next(keys), (dim, dim)) * scale(dim),
            "ln2s": jnp.ones((dim,)), "ln2b": jnp.zeros((dim,)),
            "w1": jax.random.normal(next(keys), (dim, mlp_dim))
            * scale(dim),
            "b1": jnp.zeros((mlp_dim,)),
            "w2": jax.random.normal(next(keys), (mlp_dim, dim))
            * scale(mlp_dim),
            "b2": jnp.zeros((dim,)),
        })
    params["lnos"] = jnp.ones((dim,))
    params["lnob"] = jnp.zeros((dim,))
    params["wo_head"] = jax.random.normal(
        next(keys), (dim, num_classes)) * scale(dim)
    return params


def _ln(x, s, b):
    m = x.mean(-1, keepdims=True)
    v = ((x - m) ** 2).mean(-1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + 1e-6) * s + b


def dist_transformer_forward(dg, mesh: Mesh, params, x, dtype=None):
    """Distributed masked graph transformer (pre-LN attention + MLP
    blocks). The attention runs the sharded plan (halo all_to_all or
    all_gather/psum_scatter); LayerNorm, projections, residuals and the
    MLP are node-local, so GSPMD keeps them on each row's owner with no
    extra collectives — the edge-partitioned analog of
    models/transformer.py.

    ``dtype=jnp.bfloat16``: residual stream and LayerNorm stay f32, the
    q/k/v/MLP matmuls and the halo exchanges run bf16 (the
    models/transformer.py mixed-precision policy, distributed).
    """
    from custom_op_benchmark_tpu.parallel.halo import (
        HaloGraph, halo_attention_ell, halo_gat_attention,
    )

    h = params["num_heads"]
    d = params["head_dim"]
    npad = x.shape[0]
    if isinstance(dg, tuple):
        hgr, he = dg
        attn = lambda q, k, v: halo_attention_ell(   # noqa: E731
            hgr, he, mesh, q, k, v)
    elif isinstance(dg, HaloGraph):
        attn = lambda q, k, v: halo_gat_attention(   # noqa: E731
            dg, mesh, q, k, v)
    else:
        attn = lambda q, k, v: dist_gat_attention(   # noqa: E731
            dg, mesh, q, k, v)
    x = x @ params["proj_in"]
    for lyr in params["layers"]:
        y = _cast(_ln(x, lyr["ln1s"], lyr["ln1b"]), dtype)
        q = (y @ _cast(lyr["wq"], dtype)).reshape(npad, h, d)
        k = (y @ _cast(lyr["wk"], dtype)).reshape(npad, h, d)
        v = (y @ _cast(lyr["wv"], dtype)).reshape(npad, h, d)
        a = _cast(attn(q, k, v).reshape(npad, h * d), jnp.float32)
        x = x + a @ lyr["wo"]
        y = _cast(_ln(x, lyr["ln2s"], lyr["ln2b"]), dtype)
        x = x + _cast(
            jax.nn.gelu(y @ _cast(lyr["w1"], dtype)
                        + _cast(lyr["b1"], dtype)) @ _cast(lyr["w2"],
                                                           dtype),
            jnp.float32,
        ) + lyr["b2"]
    x = _ln(x, params["lnos"], params["lnob"])
    return x @ params["wo_head"]


def _pick_order(g, p):
    """Choose cluster vs degree-balanced renumbering from the two
    host-side plans' static numbers (no devices touched).

    Objective per candidate, in row-fetch units: max-shard padded slots
    (per-shard compute — rows gathered from device memory at the
    measured row-gather rate) + exchange volume rows weighted by that
    rate over the nominal link rate (same row_bytes on both sides;
    forward and backward each pay both terms the same number of times,
    so the per-step pass count cancels). Community graphs win on comm (cluster cuts halo
    ~5x), power-law graphs win on waste (balanced cuts max-shard slots
    up to 1.5x); the sum picks the right one at the extremes because the
    losing term is small where the winning term is large."""
    import jax

    from custom_op_benchmark_tpu.graph import (
        cluster_order, degree_balanced_order, reorder_graph,
    )
    from custom_op_benchmark_tpu.parallel.halo import plan_stats
    from custom_op_benchmark_tpu.utils.bench_scaling import (
        MEASURED_ROW_GATHER_BYTES_PER_S, NOMINAL_LINK_BYTES_PER_S,
    )

    # Comm rows cost link time; compute slots cost row-gather time from
    # device memory. Both move the same row_bytes, so the weight is the
    # rate ratio (shared constants so the projection model and this
    # picker cannot drift apart).
    comm_weight = MEASURED_ROW_GATHER_BYTES_PER_S / NOMINAL_LINK_BYTES_PER_S
    best = None
    for ro in (cluster_order(g, p), degree_balanced_order(g, p)):
        g2, _ = reorder_graph(g, ro)
        src = np.asarray(jax.device_get(g2.src))[: g2.n_edges]
        dst = np.asarray(jax.device_get(g2.dst))[: g2.n_edges]
        st = plan_stats(src, dst, g2.n_nodes, g2.n_edges, p,
                        -(-g2.n_nodes // p), g2.num_edges_padded,
                        hub_threshold="auto")
        vol_rows = p * st.halo + (p - 1) * st.n_hub
        cost = st.pack_slots + comm_weight * vol_rows
        if best is None or cost < best[0]:
            best = (cost, ro)
    return best[1]


def fit_edge_partitioned(dataset, mesh: Mesh, *, hidden: int = 64,
                         num_heads: int = 4, num_layers: int = 2,
                         epochs: int = 50, learning_rate: float = 1e-2,
                         seed: int = 0, plan: str = "halo",
                         arch: str = "gat", order: str = "auto",
                         dtype=None):
    """Train a distributed GAT or graph transformer on ``dataset``.

    ``plan``: "halo" (owner-computes all_to_all boundary exchange — the
    scalable layout) or "gather" (all_gather + psum_scatter baseline).
    ``arch``: "gat" (Wq/Wk/Wv attention + elu stack) or "transformer"
    (pre-LN attention + MLP blocks — the distributed
    models/transformer.py analog).
    ``dtype``: compute dtype for the attention path (None = f32;
    ``jnp.bfloat16`` = the mixed-precision policy — params and
    optimizer state stay f32, activations/halo wire bytes halve).
    ``order`` (halo plan only): "cluster" (BFS+label-prop locality — cuts
    the halo exchange ~5x on community graphs), "balanced" (serpentine
    degree striping — equalizes the shared-shape packings across shards,
    the right call on locality-free power-law graphs where waste, not
    comm, is the scaling tax), or
    "auto" (build both host-side plans and keep the one minimizing
    max-shard padded slots + padded wire rows — a few seconds of numpy at
    layout time, like the hub "auto" sweep).
    Returns (params, metrics). Works identically on a real multi-chip mesh
    and a CPU ``xla_force_host_platform_device_count`` mesh (how multi-host
    is validated in this environment — SURVEY.md §4).
    """
    g = dataset.graph
    feats = np.asarray(dataset.features, np.float32)
    labels_np = np.asarray(dataset.labels, np.int32)
    train_np = np.asarray(dataset.train_mask, np.float32)
    val_np = np.asarray(dataset.val_mask, np.float32)
    if plan == "halo":
        from custom_op_benchmark_tpu.graph import (
            cluster_order, degree_balanced_order, reorder_graph,
        )
        from custom_op_benchmark_tpu.parallel.halo import (
            halo_graph, shard_halo_nodes,
        )

        p = int(np.prod(list(mesh.shape.values())))
        if order == "auto":
            ro = _pick_order(g, p)
        elif order == "balanced":
            ro = degree_balanced_order(g, p)
        elif order == "cluster":
            # Locality clustering: BFS + label-prop renumbering cuts the
            # halo exchange ~5x on community graphs (graph/cluster.py).
            ro = cluster_order(g, p)
        else:
            raise ValueError(
                f"order must be 'auto'/'balanced'/'cluster', got {order!r}")
        g, _ = reorder_graph(g, ro)

        def _scatter(arr):
            out = np.zeros((ro.n_new,) + arr.shape[1:], arr.dtype)
            out[ro.perm] = arr
            return out

        feats = _scatter(feats)
        labels_np = _scatter(labels_np)
        train_np = _scatter(train_np)
        val_np = _scatter(val_np)
        from custom_op_benchmark_tpu.parallel.halo import halo_ell

        # Auto hub split: on power-law graphs with no community
        # structure the few high-degree srcs dominate the per-pair
        # all_to_all payload; 'auto' keeps the vertex-cut split only
        # when it shrinks the padded wire volume (parallel/halo.py).
        hgr = halo_graph(g, mesh, hub_threshold="auto")
        dg = (hgr, halo_ell(hgr, mesh))   # scatter-free local compute
        shard_fn = lambda arr: shard_halo_nodes(hgr, mesh, arr)  # noqa: E731
    elif plan == "gather":
        dg = dist_graph(g, mesh)
        shard_fn = lambda arr: shard_nodes(dg, mesh, arr)  # noqa: E731
    else:
        raise ValueError(f"plan must be 'halo'/'gather', got {plan!r}")
    x = shard_fn(feats)
    labels = shard_fn(labels_np)
    train_mask = shard_fn(train_np)
    val_mask = shard_fn(val_np)
    if arch == "transformer":
        params = init_dist_transformer(
            jax.random.PRNGKey(seed), x.shape[-1], hidden,
            dataset.num_classes, num_heads, num_layers,
        )
        forward = dist_transformer_forward
    elif arch == "gat":
        params = init_dist_gat(
            jax.random.PRNGKey(seed), x.shape[-1], hidden,
            dataset.num_classes, num_heads, num_layers,
        )
        forward = dist_gat_forward
    else:
        raise ValueError(f"arch must be 'gat'/'transformer', got {arch!r}")
    num_heads_static = params.pop("num_heads")
    head_dim_static = params.pop("head_dim")

    def with_static(p):
        return {**p, "num_heads": num_heads_static,
                "head_dim": head_dim_static}

    # Graph views and data enter the jitted steps as ARGUMENTS — closing
    # over them would embed their index arrays as HLO constants (bloats
    # executables and compile times at ogbn scales).
    def loss_fn(p, dg_, x_, labels_, mask):
        logits = forward(dg_, mesh, with_static(p), x_, dtype=dtype)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(
            logp, labels_[:, None].astype(jnp.int32), axis=-1
        )[:, 0]
        return (nll * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    import optax

    tx = optax.adam(learning_rate)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(p, opt_state, dg_, x_, labels_, mask):
        loss, grads = jax.value_and_grad(loss_fn)(
            p, dg_, x_, labels_, mask)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    @jax.jit
    def accuracy(p, dg_, x_, labels_, mask):
        logits = forward(dg_, mesh, with_static(p), x_, dtype=dtype)
        correct = (jnp.argmax(logits, -1) == labels_).astype(jnp.float32)
        return (correct * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    losses = []
    for _ in range(epochs):
        params, opt_state, loss = train_step(
            params, opt_state, dg, x, labels, train_mask)
        losses.append(loss)
    losses = [float(v) for v in losses]
    metrics = dict(
        loss=losses[-1] if losses else float("inf"),
        losses=losses,
        train_acc=float(accuracy(params, dg, x, labels, train_mask)),
        val_acc=float(accuracy(params, dg, x, labels, val_mask)),
        num_devices=int(np.prod(list(mesh.shape.values()))),
    )
    return with_static(params), metrics
