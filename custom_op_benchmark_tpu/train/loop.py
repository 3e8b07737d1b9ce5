"""Training loops: full-graph and sampled-minibatch node classification.

The reference has no training at all (its harness stops at op-level
gradients); these loops realize the BASELINE.md configs — full-graph GAT
(Cora/ogbn-arxiv style) and sampled GraphSAGE (Reddit style) — on top of
the op family, with jit-compiled steps and donated state.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from custom_op_benchmark_tpu.graph.graph import Graph
from custom_op_benchmark_tpu.data.sampling import NeighborSampler, SampledBatch


@partial(jax.tree_util.register_dataclass,
         data_fields=["step", "params", "opt_state"],
         meta_fields=["apply_fn", "tx"])
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Step counter, parameters and optimizer state (the pytree leaves),
    plus the model's ``apply`` and the optimizer (static)."""

    step: jax.Array
    params: Any
    opt_state: Any
    apply_fn: Callable
    tx: optax.GradientTransformation

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads):
        updates, new_opt = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(
            step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=new_opt,
        )


def create_train_state(model, g: Graph, x, rng,
                       tx: Optional[optax.GradientTransformation] = None,
                       learning_rate: float = 1e-2,
                       weight_decay: float = 5e-4,
                       **model_kwargs) -> TrainState:
    if tx is None:
        tx = optax.adamw(learning_rate, weight_decay=weight_decay)
    # Init under jit: run eagerly, the fused ops' gathered tiles (GBs at
    # ogbn scales) materialize per-op with no buffer reuse and OOM.
    params = jax.jit(
        lambda rng, g, x, kw: model.init(rng, g, x, **kw)
    )(rng, g, jnp.asarray(x), model_kwargs)["params"]
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=tx.init(params),
        apply_fn=model.apply,
        tx=tx,
    )


def masked_cross_entropy(logits, labels, mask):
    logp = jax.nn.log_softmax(logits)
    nll = -jnp.take_along_axis(logp, labels[:, None].astype(jnp.int32),
                               axis=-1)[:, 0]
    mask = mask.astype(logits.dtype)
    return (nll * mask).sum() / jnp.maximum(mask.sum(), 1.0)


def make_train_step(dropout: bool = False, apply_kwargs: dict = None):
    """Jit-compiled full-graph train step (donated state).

    ``apply_kwargs`` forwards execution-strategy views to the model
    (e.g. ``{"ell": ell_dual(g)}`` or ``{"block": block_graph(g)}``).
    The views are passed to jit as ARGUMENTS (static_kwargs would embed
    their — potentially hundreds of MB of — index arrays as HLO
    constants, bloating executables and remote-compile payloads).
    """
    base_kwargs = dict(apply_kwargs or {})

    @partial(jax.jit, donate_argnums=(0,), static_argnames=("dropout_",))
    def _step(state: TrainState, g: Graph, x, labels, mask, rng, views,
              dropout_=False):
        def loss_fn(params):
            kwargs = dict(views)
            if dropout_:
                kwargs.update(
                    deterministic=False, rngs={"dropout": rng}
                )
            logits = state.apply_fn({"params": params}, g, x, **kwargs)
            return masked_cross_entropy(logits, labels, mask), logits

        (loss, logits), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params)
        state = state.apply_gradients(grads)
        acc = (
            (jnp.argmax(logits, -1) == labels) * mask
        ).sum() / jnp.maximum(mask.sum(), 1)
        return state, loss, acc

    def train_step(state, g, x, labels, mask, rng=None):
        return _step(state, g, x, labels, mask, rng, base_kwargs,
                     dropout_=dropout)

    return train_step


def make_eval_step(apply_kwargs: dict = None):
    base_kwargs = dict(apply_kwargs or {})

    @jax.jit
    def _eval(state: TrainState, g: Graph, x, labels, mask, views):
        logits = state.apply_fn({"params": state.params}, g, x, **views)
        loss = masked_cross_entropy(logits, labels, mask)
        acc = (
            (jnp.argmax(logits, -1) == labels) * mask
        ).sum() / jnp.maximum(mask.sum(), 1)
        return loss, acc

    def eval_step(state, g, x, labels, mask):
        return _eval(state, g, x, labels, mask, base_kwargs)

    return eval_step


def fit_full_graph(model, dataset, *, epochs: int = 100,
                   learning_rate: float = 1e-2, weight_decay: float = 5e-4,
                   seed: int = 0, log_every: int = 0,
                   target_val_acc: Optional[float] = None,
                   strategy: Optional[str] = None):
    """Train on the whole graph each epoch (Cora/ogbn-arxiv configs).

    ``strategy``: None (segment ops), "ell" (degree-bucketed fused
    attention — general graphs), "block" (component-batched dense —
    blocky graphs), or "auto" (consult the structural advisor,
    utils/summary.describe, like the op-level ``impl="auto"``). Builds
    the corresponding graph view once and threads it through every
    model apply.
    """
    g = dataset.graph
    apply_kwargs = {}
    if strategy == "auto":
        from custom_op_benchmark_tpu.utils.summary import describe

        rec = describe(g).recommended
        strategy = "block" if rec == "dense_block" else "ell"
    if strategy == "ell":
        from custom_op_benchmark_tpu.ops import ell_dual

        apply_kwargs["ell"] = ell_dual(g, profile="train")
    elif strategy == "block":
        from custom_op_benchmark_tpu.graph import block_graph

        bg = block_graph(g)
        if bg is None:
            raise ValueError("graph has components too large for "
                             "strategy='block'")
        apply_kwargs["block"] = bg
    elif strategy is not None:
        raise ValueError(f"unknown strategy {strategy!r}")
    x = jnp.asarray(dataset.features)
    labels = jnp.asarray(dataset.labels)
    train_mask = jnp.asarray(dataset.train_mask)
    val_mask = jnp.asarray(dataset.val_mask)

    state = create_train_state(
        model, g, x, jax.random.PRNGKey(seed),
        learning_rate=learning_rate, weight_decay=weight_decay,
    )
    train_step = make_train_step(apply_kwargs=apply_kwargs)
    eval_step = make_eval_step(apply_kwargs=apply_kwargs)

    history = []
    for epoch in range(epochs):
        state, loss, acc = train_step(state, g, x, labels, train_mask)
        if log_every and (epoch + 1) % log_every == 0:
            vl, va = eval_step(state, g, x, labels, val_mask)
            history.append(dict(epoch=epoch + 1, loss=float(loss),
                                train_acc=float(acc), val_loss=float(vl),
                                val_acc=float(va)))
            if target_val_acc is not None and float(va) >= target_val_acc:
                break
    vl, va = eval_step(state, g, x, labels, val_mask)
    return state, dict(val_loss=float(vl), val_acc=float(va),
                       history=history)


def fit_sampled(model, dataset, *, fanouts=(25, 10), batch_size: int = 128,
                epochs: int = 1, learning_rate: float = 1e-3,
                seed: int = 0, prefetch_depth: int = 2):
    """Sampled-minibatch training (Reddit GraphSAGE-style config).

    Sampling runs on host (numpy) overlapped with device steps via the
    prefetch pipeline; each batch has static shapes so the step compiles
    once.
    """
    import inspect

    from custom_op_benchmark_tpu.data.pipeline import prefetch

    sampler = NeighborSampler(dataset.graph, fanouts, seed=seed)
    feats = dataset.features
    labels = dataset.labels
    model_takes_in_cols = (
        "in_cols" in inspect.signature(model.__call__).parameters
    )

    # Device-resident features/labels: the round-1 pipeline shipped the
    # gathered (max_nodes, f) feature slice from host every step — 36 MB
    # per Reddit-config batch, 78% of the step. Keep the FULL feature
    # array on device once and gather by node_ids on device instead
    # (node_ids transfer is ~KBs). Falls back to host gathers when the
    # array would not reasonably fit HBM.
    feats_bytes = feats.size * feats.dtype.itemsize
    device_feats = feats_bytes < 8 * 1024 ** 3
    if device_feats:
        feats_dev = jnp.asarray(feats)
        labels_dev = jnp.asarray(labels)

    # Build state on one representative batch.
    train_ids = np.nonzero(dataset.train_mask)[0]
    b0 = sampler.sample(train_ids[:batch_size])
    x0 = jnp.asarray(feats[b0.node_ids])
    init_kw = dict(in_cols=jnp.asarray(b0.in_cols)) \
        if model_takes_in_cols else {}
    state = create_train_state(
        model, b0.graph, x0, jax.random.PRNGKey(seed),
        learning_rate=learning_rate, **init_kw,
    )

    @partial(jax.jit, donate_argnums=(0,), static_argnums=(7,))
    def step(state, g, xspec, y, seed_mask, in_cols, feats_arg,
             on_device):
        # feats_arg is a jit ARGUMENT, not a closure: closed-over device
        # arrays embed in the executable as constants.
        if on_device:
            x = feats_arg[xspec]                  # on-device gather
        else:
            x = xspec
        kw = {"in_cols": in_cols} if in_cols is not None else {}

        def loss_fn(params):
            logits = state.apply_fn({"params": params}, g, x, **kw)
            k = seed_mask.shape[0]
            return masked_cross_entropy(
                logits[:k], y, seed_mask
            ), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        return state.apply_gradients(grads), loss

    losses = []
    for _ in range(epochs):
        def batches():
            for b in sampler.epoch(train_ids, batch_size):
                cols = (jnp.asarray(b.in_cols)
                        if model_takes_in_cols else None)
                # n_edges is a STATIC Graph field that varies per batch;
                # normalize it to the padded bound (as stack_batches
                # does) so the jitted step compiles once per epoch, not
                # once per batch. Nothing in the sampled step reads
                # n_edges — padded edges land in the dummy segment.
                b = dataclasses.replace(
                    b, graph=dataclasses.replace(
                        b.graph, n_edges=b.graph.num_edges_padded
                    )
                )
                if device_feats:
                    yield (b.graph, jnp.asarray(b.node_ids),
                           labels_dev[jnp.asarray(b.seed_ids)],
                           jnp.asarray(b.seed_mask), cols)
                else:
                    yield (b.graph, jnp.asarray(feats[b.node_ids]),
                           jnp.asarray(labels[b.seed_ids]),
                           jnp.asarray(b.seed_mask), cols)

        for g_b, x_b, y_b, m_b, c_b in prefetch(batches(), prefetch_depth):
            state, loss = step(
                state, g_b, x_b, y_b, m_b, c_b,
                feats_dev if device_feats else jnp.zeros((1, 1)),
                device_feats,
            )
            # Keep the loss on device until the epoch ends: a float()
            # here is a host round trip per step, serializing the async
            # dispatch pipeline.
            losses.append(loss)

    losses = [float(l) for l in losses]

    # Final eval: full-graph inference (sampling is a training-time
    # approximation; eval uses the exact neighborhood).
    logits = state.apply_fn(
        {"params": state.params}, dataset.graph,
        jnp.asarray(dataset.features),
    )
    pred = np.asarray(jnp.argmax(logits, -1))
    val = np.asarray(dataset.val_mask)
    val_acc = float((pred[val] == dataset.labels[val]).mean()) if val.any() \
        else float("nan")
    return state, dict(
        losses=losses,
        final_loss=losses[-1] if losses else float("nan"),
        val_acc=val_acc,
    )


def fit_sampled_dp(model, dataset, mesh, *, fanouts=(25, 10),
                   batch_size: int = 128, epochs: int = 1,
                   learning_rate: float = 1e-3, seed: int = 0,
                   axis: str = "batch"):
    """Data-parallel sampled-minibatch training (SURVEY.md §2.4 DP plan:
    batch sharding of sampled subgraph minibatches over a mesh).

    Each step samples ``P`` independent seed batches (P = mesh axis
    size), stacks their static-shape pytrees on a leading axis sharded
    over ``axis``, and runs one shard_map step: every device computes
    loss/grads on its own subgraph, gradients are psum-averaged over the
    axis, and the (replicated) parameters take one update — classic
    minibatch DP, with the subgraph playing the role of the batch.
    Features stay replicated and are gathered on-device by node_ids
    (same transfer fix as :func:`fit_sampled`).
    """
    import inspect

    from jax.sharding import NamedSharding, PartitionSpec as P

    p = mesh.shape[axis]
    sampler = NeighborSampler(dataset.graph, fanouts, seed=seed)
    feats = jnp.asarray(dataset.features)
    labels = jnp.asarray(dataset.labels)
    takes_in_cols = (
        "in_cols" in inspect.signature(model.__call__).parameters
    )
    train_ids = np.nonzero(dataset.train_mask)[0]

    b0 = sampler.sample(train_ids[:batch_size])
    kw0 = dict(in_cols=jnp.asarray(b0.in_cols)) if takes_in_cols else {}
    state = create_train_state(
        model, b0.graph, jnp.asarray(dataset.features[b0.node_ids]),
        jax.random.PRNGKey(seed), learning_rate=learning_rate, **kw0,
    )

    def stack_batches(batches):
        """P SampledBatches → one pytree with leading axis P, sharded.

        The per-batch real edge count (a static pytree field) varies;
        normalize it to the padded bound so every batch shares one tree
        structure — nothing in the sampled step reads ``n_edges``
        (padded edges land in the sliced-off dummy segment/slot).
        """
        batches = [
            dataclasses.replace(
                b, graph=dataclasses.replace(
                    b.graph, n_edges=b.graph.num_edges_padded
                )
            )
            for b in batches
        ]
        stacked = jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]), *batches
        )
        return jax.device_put(
            stacked,
            jax.tree_util.tree_map(
                lambda _: NamedSharding(mesh, P(axis)), stacked
            ),
        )

    spec = P(axis)

    def step_fn(params, opt_state, graphs, node_ids, seed_ids,
                seed_mask, in_cols, feats, labels):
        g = jax.tree_util.tree_map(lambda l: l[0], graphs)
        x = feats[node_ids[0]]
        y = labels[seed_ids[0]]
        kw = {"in_cols": in_cols[0]} if takes_in_cols else {}

        def loss_fn(prm):
            logits = model.apply({"params": prm}, g, x, **kw)
            k = seed_mask.shape[-1]
            return masked_cross_entropy(logits[:k], y, seed_mask[0])

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.lax.pmean(grads, axis)
        loss = jax.lax.pmean(loss, axis)
        upd, opt_state = state.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    sharded_step = jax.jit(jax.shard_map(
        step_fn, mesh=mesh,
        in_specs=(P(), P(), spec, spec, spec, spec, spec, P(), P()),
        out_specs=(P(), P(), P()),
    ))

    params, opt_state = state.params, state.opt_state
    losses = []
    for _ in range(epochs):
        it = sampler.epoch(train_ids, batch_size)
        while True:
            group = []
            for b in it:
                group.append(b)
                if len(group) == p:
                    break
            if len(group) < p:
                break
            stacked = stack_batches(group)
            params, opt_state, loss = sharded_step(
                params, opt_state, stacked.graph,
                stacked.node_ids, stacked.seed_ids, stacked.seed_mask,
                stacked.in_cols, feats, labels,
            )
            losses.append(float(np.asarray(loss).ravel()[0]))

    state = state.replace(params=params, opt_state=opt_state)
    logits = state.apply_fn(
        {"params": state.params}, dataset.graph, feats
    )
    pred = np.asarray(jnp.argmax(logits, -1))
    val = np.asarray(dataset.val_mask)
    val_acc = float((pred[val] == dataset.labels[val]).mean()) \
        if val.any() else float("nan")
    return state, dict(losses=losses, val_acc=val_acc,
                       num_devices=p)
