"""Checkpoint/resume round trip (SURVEY.md §5 — the reference has none)."""

import os

import numpy as np
import jax
import jax.numpy as jnp

from custom_op_benchmark_tpu.data import planted_partition
from custom_op_benchmark_tpu.models import GCN
from custom_op_benchmark_tpu.train import (
    create_train_state,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)


def test_checkpoint_roundtrip(tmp_path):
    ds = planted_partition(num_classes=3, nodes_per_class=20, feat_dim=8,
                           seed=0)
    g = ds.graph
    x = jnp.asarray(ds.features)
    labels = jnp.asarray(ds.labels)
    mask = jnp.asarray(ds.train_mask)
    model = GCN(hidden_dim=8, out_dim=3)
    state = create_train_state(model, g, x, jax.random.PRNGKey(0))
    step = make_train_step()
    for _ in range(3):
        state, loss, _ = step(state, g, x, labels, mask)

    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)

    fresh = create_train_state(model, g, x, jax.random.PRNGKey(1))
    restored = restore_checkpoint(path, fresh)
    assert int(restored.step) == int(state.step)
    for a, b in zip(jax.tree_util.tree_leaves(restored.params),
                    jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # Resume training continues without error and changes params.
    resumed, loss, _ = step(restored, g, x, labels, mask)
    assert int(resumed.step) == int(state.step) + 1


def test_npz_pytree_roundtrip_sharded(tmp_path):
    """save_pytree/restore_pytree: nested dicts, scalars and an array
    sharded over the 8-device CPU mesh come back with values, dtypes and
    shardings intact."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from custom_op_benchmark_tpu.parallel import make_mesh
    from custom_op_benchmark_tpu.train.checkpoint import (
        restore_pytree,
        save_pytree,
    )

    mesh = make_mesh((len(jax.devices()),), ("edge",))
    sharded = jax.device_put(
        jnp.arange(8 * 3 * 2, dtype=jnp.float32).reshape(8 * 3, 2),
        NamedSharding(mesh, P("edge")))
    tree = {"a": {"w": jnp.ones((3, 4), jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32), "x": sharded,
            "host": np.arange(5)}
    save_pytree(str(tmp_path / "ck"), tree)
    template = jax.tree_util.tree_map(lambda a: a * 0, tree)
    template["x"] = jax.device_put(jnp.zeros_like(sharded),
                                   sharded.sharding)
    got = restore_pytree(str(tmp_path / "ck"), template)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(tree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got["x"].sharding == sharded.sharding


def test_checkpoint_manager_ignores_incomplete_saves(tmp_path):
    """A step directory counts only once its file is complete: a save
    killed before the rename never becomes "latest"."""
    from custom_op_benchmark_tpu.train import CheckpointManager

    state = {"w": jnp.ones(3)}

    class _State(dict):
        step = jnp.asarray(0)
        params = property(lambda self: self["w"])
        opt_state = ()

        def replace(self, **kw):
            return kw

    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(_State(state), 1)
    os.makedirs(tmp_path / "step_5")
    (tmp_path / "step_5" / "arrays.0.npz.tmp.npz").write_bytes(b"partial")
    assert mgr.latest_step == 1
