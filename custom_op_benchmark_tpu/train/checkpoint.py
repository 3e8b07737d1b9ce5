"""Checkpoint/resume as ``.npz`` files (the reference has none — SURVEY.md
§5).

A checkpoint is a directory holding one ``arrays.<process>.npz`` per
process: the flattened pytree's leaves, each as the shards this process
can address. Restoring reads them back into a template pytree of the same
structure, placing every shard on the device and sharding the template
leaf has, so sharded multi-process state round-trips too.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def _file(path: str) -> str:
    return os.path.join(path, f"arrays.{jax.process_index()}.npz")


def checkpoint_complete(path: str) -> bool:
    """True once this process's file of ``path`` was fully written."""
    return os.path.exists(_file(path))


def save_pytree(path: str, tree: Any) -> str:
    """Write ``tree``'s leaves under directory ``path``. The file appears
    under its final name only when complete (write, then rename)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        if isinstance(leaf, jax.Array):
            for j, shard in enumerate(leaf.addressable_shards):
                arrays[f"{i}.{j}"] = np.asarray(shard.data)
        else:
            arrays[str(i)] = np.asarray(leaf)
    tmp = _file(path) + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, _file(path))
    return path


def restore_pytree(path: str, template: Any) -> Any:
    """Read a :func:`save_pytree` directory into ``template``'s structure,
    shapes, dtypes and shardings."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    out = []
    with np.load(_file(os.path.abspath(path))) as data:

        def read(key, dtype):
            # .npz keeps extension dtypes such as bfloat16 as raw bytes.
            a = data[key]
            return a if a.dtype == dtype else a.view(dtype)

        for i, leaf in enumerate(leaves):
            if isinstance(leaf, jax.Array):
                shards = [
                    jax.device_put(read(f"{i}.{j}", leaf.dtype), s.device)
                    for j, s in enumerate(leaf.addressable_shards)
                ]
                out.append(jax.make_array_from_single_device_arrays(
                    leaf.shape, leaf.sharding, shards))
            else:
                out.append(read(str(i), np.asarray(leaf).dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def _payload(state):
    return {"step": state.step, "params": state.params,
            "opt_state": state.opt_state}


def save_checkpoint(path: str, state: Any) -> str:
    """Save a TrainState's step, params and optimizer state to ``path``."""
    return save_pytree(path, _payload(state))


def restore_checkpoint(path: str, state: Any) -> Any:
    """Restore into an existing TrainState template (apply_fn/tx kept)."""
    return state.replace(**restore_pytree(path, _payload(state)))
