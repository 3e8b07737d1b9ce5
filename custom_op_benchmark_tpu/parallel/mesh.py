"""Mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("edge",),
              devices=None) -> Mesh:
    """Create a device mesh.

    Default: a 1-D ``("edge",)`` mesh over all devices — the edge-partition
    axis. Multi-axis layouts (e.g. ``("edge", "head")`` for combined
    edge × tensor parallelism) pass explicit sizes.
    """
    if devices is None:
        devices = jax.devices()
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        raise ValueError(
            f"mesh needs {n} devices, only {len(devices)} available"
        )
    arr = np.asarray(devices[:n]).reshape(tuple(axis_sizes))
    return Mesh(arr, tuple(axis_names))


def put_sharded(x, sharding) -> jax.Array:
    """Place a host array under ``sharding``, multi-process safe.

    Single-process: plain ``jax.device_put``. Multi-process (real
    ``jax.distributed`` runs — the papers100M north star): each process
    feeds only its ADDRESSABLE shards through
    ``jax.make_array_from_callback`` (``device_put`` to non-addressable
    devices is invalid there). The halo plan builders route every leaf
    through this, so the same plan code runs 1-process CPU/GPU meshes and
    N-host clusters unchanged.
    """
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    x = np.asarray(x)
    return jax.make_array_from_callback(
        x.shape, sharding, lambda idx: x[idx]
    )
