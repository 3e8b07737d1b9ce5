"""Worker for the two-real-process distributed test (round-2 verdict #4).

Launched twice by tests/test_multiprocess.py with
``jax.distributed.initialize`` on CPU (4 fake devices per process →
8 global). Exercises, across REAL process boundaries:

  - make_mesh over the global device list;
  - process_row_range + sharded_node_array with a memmap loader (each
    process reads ONLY its own row range — asserted);
  - halo plan construction (put_sharded → make_array_from_callback in
    multi-process mode) and one halo-ELL attention train step with
    gradients;
  - a sharded ``.npz`` checkpoint save + restore round trip.

Prints machine-checkable lines the parent test parses.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

import numpy as np  # noqa: E402


def main():
    pid = int(sys.argv[1])
    port = sys.argv[2]
    workdir = sys.argv[3]

    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4

    from custom_op_benchmark_tpu.data.distributed import (
        memmap_rows,
        process_row_range,
        sharded_node_array,
    )
    from custom_op_benchmark_tpu.graph import random_graph
    from custom_op_benchmark_tpu.parallel import (
        halo_attention_ell,
        halo_ell,
        halo_graph,
        make_mesh,
    )

    mesh = make_mesh((8,), ("edge",))

    # --- per-process feature loading (memmap row shards) ---
    g = random_graph(96, 800, seed=2, power_law=True)  # same on both
    hg = halo_graph(g, mesh)
    n_pad = hg.n_pad
    feat_path = os.path.join(workdir, "feats.npy")

    lo, hi = process_row_range(n_pad, mesh, "edge")
    assert hi - lo == n_pad // 2, (lo, hi, n_pad)
    assert lo == pid * (n_pad // 2), (pid, lo)
    print(f"ROWRANGE {pid} {lo} {hi}", flush=True)

    calls = []
    base_loader = memmap_rows(feat_path)

    def loader(a, b):
        calls.append((a, b))
        return base_loader(a, b)

    d = 8
    x = sharded_node_array(loader, n_pad, (d,), mesh, axis="edge")
    assert calls and all(a >= lo and b <= hi for a, b in calls), calls
    print(f"LOADED {pid} {calls}", flush=True)

    # --- halo-ELL attention step with gradients across 2 processes ---
    he = halo_ell(hg, mesh)

    # Plan views are jit ARGUMENTS: in multi-process runs, closing over
    # globally-sharded arrays is invalid.
    @jax.jit
    def step(hg, he, x):
        y = halo_attention_ell(hg, he, mesh, x, x, x)
        return (y ** 2).sum()

    loss, gx = jax.value_and_grad(step, argnums=2)(hg, he, x)
    from jax.experimental import multihost_utils

    # loss/gnorm are replicated but span non-addressable devices; read
    # the local replica. The parent test asserts the two processes
    # printed the SAME loss (true cross-process agreement check).
    def local_scalar(a):
        return float(np.asarray(a.addressable_shards[0].data))

    gnorm = jax.jit(lambda g: (g ** 2).sum())(gx)
    print(f"STEP {pid} loss={local_scalar(loss):.6f} "
          f"gnorm={local_scalar(gnorm):.6f}", flush=True)

    # --- sharded checkpoint save/restore round trip ---
    from custom_op_benchmark_tpu.train.checkpoint import (
        restore_pytree,
        save_pytree,
    )

    ckpt_dir = os.path.join(workdir, "ckpt")
    save_pytree(ckpt_dir, {"x": x, "gx": gx})
    multihost_utils.sync_global_devices("ckpt_saved")

    # The live arrays serve as the template: restore takes structure,
    # shapes and shardings from it, values only from the files.
    restored = restore_pytree(ckpt_dir, {"x": x, "gx": gx})
    for k_ in ("x", "gx"):
        a = restored[k_]
        b = {"x": x, "gx": gx}[k_]
        assert a.sharding == b.sharding
        for sa, sb in zip(a.addressable_shards, b.addressable_shards):
            np.testing.assert_allclose(np.asarray(sa.data),
                                       np.asarray(sb.data))
    print(f"CKPT {pid} ok", flush=True)
    print(f"PASS {pid}", flush=True)


if __name__ == "__main__":
    main()
