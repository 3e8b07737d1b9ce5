"""Two REAL processes under jax.distributed (round-2 verdict #4).

Every other "multi-host" test in this suite runs one process with 8 fake
devices, where ``process_row_range`` degenerates to the full range. This
test launches two actual OS processes (4 fake CPU devices each) through
``jax.distributed.initialize``, so the multi-process branches of
``data/distributed.py`` and ``parallel/mesh.put_sharded`` execute for
real: per-process memmap row loading, halo plan construction via
``make_array_from_callback``, a cross-process halo-ELL gradient step,
and a sharded ``.npz`` checkpoint round trip.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_real_processes(tmp_path):
    # Shared feature file both workers memmap their own rows from.
    # n_pad for the worker's graph/mesh is computed inside the worker;
    # make the file comfortably large so any padded range is readable.
    rng = np.random.default_rng(0)
    np.save(tmp_path / "feats.npy",
            rng.normal(size=(256, 8)).astype(np.float32))

    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multiproc_worker.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"PASS {i}" in out, out
    # Both processes computed the same (replicated) loss.
    losses = []
    for out in outs:
        for line in out.splitlines():
            if line.startswith("STEP"):
                losses.append(float(line.split("loss=")[1].split()[0]))
    assert len(losses) == 2 and abs(losses[0] - losses[1]) < 1e-3, losses
    # Each process loaded ONLY its own half of the rows.
    for i, out in enumerate(outs):
        assert f"ROWRANGE {i}" in out, out
