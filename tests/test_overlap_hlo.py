"""Pin the structural overlap property the scaling projection credits
(round-4 verdict item 3a).

``eff_overlap`` in utils/bench_scaling.py assumes the halo all_to_all
runs concurrently with the interior bucket sweeps. The compiler-level
precondition is checked here on the compiled (scheduled) HLO of the
8-fake-device CPU mesh: the interior score dots carry NO dependency
edge to the exchange, and the scheduler places independent compute
inside the collective's window (between the all-to-all and its first
consumer). An async collective scheduler gets exactly the same freedom
from the same dependency structure (start/done pairs stretch over the
independent compute). Full-size artifact: scripts/exp_overlap_evidence.py
→ chiprun_out/overlap_evidence.json.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

from exp_overlap_evidence import analyze, entry_schedule  # noqa: E402

from custom_op_benchmark_tpu.graph import random_graph
from custom_op_benchmark_tpu.parallel import (
    halo_ell, halo_graph, make_mesh, shard_halo_nodes,
)
from custom_op_benchmark_tpu.parallel.halo import halo_attention_ell


@pytest.fixture(scope="module")
def compiled_case():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh((8,), ("edge",))
    g = random_graph(1024, 8192, seed=0, power_law=True)
    hg = halo_graph(g, mesh)
    he = halo_ell(hg, mesh)
    d = 16
    x = np.random.default_rng(0).normal(
        size=(hg.n_pad, d)).astype(np.float32)
    xs = shard_halo_nodes(hg, mesh, jnp.asarray(x))
    fwd = jax.jit(lambda q: halo_attention_ell(hg, he, mesh, q, q, q))
    bwd = jax.jit(jax.grad(
        lambda q: (halo_attention_ell(hg, he, mesh, q, q, q) ** 2).sum()))
    return fwd, bwd, xs


def _collectives(fn, xs):
    txt = fn.lower(xs).compile().as_text()
    sched = entry_schedule(txt)
    assert len(sched) > 10, "entry schedule parse came back empty"
    return analyze(sched)


def test_forward_exchange_overlaps_interior(compiled_case):
    fwd, _, xs = compiled_case
    res = _collectives(fwd, xs)
    assert res, "forward lost its all-to-all"
    a2a = res[0]
    # Interior sections independent of the exchange exist...
    assert a2a["dots_independent"] > 0
    # ...and the scheduler actually placed independent compute in the
    # collective's window.
    assert a2a["indep_compute_between"] > 0


def test_backward_has_reverse_exchange_and_overlap(compiled_case):
    _, bwd, xs = compiled_case
    res = _collectives(bwd, xs)
    # Forward k/v exchange (recompute path) + reverse dk||dv exchange.
    assert len(res) >= 2
    assert any(r["dots_independent"] > 0 and
               r["indep_compute_between"] > 0 for r in res), (
        "no collective in the backward has independent compute "
        "scheduled in its window")
