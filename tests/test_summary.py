"""Strategy advisor diagnostics."""

import numpy as np

from custom_op_benchmark_tpu.graph import clique_batch, random_graph
from custom_op_benchmark_tpu.utils.summary import describe


def test_describe_clique():
    s = describe(clique_batch(8, 10))
    assert s.n_nodes == 80 and s.n_edges == 800
    assert s.num_components == 8 and s.max_component == 10
    assert s.recommended == "dense_block"
    assert "dense_block" in str(s)


def test_describe_powerlaw():
    s = describe(random_graph(5000, 20000, seed=0, power_law=True))
    assert s.max_out_degree >= 50        # heavy tail present
    assert s.recommended == "ell"


def test_describe_grid_recommends_tiled():
    """The advisor follows the measured winner on the locality-rich 2-D
    grid (round-3 verdict #5), tiled's home regime: on the H100, ELL beat
    the tiled strategy there for SpMM, SDDMM and fused attention
    (PERF.md), so describe routes grids to ELL and never recommends
    tiled."""
    from custom_op_benchmark_tpu.graph import grid_graph

    s = describe(grid_graph(64, 64))
    assert s.recommended == "ell", s.recommended
    assert s.tile_density_128 > 0
