"""Graph diagnostics + execution-strategy advisor.

`describe(g)` reports the structural statistics that determine which
execution strategy wins, and recommends one:

- dense_block: every component fits a dense (B, L, L) block — batched
  dense matmuls moving exactly the ideal bytes;
- ell: everything else — degree-bucketed, scatter-free fused ops.

The tiled (BSR) strategy stays callable with ``impl="tiled"`` but is not
recommended: on the H100 ELL beat it on the locality-rich 1024² grid, its
home regime, for SpMM, SDDMM and fused attention, forward and gradient
(PERF.md). ``tile_density_128`` is still reported.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphSummary:
    n_nodes: int
    n_edges: int
    avg_degree: float
    max_in_degree: int
    max_out_degree: int
    num_components: int
    max_component: int
    tile_density_128: float        # occupied-slot fraction of 128² tiles
    recommended: str

    def __str__(self):
        return (
            f"Graph(n={self.n_nodes}, e={self.n_edges}, "
            f"avg_deg={self.avg_degree:.1f}, "
            f"max_deg_in/out={self.max_in_degree}/{self.max_out_degree}, "
            f"components={self.num_components} "
            f"(max {self.max_component}), "
            f"tile128_density={self.tile_density_128:.3f}) "
            f"→ strategy: {self.recommended}"
        )


def describe(g, max_block: int = 128) -> GraphSummary:
    """Structural summary + recommended execution strategy for ``g``."""
    import jax

    from custom_op_benchmark_tpu.graph.reorder import connected_components

    n, e = g.n_nodes, g.n_edges
    src = np.asarray(jax.device_get(g.src))[:e]
    dst = np.asarray(jax.device_get(g.dst))[:e]
    out_deg = np.bincount(src, minlength=n) if e else np.zeros(n, int)
    in_deg = np.bincount(dst, minlength=n) if e else np.zeros(n, int)
    labels = connected_components(src, dst, n)
    _, counts = np.unique(labels, return_counts=True)
    max_comp = int(counts.max()) if counts.size else 0

    # Occupied 128² tiles: the BSR sweep's unit of work.
    keys = (src.astype(np.int64) // 128) * ((n // 128) + 1) + dst // 128
    t = len(np.unique(keys)) if e else 0
    dens = e / max(t * 128 * 128, 1)

    if max_comp <= max_block and counts.size:
        # A single <=max_block-node component is one dense block — still
        # the dense_block regime (block_graph handles B=1 fine).
        rec = "dense_block"
    else:
        rec = "ell"
    return GraphSummary(
        n_nodes=n,
        n_edges=e,
        avg_degree=e / max(n, 1),
        max_in_degree=int(in_deg.max()) if n else 0,
        max_out_degree=int(out_deg.max()) if n else 0,
        num_components=int(counts.size),
        max_component=max_comp,
        tile_density_128=float(dens),
        recommended=rec,
    )
