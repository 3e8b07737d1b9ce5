"""ELL packing: degree-bucketed, row-owned edge layout for general graphs.

The third execution strategy (after dense blocks and BSR tiles), covering
graphs with power-law degrees and no locality — the regime where the
reference's `partition_csr` + atomics design pays most (part_csr.py,
atomic.cuh). The inversion here:

- rows are grouped into **degree buckets**; bucket ``b`` stores its rows'
  edges as a dense ``(rows_b, D_b)`` index matrix padded with a dummy
  node — the classic ELLPACK layout, power-of-two widths bounding the
  padding waste;
- every row lives in exactly one packed row ⇒ node outputs are assembled
  with a pure **gather** through the precomputed inverse permutation
  ``row_pos`` — every scatter in the op family is replaced by a gather
  through a host-precomputed inverse index (this layout was first tuned
  on hardware where scatter ran two orders of magnitude slower than row
  gather; whether that holds on the GPU is an open question);
- canonical-edge-order results are likewise assembled by gathering
  through ``edge_pos`` (canonical eid → flattened slot position);
- segment softmax is a *dense masked* softmax over the width axis;
- the backward pass runs the forward sweeps over the transpose packing —
  the reference's dual-CSR trick (graphop_kernel.cu:355-409) at the
  layout level.

All packing is host-side numpy (cold path, cache with the graph).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from custom_op_benchmark_tpu.graph.graph import Graph

# Power-of-two bucket widths bound padding waste to <2x (expected ~1.4x)
# on power-law degree distributions. ell_pack extends this list upward
# automatically to cover the max degree, so rows are never split.
DEFAULT_WIDTHS = (4, 8, 16, 32, 64, 128, 256, 512, 1024)

# Training-profile ladder: the finer ladder trims ELL padding on a 2M-edge
# power-law graph from 1.52/1.65 to 1.16/1.43 (dst/src packing; a count,
# not a time). Forward-only sweeps pay more per-bucket overhead and odd
# einsum widths, while gradient steps are dominated by slot-row counts
# (wide gathers + the row-bound twin hop), which pad trim cuts directly.
# Use via ``ell_dual(g, profile="train")`` for training loops; the pow-2
# default is for inference-style forward-heavy use.
TRAIN_WIDTHS = tuple(range(4, 65, 4)) + (96, 128, 192, 256, 384, 512,
                                         768, 1024)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllBucket:
    """Rows whose degree fits width D, edges padded to (num_rows, D)."""

    rows: jax.Array    # (R,) int32 — owner node of each packed row
    cols: jax.Array    # (R, D) int32 — neighbor per slot; pad = n_nodes
    eid: jax.Array     # (R, D) int32 — canonical edge id; pad = E (scratch)
    width: int = dataclasses.field(metadata=dict(static=True))
    num_rows: int = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Degree-bucketed ELL view of one traversal direction of a Graph.

    ``direction="src"`` packs out-edges by row-CSR (aggregation target =
    src, reference CSR semantics); ``"dst"`` packs in-edges by CSC.

    Inverse permutations (the scatter killers):
      row_pos:  (n_nodes,) int32 — packed-row index of each node in the
                bucket-concatenation order; ``total_rows`` for
                zero-degree nodes (points at an appended zeros row).
      edge_pos: (E_pad,) int32 — flattened slot position of each
                canonical edge in the concatenation of per-bucket
                ``(R·D,)`` flats; ``total_slots`` for padded edges.
    """

    buckets: List[EllBucket]
    row_pos: jax.Array
    edge_pos: jax.Array
    n_nodes: int = dataclasses.field(metadata=dict(static=True))
    n_edges: int = dataclasses.field(metadata=dict(static=True))
    num_edges_padded: int = dataclasses.field(metadata=dict(static=True))
    direction: str = dataclasses.field(metadata=dict(static=True))
    total_rows: int = dataclasses.field(metadata=dict(static=True))
    total_slots: int = dataclasses.field(metadata=dict(static=True))
    # Optional direct cross-packing permutation (filled by ops.ell_dual):
    # twin_slot[i][r, k] = flattened slot position, in the TWIN packing's
    # concatenation order, of the edge at this packing's bucket-i slot
    # (r, k); padding slots point at the twin's zero slot. Lets backward
    # passes move packed edge tensors between the dual packings with ONE
    # gather instead of a canonical round trip.
    twin_slot: Optional[List[jax.Array]] = None

    @property
    def padding_waste(self) -> float:
        """Total padded slots / real edges (layout efficiency metric)."""
        return self.total_slots / max(self.n_edges, 1)


def _ell_from_native(res, widths, n, e, e_pad, direction):
    """Assemble an EllGraph from graphcore_ell_pack's flat outputs."""
    bucket_rows, rows_flat, cols_flat, eid_flat, row_pos, edge_pos = res
    buckets = []
    row_off = slot_off = 0
    for w, r_pad in zip(widths, bucket_rows.tolist()):
        if r_pad == 0:
            continue
        slots = r_pad * w
        buckets.append(EllBucket(
            rows=jnp.asarray(rows_flat[row_off: row_off + r_pad]),
            cols=jnp.asarray(
                cols_flat[slot_off: slot_off + slots].reshape(r_pad, w)),
            eid=jnp.asarray(
                eid_flat[slot_off: slot_off + slots].reshape(r_pad, w)),
            width=int(w),
            num_rows=int(r_pad),
        ))
        row_off += r_pad
        slot_off += slots
    if slot_off >= 2 ** 31:
        raise ValueError("ELL slot space exceeds int32 indexing")
    return EllGraph(
        buckets=buckets,
        row_pos=jnp.asarray(row_pos),
        edge_pos=jnp.asarray(edge_pos.astype(np.int32)),
        n_nodes=n,
        n_edges=e,
        num_edges_padded=e_pad,
        direction=direction,
        total_rows=int(row_off),
        total_slots=int(slot_off),
    )


def ell_pack(g: Graph, *, direction: str = "src",
             widths: Tuple[int, ...] = DEFAULT_WIDTHS,
             row_pad: int = 8) -> EllGraph:
    """Pack one traversal direction of ``g`` into degree buckets.

    Rows with degree 0 are dropped (their output rows read an appended
    zeros row through ``row_pos``). ``widths`` is extended by doubling
    until it covers the max degree — rows are never split, so dense
    per-row reductions (softmax) are always whole-segment.
    """
    if direction == "src":
        indptr = np.asarray(jax.device_get(g.indptr_r))[: g.n_nodes + 1]
        cols_all = np.asarray(jax.device_get(g.dst))
        eids_all = np.arange(g.num_edges_padded, dtype=np.int64)
    elif direction == "dst":
        indptr = np.asarray(jax.device_get(g.indptr_c))[: g.n_nodes + 1]
        # NOT g.src_csc: that property runs a jnp gather, which STAGES
        # under an enclosing jit trace even on concrete arrays
        # (omnistaging) and poisons this host-side cold path when a
        # public op builds its view lazily inside a traced function.
        cols_all = np.asarray(jax.device_get(g.src))[
            np.asarray(jax.device_get(g.csc_perm))
        ]
        eids_all = np.asarray(jax.device_get(g.csc_perm)).astype(np.int64)
    else:
        raise ValueError(f"direction must be 'src'/'dst', got {direction!r}")

    n, e = g.n_nodes, g.n_edges
    e_pad = g.num_edges_padded
    deg = np.diff(indptr).astype(np.int64)
    widths = sorted(set(int(w) for w in widths))
    max_deg = int(deg.max()) if len(deg) else 0
    while widths[-1] < max_deg:
        widths.append(widths[-1] * 2)

    # Native C++ fast path (csrc/graphcore.cpp graphcore_ell_pack) — the
    # vectorized-numpy fallback below is exact but ~3× slower; at 1B+
    # edges this cold path stops being cold.
    from custom_op_benchmark_tpu.graph import native as _native

    if e > 0:
        res = _native.ell_pack_native(
            indptr, cols_all, eids_all, n, e_pad, widths, row_pad
        )
        if res is not None:
            return _ell_from_native(res, widths, n, e, e_pad, direction)

    buckets = []
    row_pos = np.full(n, -1, dtype=np.int64)
    edge_pos = np.full(e_pad, -1, dtype=np.int64)
    row_base = 0
    slot_base = 0
    w_lo = 0
    for w in widths:
        sel = np.nonzero((deg > w_lo) & (deg <= w))[0]
        w_lo = w
        r = len(sel)
        if r == 0:
            continue
        r_pad = -(-r // row_pad) * row_pad
        cols = np.full((r_pad, w), n, dtype=np.int32)
        eid = np.full((r_pad, w), e_pad, dtype=np.int32)
        rows = np.full(r_pad, n, dtype=np.int32)
        rows[:r] = sel
        # Vectorized fill: slot (j, k) <- edge indptr[sel[j]] + k, k<deg.
        k = np.arange(w)
        lens = deg[sel]
        mask = k[None, :] < lens[:, None]
        flat_eids = (indptr[sel][:, None] + k[None, :])[mask]
        jj, kk = np.nonzero(mask)
        cols[jj, kk] = cols_all[flat_eids]
        eid[jj, kk] = eids_all[flat_eids]
        row_pos[sel] = row_base + np.arange(r)
        edge_pos[eids_all[flat_eids]] = slot_base + jj * w + kk
        buckets.append(EllBucket(
            rows=jnp.asarray(rows),
            cols=jnp.asarray(cols),
            eid=jnp.asarray(eid),
            width=int(w),
            num_rows=int(r_pad),
        ))
        row_base += r_pad
        slot_base += r_pad * w

    row_pos[row_pos < 0] = row_base
    edge_pos[edge_pos < 0] = slot_base
    if slot_base >= 2 ** 31:
        # edge_pos is downcast to int32 below; this layout cannot
        # represent >2^31 slots — fail loudly (same guard as the C++
        # packer's -3 return) instead of truncating indices.
        raise ValueError("ELL slot space exceeds int32 indexing")
    return EllGraph(
        buckets=buckets,
        row_pos=jnp.asarray(row_pos.astype(np.int32)),
        edge_pos=jnp.asarray(edge_pos.astype(np.int32)),
        n_nodes=n,
        n_edges=e,
        num_edges_padded=e_pad,
        direction=direction,
        total_rows=int(row_base),
        total_slots=int(slot_base),
    )
