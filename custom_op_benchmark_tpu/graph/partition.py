"""Load-balancing and multi-chip partitioning of graphs.

Reference parity: ``partition_csr`` reproduces the contract of the
reference's row-chunking preprocessor (part_csr.py:13-27) — split every CSR
row into chunks of at most ``chunk_size`` edges, emitting a per-chunk owner
row array — which the reference uses to keep one GPU thread block from
owning an unbounded-degree row (and then needs atomics to heal, atomic.cuh).

Redesign: the same chunking idea appears at two scales —

- **intra-device**: fixed-size, tile-aligned edge blocks.
  Because edges are canonical-sorted by row, a fixed-size block covers a
  contiguous run of rows; per-block partial sums are combined by a second
  (tiny) segment reduction instead of atomics. Metadata for that is
  :func:`edge_block_rows`.
- **inter-device**: :func:`edge_partition` splits the edge set into ``P``
  contiguous, equally-padded shards (the ``shard_map`` data layout), with
  per-shard row ranges so cross-shard segment reductions touch only
  boundary rows.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from custom_op_benchmark_tpu.graph.graph import Graph, _round_up


def partition_csr(indptr, chunk_size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Split CSR rows into chunks of at most ``chunk_size`` edges.

    Same contract as the reference preprocessor (part_csr.py:13-27): returns
    ``(row, chunk_indptr)`` where chunk ``i`` owns edges
    ``chunk_indptr[i]:chunk_indptr[i+1]`` of row ``row[i]``. Vectorised
    numpy (the reference is a Python loop with a device round-trip).
    """
    indptr = np.asarray(indptr)
    deg = np.diff(indptr).astype(np.int64)
    n_chunks_per_row = np.maximum((deg + chunk_size - 1) // chunk_size, 0)
    total = int(n_chunks_per_row.sum())
    row = np.repeat(np.arange(len(deg), dtype=np.int32), n_chunks_per_row)
    # Offsets of each chunk inside its row: 0, cs, 2cs, ...
    first_chunk = np.zeros(len(deg) + 1, dtype=np.int64)
    np.cumsum(n_chunks_per_row, out=first_chunk[1:])
    within = np.arange(total, dtype=np.int64) - first_chunk[row]
    starts = indptr[:-1][row] + within * chunk_size
    ends = np.minimum(starts + chunk_size, indptr[1:][row])
    chunk_indptr = np.empty(total + 1, dtype=np.int32)
    chunk_indptr[0] = indptr[0]
    chunk_indptr[1:] = ends
    assert np.all(starts == chunk_indptr[:-1]), "rows must be contiguous"
    return row, chunk_indptr


def edge_block_rows(indptr, block_size: int) -> np.ndarray:
    """First row touched by each fixed-size edge block.

    For edges sorted by row, block ``b`` covers edges
    ``[b*block_size, (b+1)*block_size)`` and rows
    ``[block_first_row[b], block_first_row[b+1]]`` (inclusive end —
    blocks may share boundary rows; the combiner pass resolves those).
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    e = int(indptr[-1])
    n_blocks = max(1, -(-e // block_size))
    starts = np.arange(n_blocks + 1, dtype=np.int64) * block_size
    starts = np.minimum(starts, e)
    # block_first_row[b] = last row r with indptr[r] <= starts[b], clamped
    # to a real row (the end sentinel otherwise lands past the last row).
    first = np.searchsorted(indptr, starts, side="right") - 1
    return np.minimum(first, len(indptr) - 2).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """Host-side plan for sharding a graph's edges over ``P`` devices.

    Each shard holds an equal (padded) count of canonically-contiguous
    edges; since the canonical order is row-sorted, each shard's src rows
    form a contiguous range ``[row_lo[p], row_hi[p]]`` and only rows shared
    between neighbouring shards need cross-device reduction.
    """

    num_parts: int
    edges_per_part: int        # padded, equal across parts
    # (P, edges_per_part) int32; padded entries = n_nodes
    src: np.ndarray
    dst: np.ndarray
    eid: np.ndarray            # canonical edge id per slot (n_edges = pad)
    row_lo: np.ndarray         # (P,) first src row owned/touched
    row_hi: np.ndarray         # (P,) last src row touched (inclusive)
    n_nodes: int
    n_edges: int


def edge_partition(g: Graph, num_parts: int,
                   pad_multiple: int = 8) -> EdgePartition:
    """Split ``g``'s canonical edge list into ``num_parts`` balanced shards.

    Generalizes the reference's ``partition_csr`` chunking (part_csr.py) from
    thread blocks to devices: contiguous edge ranges, equal padded sizes,
    boundary rows resolved by a cross-device ``psum``-style reduction in the
    distributed ops (parallel/shard_ops.py).
    """
    import jax

    src = np.asarray(jax.device_get(g.src))[: g.n_edges]
    dst = np.asarray(jax.device_get(g.dst))[: g.n_edges]
    e = g.n_edges
    per = _round_up(max(-(-e // num_parts), 1), pad_multiple)
    src_s = np.full((num_parts, per), g.n_nodes, dtype=np.int32)
    dst_s = np.full((num_parts, per), g.n_nodes, dtype=np.int32)
    eid_s = np.full((num_parts, per), e, dtype=np.int32)
    row_lo = np.zeros(num_parts, dtype=np.int32)
    row_hi = np.zeros(num_parts, dtype=np.int32)
    for p in range(num_parts):
        lo = min(p * (e // num_parts) + min(p, e % num_parts), e)
        hi = min(lo + e // num_parts + (1 if p < e % num_parts else 0), e)
        cnt = hi - lo
        src_s[p, :cnt] = src[lo:hi]
        dst_s[p, :cnt] = dst[lo:hi]
        eid_s[p, :cnt] = np.arange(lo, hi, dtype=np.int32)
        row_lo[p] = src[lo] if cnt else g.n_nodes
        row_hi[p] = src[hi - 1] if cnt else g.n_nodes
    return EdgePartition(
        num_parts=num_parts,
        edges_per_part=per,
        src=src_s,
        dst=dst_s,
        eid=eid_s,
        row_lo=row_lo,
        row_hi=row_hi,
        n_nodes=g.n_nodes,
        n_edges=e,
    )
