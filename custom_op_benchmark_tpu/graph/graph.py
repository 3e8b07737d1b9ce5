"""The core Graph container: canonical edge order + dual CSR/CSC views.

Reference parity (do-what, not do-how): the reference builds a row CSR and a
column CSR over the same edge set, with ``eid_r``/``eid_c`` arrays mapping
each CSR position back to a *canonical edge id* so edge tensors live in one
canonical order regardless of traversal direction
(reference: wrapper.py:84-116).

Redesign for XLA:

- The **canonical edge order is the row-sorted (CSR) order** — edges sorted
  by ``(src, dst)``. This makes ``eid_r`` the identity (it is never stored)
  and lets every segment reduction over ``src`` use
  ``indices_are_sorted=True``.
- ``csc_perm`` plays the role of the reference's ``eid_c``: position ``k`` of
  the column-sorted (CSC) view is canonical edge ``csc_perm[k]``. Its inverse
  is precomputed so the transpose graph (needed by every backward pass —
  reference: graphop_kernel.cu:355-409, 544-600) is available without any
  device-side sorting.
- Indices are **int32** (the reference hard-codes int64 — graphop.cpp;
  int32 halves index bandwidth).
- Shapes are **static**: the edge arrays may be padded to a tile-friendly
  length. Padded edges point at a *dummy node* ``n_nodes`` so that gathers
  clamp harmlessly and scatter contributions land in a dummy segment that is
  sliced off. ``indptr`` therefore has ``n_nodes + 2`` entries, the last
  segment holding the padding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Graph:
    """A static-shape directed graph in canonical (row-sorted) edge order.

    Leaves (device arrays):
      src:       (E,) int32 — source node of each edge, canonical order;
                 sorted ascending. Padded tail = n_nodes.
      dst:       (E,) int32 — destination node, canonical order. Padded
                 tail = n_nodes.
      indptr_r:  (n_nodes + 2,) int32 — CSR row pointers over canonical
                 order; slot n_nodes..n_nodes+1 spans the padding.
      csc_perm:  (E,) int32 — canonical eid of the k-th edge in CSC
                 (dst-sorted) order. The reference's ``eid_c``
                 (wrapper.py:110).
      csc_perm_inv: (E,) int32 — inverse permutation: CSC position of
                 canonical edge e.
      indptr_c:  (n_nodes + 2,) int32 — CSC column pointers.

    Static metadata:
      n_nodes:  number of real nodes.
      n_edges:  number of real (unpadded) edges.
    """

    src: jax.Array
    dst: jax.Array
    indptr_r: jax.Array
    csc_perm: jax.Array
    csc_perm_inv: jax.Array
    indptr_c: jax.Array
    n_nodes: int = dataclasses.field(metadata=dict(static=True))
    n_edges: int = dataclasses.field(metadata=dict(static=True))

    # ---- derived views -------------------------------------------------

    @property
    def num_edges_padded(self) -> int:
        return self.src.shape[0]

    @property
    def has_padding(self) -> bool:
        return self.num_edges_padded != self.n_edges

    @property
    def edge_mask(self) -> jax.Array:
        """(E,) bool — True on real edges, False on the padded tail."""
        return (
            jnp.arange(self.num_edges_padded, dtype=jnp.int32) < self.n_edges
        )

    @property
    def src_csc(self) -> jax.Array:
        """Source node per CSC position (the CSC ``indices`` array)."""
        # Padded canonical entries already carry src == n_nodes, so a plain
        # permutation is correct with or without padding.
        return self.src[self.csc_perm]

    @property
    def dst_csc(self) -> jax.Array:
        """Destination node per CSC position; sorted ascending."""
        return self.dst[self.csc_perm]

    def out_degrees(self) -> jax.Array:
        d = jnp.diff(self.indptr_r)
        return d[: self.n_nodes]

    def in_degrees(self) -> jax.Array:
        d = jnp.diff(self.indptr_c)
        return d[: self.n_nodes]

    def reverse(self) -> "Graph":
        """The transpose graph, sharing this graph's canonical edge ids.

        Every backward pass in the op family runs the forward kernel shape
        over the transpose graph (reference: graphop_kernel.cu:398, 586-597);
        this is free here because both CSR orientations are precomputed.

        Note: the reversed graph's canonical order is the *CSC order* of
        this graph, so edge data indexed by this graph's canonical eids must
        be permuted by ``csc_perm`` when used with the reversed graph.
        """
        return Graph(
            src=self.dst_csc,
            dst=self.src_csc,
            indptr_r=self.indptr_c,
            csc_perm=self.csc_perm_inv,
            csc_perm_inv=self.csc_perm,
            indptr_c=self.indptr_r,
            n_nodes=self.n_nodes,
            n_edges=self.n_edges,
        )

    # ---- convenience ---------------------------------------------------

    def __repr__(self) -> str:  # keep pytree printing short
        return (
            f"Graph(n_nodes={self.n_nodes}, n_edges={self.n_edges}, "
            f"padded_to={self.num_edges_padded})"
        )


def from_coo(
    src,
    dst,
    n_nodes: int,
    *,
    pad_multiple: Optional[int] = None,
    pad_to: Optional[int] = None,
    want_host: bool = False,
):
    """Build a :class:`Graph` from COO edge arrays (host-side, cold path).

    Reference parity: the dual-CSR + eid construction loop at
    wrapper.py:84-116, vectorised with numpy and emitting int32/static-shape
    arrays. Duplicate edges are kept (multigraph semantics, like the
    reference's raw edge list).

    Args:
      src, dst: 1-D integer arrays (any integer dtype) of equal length.
      n_nodes: node count; all indices must be in [0, n_nodes).
      pad_multiple: if given, pad the edge arrays up to a multiple of this.
      pad_to: if given, pad the edge arrays to exactly this length.
      want_host: if True, return ``(graph, host)`` where ``host`` is a dict
        of the same six index arrays as host numpy — callers that keep
        building host-side metadata from the structure (the neighbor
        sampler's ``in_cols``) avoid a device round trip.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.ndim != 1 or dst.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"src/dst must be equal-length 1-D, got "
                         f"{src.shape} vs {dst.shape}")
    e = int(src.shape[0])
    if e and (src.min() < 0 or src.max() >= n_nodes
              or dst.min() < 0 or dst.max() >= n_nodes):
        raise ValueError("edge endpoints out of range [0, n_nodes)")

    e_pad = e
    if pad_to is not None:
        if pad_to < e:
            raise ValueError(f"pad_to={pad_to} < n_edges={e}")
        e_pad = pad_to
    if pad_multiple is not None:
        e_pad = _round_up(max(e_pad, 1), pad_multiple)

    # Canonical order: sort by (src, dst). Native C++ fast path when the
    # graphcore library is built (graph/native.py); numpy otherwise.
    native_result = None
    if e > 0:
        from custom_op_benchmark_tpu.graph import native as _native

        try:
            native_result = _native.build_dual_csr(src, dst, n_nodes)
        except ValueError:
            raise
        except Exception:
            native_result = None
    if native_result is not None:
        src_c, dst_c, indptr_r, csc_perm, csc_perm_inv, indptr_c = (
            native_result
        )
        if e_pad != e:
            # Padding extends every array without re-sorting: pad edges
            # carry src = dst = n_nodes, so canonical order appends them
            # at the tail, and a stable dst-sort keeps them at the tail
            # in order — csc_perm/inv extend with the identity. The
            # dummy segment [n_nodes .. n_nodes+1] absorbs them.
            fill = np.full(e_pad - e, n_nodes, dtype=np.int32)
            tail = np.arange(e, e_pad, dtype=np.int32)
            src_c = np.concatenate([src_c, fill])
            dst_c = np.concatenate([dst_c, fill])
            csc_perm = np.concatenate([csc_perm, tail])
            csc_perm_inv = np.concatenate([csc_perm_inv, tail])
            indptr_r = indptr_r.copy()
            indptr_c = indptr_c.copy()
            indptr_r[n_nodes + 1] = e_pad
            indptr_c[n_nodes + 1] = e_pad
    else:
        order = np.lexsort((dst, src))
        src_c = src[order].astype(np.int32)
        dst_c = dst[order].astype(np.int32)
        if e_pad != e:
            fill = np.full(e_pad - e, n_nodes, dtype=np.int32)
            src_c = np.concatenate([src_c, fill])
            dst_c = np.concatenate([dst_c, fill])

        # CSC order over the (padded) canonical arrays: stable sort by
        # dst. Padding (dst == n_nodes) sorts to the end, preserving
        # relative order.
        csc_perm = np.argsort(dst_c, kind="stable").astype(np.int32)
        csc_perm_inv = np.empty_like(csc_perm)
        csc_perm_inv[csc_perm] = np.arange(e_pad, dtype=np.int32)

        # Row/col pointers over n_nodes + 1 segments (last = padding).
        indptr_r = np.zeros(n_nodes + 2, dtype=np.int32)
        np.cumsum(np.bincount(src_c, minlength=n_nodes + 1),
                  out=indptr_r[1:])
        indptr_c = np.zeros(n_nodes + 2, dtype=np.int32)
        np.cumsum(np.bincount(dst_c[csc_perm], minlength=n_nodes + 1),
                  out=indptr_c[1:])

    g = Graph(
        src=jnp.asarray(src_c),
        dst=jnp.asarray(dst_c),
        indptr_r=jnp.asarray(indptr_r),
        csc_perm=jnp.asarray(csc_perm),
        csc_perm_inv=jnp.asarray(csc_perm_inv),
        indptr_c=jnp.asarray(indptr_c),
        n_nodes=int(n_nodes),
        n_edges=e,
    )
    if want_host:
        host = dict(
            src_c=src_c, dst_c=dst_c, indptr_r=indptr_r,
            csc_perm=csc_perm, csc_perm_inv=csc_perm_inv,
            indptr_c=indptr_c,
        )
        return g, host
    return g
