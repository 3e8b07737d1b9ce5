"""Node reordering for tile locality (host-side, cold-path preprocessing).

The reference heals GPU load imbalance *after the fact*: `partition_csr`
splits rows into 32-edge chunks and atomics absorb the resulting write
conflicts (part_csr.py:13-27, atomic.cuh). This design moves the work to
layout time instead: renumber nodes so that densely-connected node groups
(connected components, communities, attention blocks) land inside single
tiles. On the reference's own benchmark workload — 512 disjoint 30-node
cliques (wrapper.py:79-101) — component-aligned numbering with tile 128
collapses the block-sparse tiling from ~344 straddling tiles at 8%
density to 128 diagonal tiles at 22% density, i.e. ~2.6× fewer tile
bytes for every tiled op, with zero change in op semantics.

Everything here is numpy on host: reordering is done once per graph, like
the reference's cached index preprocessing (wrapper.py:114-116).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def connected_components(src, dst, n_nodes: int) -> np.ndarray:
    """Weakly-connected component label per node (union-find, host-side).

    Uses the native C++ union-find (csrc/graphcore.cpp) when built — the
    Python loop below is the exact fallback (fine to ~1M edges, hours at
    papers100M scale).
    """
    from custom_op_benchmark_tpu.graph import native as _native

    labels = _native.connected_components_native(src, dst, n_nodes)
    if labels is not None:
        return labels.astype(np.int64)
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:      # path compression
            parent[x], x = root, parent[x]
        return root

    for u, v in zip(np.asarray(src).tolist(), np.asarray(dst).tolist()):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    # Flatten to roots.
    labels = np.empty(n_nodes, dtype=np.int64)
    for i in range(n_nodes):
        labels[i] = find(i)
    return labels


@dataclasses.dataclass(frozen=True)
class Reordering:
    """A node renumbering old → new (possibly with padding gaps).

    ``perm[i]`` is node ``i``'s new id; new ids not hit by any old node are
    padding slots (isolated in the reordered graph). Apply to node tensors
    with :meth:`scatter_nodes` / undo with :meth:`gather_nodes`.
    """

    perm: np.ndarray          # (n_old,) int32, injective into [0, n_new)
    n_new: int
    n_old: int

    def scatter_nodes(self, x):
        """(n_old, ...) → (n_new, ...) in the new numbering (pads zero)."""
        import jax.numpy as jnp

        out = jnp.zeros((self.n_new,) + tuple(x.shape[1:]), x.dtype)
        return out.at[jnp.asarray(self.perm)].set(x)

    def gather_nodes(self, y):
        """(n_new, ...) → (n_old, ...) back in the original numbering."""
        import jax.numpy as jnp

        return y[jnp.asarray(self.perm)]


def tile_aligned_order(g, block: int = 128,
                       labels: np.ndarray = None) -> Reordering:
    """Renumber nodes so node groups never straddle ``block`` boundaries.

    Groups default to weakly-connected components; pass ``labels`` to align
    on any other grouping (METIS parts, attention blocks, communities).
    Groups larger than ``block`` are laid out contiguously (they straddle
    regardless). First-fit in order of each group's smallest node id, with
    padding inserted at block boundaries — the bin-packing inverse of the
    reference's row chunking.
    """
    import jax

    src = np.asarray(jax.device_get(g.src))[: g.n_edges]
    dst = np.asarray(jax.device_get(g.dst))[: g.n_edges]
    n = g.n_nodes
    if labels is None:
        labels = connected_components(src, dst, n)

    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    # Group boundaries in the sorted view.
    starts = np.flatnonzero(
        np.r_[True, sorted_labels[1:] != sorted_labels[:-1]]
    )
    sizes = np.diff(np.r_[starts, n])

    perm = np.empty(n, dtype=np.int32)
    cursor = 0
    for s0, sz in zip(starts.tolist(), sizes.tolist()):
        if sz <= block and (cursor % block) + sz > block:
            cursor = ((cursor + block - 1) // block) * block
        perm[order[s0: s0 + sz]] = np.arange(
            cursor, cursor + sz, dtype=np.int32
        )
        cursor += sz
    n_new = ((cursor + block - 1) // block) * block
    return Reordering(perm=perm, n_new=int(n_new), n_old=n)


def degree_balanced_order(g, num_parts: int) -> Reordering:
    """Renumber nodes so the ``num_parts`` contiguous owner ranges of the
    halo plan get near-identical degree DISTRIBUTIONS (not just sums).

    The halo plan's per-shard ELL packings are shared-shape across shards
    (every shard pads to the max bucket — parallel/halo.py ``_pack_shared``),
    so the padded-compute waste at P shards is set by the WORST shard's
    degree profile. On locality-free power-law graphs (where
    ``cluster_order`` finds nothing to exploit) the plan's padded-slot
    waste grows with P (1.1→1.8 from the host-side plan statistics), and
    degree-bucket imbalance is the scaling tax. This is the fix at layout
    time, the same move the reference
    makes one level down with 32-edge row chunks (part_csr.py:13-27):
    sort nodes by in-degree (out-degree tiebreak) and serpentine-deal them
    across shards — shard ``pos`` on even rounds, ``P-1-pos`` on odd — so
    each shard's sorted degree sequence matches every other's to within
    one node at every rank. Within a shard, nodes stay degree-sorted,
    which also tightens the per-shard bucket ladder.

    Trade-off: striping destroys locality, so only use where there is
    none to destroy (random power-law graphs) or after confirming the
    halo volume is not the binding term.
    """
    import jax

    src = np.asarray(jax.device_get(g.src))[: g.n_edges].astype(np.int64)
    dst = np.asarray(jax.device_get(g.dst))[: g.n_edges].astype(np.int64)
    n = g.n_nodes
    p = int(num_parts)
    n_per = -(-n // p)
    deg_in = np.bincount(dst, minlength=n)
    deg_out = np.bincount(src, minlength=n)
    # Descending in-degree, out-degree tiebreak, id for determinism.
    order = np.lexsort((np.arange(n), -deg_out, -deg_in))
    ranks = np.arange(n, dtype=np.int64)
    rounds, pos = ranks // p, ranks % p
    shard = np.where(rounds % 2 == 0, pos, p - 1 - pos)
    local = rounds                      # rank within shard == round number
    perm = np.empty(n, dtype=np.int32)
    perm[order] = (shard * n_per + local).astype(np.int32)
    return Reordering(perm=perm, n_new=int(p * n_per), n_old=n)


def reorder_graph(g, ro: Reordering):
    """Apply ``ro`` to ``g``. Returns ``(new_graph, edge_perm)`` where
    ``edge_perm[k]`` is the old canonical edge id of the new graph's k-th
    canonical edge — permute edge tensors with ``edata[edge_perm]``.

    The new graph has ``ro.n_new`` nodes (extra ids are isolated padding
    nodes); canonical order is re-derived because node renumbering changes
    the (src, dst) sort.
    """
    import jax

    from custom_op_benchmark_tpu.graph.graph import from_coo

    src = np.asarray(jax.device_get(g.src))[: g.n_edges].astype(np.int64)
    dst = np.asarray(jax.device_get(g.dst))[: g.n_edges].astype(np.int64)
    new_src = ro.perm[src]
    new_dst = ro.perm[dst]
    edge_perm = np.lexsort((new_dst, new_src)).astype(np.int32)
    g2 = from_coo(
        new_src, new_dst, n_nodes=ro.n_new,
        pad_to=g.num_edges_padded if g.has_padding else None,
    )
    return g2, edge_perm
