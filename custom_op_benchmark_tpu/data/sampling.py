"""Host-side fanout neighbor sampling → static-shape subgraph minibatches.

The BASELINE.md Reddit config (GraphSAGE, fanout 25/10) needs layered
neighbor sampling. Design: sample the k-hop in-neighborhood union of a seed
batch (fanout per hop), renumber nodes locally, and emit a padded
:class:`Graph` plus feature/label slices — every batch has identical array
shapes, so one XLA program serves the whole epoch (no recompiles).

This is the cold path: pure numpy over the CSC arrays (in-neighbors),
mirroring how the reference keeps all preprocessing host-side
(wrapper.py:84-116, part_csr.py). A C++ fast path can drop in behind the
same interface (graph/native.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import numpy as np

from custom_op_benchmark_tpu.graph.graph import Graph, from_coo, _round_up


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SampledBatch:
    """One minibatch: a padded local subgraph + original node ids.

    ``node_ids[i]`` is the global id of local node ``i`` (padded tail
    repeats node 0 with ``node_mask`` False). The first ``num_seeds``
    local nodes are the seed (output) nodes.
    """

    graph: Graph
    node_ids: np.ndarray       # (max_nodes,) int32, global ids
    node_mask: np.ndarray      # (max_nodes,) bool
    seed_ids: np.ndarray       # (batch_size,) int32 global seed ids
    seed_mask: np.ndarray      # (batch_size,) bool — False on padded seeds
    # Static single-bucket ELL view of the in-neighborhood: fanout
    # sampling bounds every in-degree by max(fanouts)+1 (each node is a
    # sampling target in exactly one hop, +1 self-loop), so ONE dense
    # (max_nodes, W) neighbor matrix covers the whole batch with fixed
    # shapes — the scatter-free aggregation fast path for sampled
    # minibatches (pad slot = max_nodes).
    in_cols: np.ndarray        # (max_nodes, W) int32
    num_seeds: int = dataclasses.field(metadata=dict(static=True))


class NeighborSampler:
    """Layered in-neighbor sampler with per-hop fanouts (e.g. [25, 10])."""

    def __init__(self, g: Graph, fanouts: Sequence[int], *, seed: int = 0,
                 n_threads: int | None = None):
        import jax
        import os

        self.fanouts = list(fanouts)
        if n_threads is None:
            n_threads = int(os.environ.get("GRAPHCORE_THREADS",
                                           os.cpu_count() or 1))
        self.n_threads = max(1, n_threads)
        self.n_nodes = g.n_nodes
        # Keep the CSC arrays int32-contiguous — exactly the layout the
        # native sampler consumes. Holding int64 here made
        # sample_in_edges_native re-cast the FULL indices array (4 B ×
        # e elements, ~94 MB at the Reddit shape) on every hop of every
        # batch — most of the host-sampling cost.
        indptr = np.asarray(jax.device_get(g.indptr_c))[: g.n_nodes + 1]
        self._indptr = np.ascontiguousarray(indptr, np.int32)
        self._indices = np.ascontiguousarray(
            np.asarray(jax.device_get(g.src_csc)), np.int32
        )
        self._rng = np.random.default_rng(seed)
        # Static output shapes: worst-case node/edge counts for this
        # fanout schedule, padded up.
        self.batch_nodes_bound = None  # set per sample() batch size

    def _sample_in_edges(self, seeds: np.ndarray, fanout: int):
        """For each seed, ≤fanout in-edges (u → seed). Returns (src, dst).

        Native C++ reservoir sampler when built (csrc/graphcore.cpp —
        the Python fallback below is the per-step bottleneck, about an
        order of magnitude slower for Reddit-config batches).
        """
        from custom_op_benchmark_tpu.graph import native as _native

        out = _native.sample_in_edges_native(
            self._indptr, self._indices, self.n_nodes, seeds, fanout,
            int(self._rng.integers(0, 2**63 - 1)),
        )
        if out is not None:
            return out[0].astype(np.int64), out[1].astype(np.int64)
        lo = self._indptr[seeds]
        hi = self._indptr[seeds + 1]
        deg = hi - lo
        take = np.minimum(deg, fanout)
        total = int(take.sum())
        src = np.empty(total, np.int64)
        dst = np.empty(total, np.int64)
        pos = 0
        for s, l, d, t in zip(seeds, lo, deg, take):
            if t == 0:
                continue
            if d <= fanout:
                sel = self._indices[l : l + d]
            else:
                sel = self._indices[
                    l + self._rng.choice(d, size=t, replace=False)
                ]
            src[pos : pos + t] = sel
            dst[pos : pos + t] = s
            pos += t
        return src[:pos], dst[:pos]

    def max_shapes(self, batch_size: int):
        """Static (max_nodes, max_edges) bound for a seed batch size."""
        nodes = batch_size
        edges = 0
        frontier = batch_size
        for f in self.fanouts:
            edges += frontier * f
            frontier = frontier * f
            nodes += frontier
        # Self-loop edges for every node.
        edges += nodes
        return (
            _round_up(min(nodes, self.n_nodes * 2), 8),
            _round_up(edges, 128),
        )

    def sample(self, seeds: np.ndarray, *,
               add_self_loops: bool = True) -> SampledBatch:
        """Sample the layered in-neighborhood subgraph of ``seeds``."""
        seeds = np.asarray(seeds, np.int64)
        batch_size = len(seeds)
        max_nodes, max_edges = self.max_shapes(batch_size)
        w = _round_up(max(self.fanouts) + 1, 8)

        # Native whole-batch path: layered Floyd/reservoir draws, local
        # renumbering, self loops, and in_cols in one C call
        # (csrc/graphcore.cpp graphcore_sample_subgraph) — the numpy
        # path below spends its time on set algebra + gathers; the native
        # call is several times faster and threads across cores.
        from custom_op_benchmark_tpu.graph import native as _native

        nat = _native.sample_subgraph_native(
            self._indptr, self._indices, self.n_nodes, seeds,
            self.fanouts, int(self._rng.integers(0, 2**63 - 1)),
            add_self_loops=add_self_loops, max_nodes=max_nodes,
            max_edges=max_edges, w=w, n_threads=self.n_threads,
        )
        if nat is not None:
            node_ids, n_local, lsrc, ldst, ne, in_cols = nat
            g = from_coo(lsrc[:ne], ldst[:ne], max_nodes,
                         pad_to=max_edges)
            node_mask = np.zeros(max_nodes, bool)
            node_mask[:n_local] = True
            return SampledBatch(
                graph=g,
                node_ids=node_ids,
                node_mask=node_mask,
                seed_ids=seeds.astype(np.int32),
                seed_mask=np.ones(batch_size, bool),
                in_cols=in_cols,
                num_seeds=batch_size,
            )

        # Layered expansion with an O(n) visited bitmap instead of
        # sorted-set algebra: per hop, the new frontier is the set of
        # source nodes whose mask bit flips this hop — identical to the
        # unique/setdiff1d result (flatnonzero yields them sorted) at a
        # fraction of the sort cost on Reddit-scale batches.
        all_src, all_dst = [], []
        seed_bit = np.zeros(self.n_nodes, bool)
        seed_bit[seeds] = True
        visited_bit = seed_bit.copy()
        frontier = np.flatnonzero(seed_bit)
        for f in self.fanouts:
            s, d = self._sample_in_edges(frontier, f)
            all_src.append(s)
            all_dst.append(d)
            newly = np.zeros(self.n_nodes, bool)
            newly[s] = True
            newly &= ~visited_bit
            visited_bit |= newly
            frontier = np.flatnonzero(newly)

        src = np.concatenate(all_src) if all_src else np.empty(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else np.empty(0, np.int64)

        # Local renumbering: seeds first (stable order), then the rest
        # (ascending global id, as setdiff1d produced before).
        rest = np.flatnonzero(visited_bit & ~seed_bit)
        node_ids_real = np.concatenate([seeds, rest])
        n_local = len(node_ids_real)
        if n_local > max_nodes:
            # The static bound is a heuristic (min(worst-case, 2n)); a
            # dense batch can exceed it. Trim the deepest-hop extras
            # (never seeds) and drop their edges — a slightly smaller
            # sampled neighborhood, same stochastic-approximation
            # semantics, instead of killing the epoch (round-1 weak #9).
            node_ids_real = node_ids_real[:max_nodes]
            n_local = max_nodes
        lookup = np.full(self.n_nodes, -1, np.int64)
        lookup[node_ids_real] = np.arange(n_local)

        lsrc = lookup[src]
        ldst = lookup[dst]
        keep = (lsrc >= 0) & (ldst >= 0)
        lsrc, ldst = lsrc[keep], ldst[keep]
        if add_self_loops:
            loops = np.arange(n_local)
            lsrc = np.concatenate([lsrc, loops])
            ldst = np.concatenate([ldst, loops])
        if len(lsrc) > max_edges:
            lsrc, ldst = lsrc[:max_edges], ldst[:max_edges]

        g, host = from_coo(lsrc, ldst, max_nodes, pad_to=max_edges,
                           want_host=True)

        # Dense in-neighbor matrix (static single-bucket ELL): in-degree
        # ≤ max(fanouts) + 1 by construction. Built from the graph's own
        # CSC host views — pure gathers, no argsort/searchsorted (the
        # slot of CSC position k is k - indptr_c[dst]; row order within
        # a dst differs from the raw edge order but the per-dst multiset
        # is identical, which is all aggregation semantics need).
        in_cols = np.full((max_nodes, w), max_nodes, np.int32)
        dst_csc = host["dst_c"][host["csc_perm"]]
        src_csc = host["src_c"][host["csc_perm"]]
        slot = (np.arange(len(dst_csc), dtype=np.int64)
                - host["indptr_c"][dst_csc])
        real = dst_csc < max_nodes
        # The batch Graph keeps every edge, and sampled_copy_spmm's VJP
        # reduces over g.src/g.dst — silently dropping overflow slots
        # here would make gradients disagree with the forward. Fail loud
        # if the 'in-degree <= max(fanouts)+1' invariant ever breaks
        # (e.g. a future with-replacement sampler).
        if real.any() and int(slot[real].max()) >= w:
            raise AssertionError(
                f"sampled in-degree {int(slot[real].max()) + 1} exceeds "
                f"the dense-ELL width {w}; sampler invariant broken"
            )
        in_cols[dst_csc[real], slot[real]] = src_csc[real]

        node_ids = np.zeros(max_nodes, np.int32)
        node_ids[:n_local] = node_ids_real
        node_mask = np.zeros(max_nodes, bool)
        node_mask[:n_local] = True
        return SampledBatch(
            graph=g,
            node_ids=node_ids,
            node_mask=node_mask,
            seed_ids=seeds.astype(np.int32),
            seed_mask=np.ones(batch_size, bool),
            in_cols=in_cols,
            num_seeds=batch_size,
        )

    def epoch(self, train_ids: np.ndarray, batch_size: int, *,
              shuffle: bool = True, drop_last: bool = True):
        """Yield SampledBatches covering ``train_ids`` once."""
        ids = np.asarray(train_ids)
        if shuffle:
            ids = self._rng.permutation(ids)
        end = (len(ids) // batch_size) * batch_size if drop_last else len(ids)
        for i in range(0, end, batch_size):
            chunk = ids[i : i + batch_size]
            if len(chunk) < batch_size:
                pad = np.zeros(batch_size - len(chunk), chunk.dtype)
                mask = np.concatenate(
                    [np.ones(len(chunk), bool), np.zeros(len(pad), bool)]
                )
                b = self.sample(np.concatenate([chunk, pad]))
                b.seed_mask[:] = mask
                yield b
            else:
                yield self.sample(chunk)
