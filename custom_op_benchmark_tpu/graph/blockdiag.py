"""Component-batched dense view: the fastest layout for blocky graphs.

The reference's benchmark workload is 512 disjoint 30-node cliques — a
block-diagonal attention mask expressed as a graph (wrapper.py:79-101) —
and its fastest GPU baseline is the dense ``bmm`` view of that structure
(wrapper.py:185). Here this formulation is not a baseline, it is the
*execution strategy*: pack each connected component into one row block
of a ``(B, L, ...)`` batch and every sparse op becomes a batched dense
matmul moving exactly the ideal number of bytes (no tile-slot padding,
no index gathers).

The op layer picks this path when :func:`block_graph` succeeds (all
components ≤ ``max_block`` nodes); general graphs fall back to the tiled
or segment paths. Everything here is differentiable by construction
(plain XLA einsums/softmax — no custom VJPs needed).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockGraph:
    """Dense component-batched view of a :class:`Graph`.

    Leaves:
      node_slot: (n_nodes,) int32 — flat slot ``b·L + i`` of each node.
      slot_node: (B·L,) int32 — node id per slot (n_nodes for padding).
      adj:       (B, L, L) bool — within-block adjacency (src row, dst col).
      edge_slot: (E,) int32 — canonical eid → flat ``b·L² + r·L + c`` slot;
                 padded edges point at slot B·L² (scratch).
      node_mask: (B, L) bool — real-node slots.

    Static: n_nodes, n_edges, num_blocks (B), block_len (L).
    """

    node_slot: jax.Array
    slot_node: jax.Array
    adj: jax.Array
    edge_slot: jax.Array
    # slot_edge: (B·L²,) int32 — canonical edge id per flat edge slot
    # (E_pad for empty slots). The inverse of edge_slot; makes the
    # layout-conversion VJPs pure gathers instead of scatter-adds.
    slot_edge: jax.Array
    node_mask: jax.Array
    n_nodes: int = dataclasses.field(metadata=dict(static=True))
    n_edges: int = dataclasses.field(metadata=dict(static=True))
    num_blocks: int = dataclasses.field(metadata=dict(static=True))
    block_len: int = dataclasses.field(metadata=dict(static=True))

    # ---- node tensors (scatter/gather pairs are inverse permutations:
    # every VJP below is expressed as the opposite-direction gather) ----

    def scatter_nodes(self, x: jax.Array) -> jax.Array:
        """(n_nodes, ...) → (B, L, ...) block layout (pads zero)."""
        return _scatter_nodes(self, x)

    def gather_nodes(self, xb: jax.Array) -> jax.Array:
        """(B, L, ...) → (n_nodes, ...)."""
        return _gather_nodes(self, xb)

    # ---- edge tensors ----------------------------------------------------

    def scatter_edges(self, ed: jax.Array) -> jax.Array:
        """(E, ...) canonical edge order → (B, L, L, ...) (pads zero)."""
        return _scatter_edges(self, ed)

    def gather_edges(self, eb: jax.Array) -> jax.Array:
        """(B, L, L, ...) → (E, ...) canonical order."""
        return _gather_edges(self, eb)


# ---------------------------------------------------------------------------
# Layout conversions with gather-only VJPs. node_slot/edge_slot are
# injective, so each scatter's transpose is exactly the inverse gather,
# where XLA's default transpose would be a scatter-add.
# ---------------------------------------------------------------------------

def _trail(x, k):
    return tuple(x.shape[k:])


@jax.custom_vjp
def _scatter_nodes(bg, x):
    b, l = bg.num_blocks, bg.block_len
    out = jnp.zeros((b * l,) + _trail(x, 1), x.dtype)
    return out.at[bg.node_slot].set(x).reshape((b, l) + _trail(x, 1))


def _scatter_nodes_fwd(bg, x):
    return _scatter_nodes(bg, x), bg


def _scatter_nodes_bwd(bg, dy):
    flat = dy.reshape((-1,) + _trail(dy, 2))
    return None, flat[bg.node_slot]


_scatter_nodes.defvjp(_scatter_nodes_fwd, _scatter_nodes_bwd)


@jax.custom_vjp
def _gather_nodes(bg, xb):
    flat = xb.reshape((-1,) + _trail(xb, 2))
    return flat[bg.node_slot]


def _gather_nodes_fwd(bg, xb):
    return _gather_nodes(bg, xb), bg


def _gather_nodes_bwd(bg, dy):
    # Inverse gather: slot s holds dy[slot_node[s]] if it maps a real node.
    dyp = jnp.pad(dy, [(0, 1)] + [(0, 0)] * (dy.ndim - 1))
    idx = jnp.where(bg.slot_node < bg.n_nodes, bg.slot_node, bg.n_nodes)
    dxb = dyp[idx].reshape(
        (bg.num_blocks, bg.block_len) + _trail(dy, 1)
    )
    return None, dxb


_gather_nodes.defvjp(_gather_nodes_fwd, _gather_nodes_bwd)


@jax.custom_vjp
def _scatter_edges(bg, ed):
    b, l = bg.num_blocks, bg.block_len
    out = jnp.zeros((b * l * l + 1,) + _trail(ed, 1), ed.dtype)
    out = out.at[bg.edge_slot].set(ed)
    return out[: b * l * l].reshape((b, l, l) + _trail(ed, 1))


def _scatter_edges_fwd(bg, ed):
    return _scatter_edges(bg, ed), (bg, ed.shape[0])


def _scatter_edges_bwd(res, dy):
    bg, e_pad = res
    flat = dy.reshape((-1,) + _trail(dy, 3))
    idx = jnp.minimum(bg.edge_slot, flat.shape[0] - 1)
    valid = bg.edge_slot < flat.shape[0]
    ded = flat[idx]
    mask = valid.reshape((-1,) + (1,) * (ded.ndim - 1))
    return None, jnp.where(mask, ded, 0)[:e_pad]


_scatter_edges.defvjp(_scatter_edges_fwd, _scatter_edges_bwd)


@jax.custom_vjp
def _gather_edges(bg, eb):
    flat = eb.reshape((-1,) + _trail(eb, 3))
    idx = jnp.minimum(bg.edge_slot, flat.shape[0] - 1)
    return flat[idx]


def _gather_edges_fwd(bg, eb):
    return _gather_edges(bg, eb), bg


def _gather_edges_bwd(bg, dy):
    # Inverse gather: flat slot s gets dy[slot_edge[s]] (0 if empty).
    dyp = jnp.pad(dy, [(0, 1)] + [(0, 0)] * (dy.ndim - 1))
    idx = jnp.minimum(bg.slot_edge, dy.shape[0])
    deb = dyp[idx].reshape(
        (bg.num_blocks, bg.block_len, bg.block_len) + _trail(dy, 1)
    )
    return None, deb


_gather_edges.defvjp(_gather_edges_fwd, _gather_edges_bwd)


def block_graph(g, max_block: int = 128,
                block_len: Optional[int] = None) -> Optional[BlockGraph]:
    """Build the dense block view, or return None if ``g`` isn't blocky.

    Succeeds iff every weakly-connected component has ≤ ``max_block``
    nodes; ``block_len`` defaults to the largest component size. Host-side
    cold path (cache it next to the graph, like the reference caches its
    index tensors — wrapper.py:114-116).
    """
    from custom_op_benchmark_tpu.graph.reorder import connected_components

    src = np.asarray(jax.device_get(g.src))[: g.n_edges].astype(np.int64)
    dst = np.asarray(jax.device_get(g.dst))[: g.n_edges].astype(np.int64)
    n, e = g.n_nodes, g.n_edges
    labels = connected_components(src, dst, n)
    _, comp_of, counts = np.unique(
        labels, return_inverse=True, return_counts=True
    )
    if counts.size == 0 or counts.max() > max_block:
        return None
    l = int(block_len or counts.max())
    if counts.max() > l:
        return None
    b = len(counts)

    # Position of each node within its component (old-id order).
    order = np.argsort(comp_of, kind="stable")
    pos = np.empty(n, dtype=np.int64)
    starts = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos[order] = np.arange(n, dtype=np.int64) - starts[comp_of[order]]
    node_slot = (comp_of * l + pos).astype(np.int32)

    slot_node = np.full(b * l, n, dtype=np.int32)
    slot_node[node_slot] = np.arange(n, dtype=np.int32)
    node_mask = (slot_node < n).reshape(b, l)

    eb = comp_of[src]
    if not np.array_equal(eb, comp_of[dst]):
        return None  # cross-component edge: labels inconsistent
    r = pos[src]
    c = pos[dst]
    flat = eb * (l * l) + r * l + c
    if len(np.unique(flat)) != e:
        return None  # multigraph (duplicate edges) — dense view can't hold it
    adj = np.zeros(b * l * l, dtype=bool)
    adj[flat] = True

    e_pad = g.num_edges_padded
    edge_slot = np.full(e_pad, b * l * l, dtype=np.int32)
    edge_slot[:e] = flat
    slot_edge = np.full(b * l * l, e_pad, dtype=np.int32)
    slot_edge[flat] = np.arange(e, dtype=np.int32)

    return BlockGraph(
        node_slot=jnp.asarray(node_slot),
        slot_node=jnp.asarray(slot_node),
        adj=jnp.asarray(adj.reshape(b, l, l)),
        edge_slot=jnp.asarray(edge_slot),
        slot_edge=jnp.asarray(slot_edge),
        node_mask=jnp.asarray(node_mask),
        n_nodes=n,
        n_edges=e,
        num_blocks=b,
        block_len=l,
    )
