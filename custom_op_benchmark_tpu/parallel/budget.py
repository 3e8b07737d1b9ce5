"""Static per-shard device-memory budget for the halo-partitioned
training path.

Round-4 verdict #7: the halo builders are proven at P=64 × 100M edges
host-side, but nothing computed whether a real papers100M shard
(features + padded ELL slots + halo buffers + optimizer state) fits one
device's memory at P=16/64. This module is that calculation — pure
arithmetic over :class:`parallel.halo.PlanStats` plus the dtype policy,
no devices touched (reference analog: the cached-index scaling concern,
wrapper.py:114-116 — the reference caches its index tensors to disk and
never asks whether they fit).

Model (per shard, bytes) for an L-layer distributed GAT
(`fit_edge_partitioned(plan="halo")`):

  features      n_per · f · dt            input features, sharded
  qkv + out     4 · n_per · h·d · dt      per live layer (q, k, v, out)
  ext tables    2 · n_ext · h·d · dt      k‖v extended tables
                                          (n_ext = n_per + P·M + (P−1)·K)
  alpha residual pack_local · h · 4       saved per layer by the fused
                                          attention's VJP (f32)
  ell indices   ~2 · pack_slots · 4       cols/epos int32, both packings
                + plan arrays (send/eid)  2 · E_p · 4
  params+opt    3 · param_count · 4       adam (params, m, v), replicated

`remat=True` keeps ONE layer's qkv/ext/alpha live at a time
(jax.checkpoint over layers); `remat=False` multiplies the per-layer
terms by L (what plain reverse-mode keeps live).

Capacity for the feasibility verdict: what the device reports
(``memory_stats()["bytes_limit"]``, the share JAX may allocate) where a
device is present, else the H100's 80 GB, with 10% headroom reserved for
XLA scratch.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 Tensor Core GPU data sheet, SXM form factor: 80 GB HBM3.
H100_BYTES = 80e9
HEADROOM = 0.90   # fraction of device memory the model state may use


def device_capacity_bytes(device=None) -> float:
    """Bytes JAX may allocate on ``device`` (default: the first device),
    from its memory stats; the H100's 80 GB when no device reports it."""
    import jax

    try:
        device = device or jax.devices()[0]
        stats = device.memory_stats() or {}
    except RuntimeError:
        stats = {}
    return float(stats.get("bytes_limit", H100_BYTES))


@dataclasses.dataclass(frozen=True)
class ShardBudget:
    """Per-shard byte accounting; ``total`` is the peak-live estimate."""

    features: int
    layer_live: int       # qkv + out + ext tables for live layers
    alpha_residual: int   # saved packed α (all layers — not remat-able
    #                       away: the VJP consumes every layer's α)
    ell_indices: int
    params_opt: int

    @property
    def total(self) -> int:
        return (self.features + self.layer_live + self.alpha_residual
                + self.ell_indices + self.params_opt)

    def fits(self, capacity_bytes: float) -> bool:
        return self.total <= capacity_bytes * HEADROOM


def shard_budget(st, *, feat_dim: int, heads: int, head_dim: int,
                 num_layers: int = 2, dtype_bytes: int = 2,
                 remat: bool = True,
                 param_count: int = None) -> ShardBudget:
    """Budget one shard of the halo plan described by ``st``
    (:class:`parallel.halo.PlanStats`).

    ``dtype_bytes``: 2 for the bf16 activation policy
    (fit_edge_partitioned(dtype=jnp.bfloat16)), 4 for f32.
    ``param_count``: replicated parameter count; default models the
    GAT's 3·L weight matrices at hidden = heads·head_dim plus an
    output head of 256 classes.
    """
    p = st.num_parts
    hd = heads * head_dim
    n_ext = st.n_per + 1 + p * st.halo + p * st.n_hub
    if param_count is None:
        hidden = hd
        param_count = (feat_dim * hidden + 3 * (num_layers - 1)
                       * hidden * hidden + 2 * hidden * hidden
                       + hidden * 256)
    per_layer = (4 * st.n_per * hd * dtype_bytes          # q,k,v,out
                 + 2 * n_ext * hd * dtype_bytes)          # k‖v ext
    live_layers = 1 if remat else num_layers
    # α is packed over the LOCAL slots only (~half of pack_slots, which
    # counts both packings); saved f32 for every layer regardless of
    # remat (the hand VJP consumes it — parallel/halo.py).
    alpha = num_layers * (st.pack_slots // 2) * heads * 4
    ell_idx = 2 * st.pack_slots * 4 + 2 * st.edges_per_part * 4
    return ShardBudget(
        features=st.n_per * feat_dim * dtype_bytes,
        layer_live=live_layers * per_layer,
        alpha_residual=alpha,
        ell_indices=ell_idx,
        params_opt=3 * param_count * 4,
    )


def budget_table(st_by_p: dict, *, feat_dim: int, heads: int,
                 head_dim: int, num_layers: int = 2) -> list:
    """Rows for every (P, dtype, remat) combination with a fits verdict
    against :func:`device_capacity_bytes`."""
    cap = device_capacity_bytes()
    rows = []
    for p, st in sorted(st_by_p.items()):
        for dt_name, dt in (("bf16", 2), ("f32", 4)):
            for remat in (True, False):
                b = shard_budget(st, feat_dim=feat_dim, heads=heads,
                                 head_dim=head_dim,
                                 num_layers=num_layers,
                                 dtype_bytes=dt, remat=remat)
                rows.append(dict(
                    devices=p, dtype=dt_name, remat=remat,
                    features_gb=round(b.features / 1e9, 2),
                    layer_live_gb=round(b.layer_live / 1e9, 2),
                    alpha_gb=round(b.alpha_residual / 1e9, 2),
                    ell_idx_gb=round(b.ell_indices / 1e9, 2),
                    total_gb=round(b.total / 1e9, 2),
                    capacity_gb=round(cap / 1e9, 2), fits=b.fits(cap),
                ))
    return rows
