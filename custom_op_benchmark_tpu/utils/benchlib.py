"""Benchmark harness: warmup, repeats, medians, roofline accounting.

The reference times everything single-shot with ``time.time()`` +
``cuda.synchronize()`` and no warmup (wrapper.py:154-160 — so its numbers
include JIT/launch warmup); SURVEY.md §5 prescribes the upgrade implemented
here: warmup iterations, median over repeats, an execution fence, and
achieved-bytes/s vs the device's memory roofline, emitted as structured
records.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Optional

import jax
import numpy as np

# Published peak device-memory bandwidth, bytes/s, keyed by the
# ``device_kind`` JAX reports. Source: NVIDIA H100 Tensor Core GPU data
# sheet, SXM form factor: 80 GB HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bandwidth_bytes(device=None) -> float:
    """Peak device-memory bytes/s of the current (or given) device. A
    device missing from :data:`HBM_BYTES_PER_S` is an error, not a
    default."""
    if device is None:
        device = jax.devices()[0]
    kind = getattr(device, "device_kind", None)
    try:
        return HBM_BYTES_PER_S[kind]
    except KeyError:
        raise ValueError(
            f"no peak bandwidth known for device kind {kind!r}; add it "
            "to utils.benchlib.HBM_BYTES_PER_S with its source") from None


@dataclasses.dataclass
class BenchRecord:
    """One structured benchmark result (SURVEY.md §5 observability)."""

    name: str
    time_s: float                 # median wall time per iteration
    times: list                   # all post-warmup samples
    bytes_moved: Optional[float] = None   # minimal/ideal bytes per iter
    flops: Optional[float] = None
    edges: Optional[int] = None
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def edges_per_s(self) -> Optional[float]:
        return None if self.edges is None else self.edges / self.time_s

    @property
    def achieved_bw(self) -> Optional[float]:
        return (
            None if self.bytes_moved is None
            else self.bytes_moved / self.time_s
        )

    def roofline_fraction(self, peak_bytes_per_s: Optional[float] = None):
        if self.bytes_moved is None:
            return None
        peak = peak_bytes_per_s or hbm_bandwidth_bytes()
        return self.achieved_bw / peak

    def to_json(self) -> str:
        d = dict(
            name=self.name,
            time_s=self.time_s,
            edges_per_s=self.edges_per_s,
            achieved_gb_s=(
                None if self.achieved_bw is None
                else self.achieved_bw / 1e9
            ),
            roofline_frac=self.roofline_fraction(),
            **self.extra,
        )
        return json.dumps({k: v for k, v in d.items() if v is not None})


def _chained_loop(fn: Callable[..., Any], k: int, n_sets: int = 1,
                  perturb="all"):
    """jit(*args_sets -> (scalar, args_sets)): ``fn`` run ``k`` times
    sequentially, round-robin over ``n_sets`` independent argument sets
    (all donated — rebind the returned sets).

    Each iteration perturbs one element of one input by a runtime-zero
    derived from the previous iteration's output (``chk * 0`` — XLA must
    preserve it because it cannot prove ``chk`` is not NaN/Inf), wrapped
    in ``lax.optimization_barrier`` so the output must be fully
    materialized (no slice-narrowing through the barrier). This defeats
    loop-invariant code motion, CSE and DCE — a plain ``barrier``-only tie
    is NOT enough (XLA still hoists the body). Returns one element of the
    final carry; fetching that 4-byte scalar fences execution.

    ``rotate > 1`` cycles the loop over that many *independent copies* of
    the inputs (created by the caller — see :func:`bench_fn`). With copies
    sized past the on-chip cache in aggregate, every iteration streams its
    operands from device memory; otherwise a loop-carried working set
    that fits in cache is served from there and the "roofline fraction"
    can exceed 1.0.
    """
    import jax.numpy as jnp
    from jax import lax

    def loop(*args_sets):
        sets = [jax.tree_util.tree_flatten(a) for a in args_sets]
        treedef = sets[0][1]
        # Perturbed-leaf choice (``perturb``):
        # - "all" (safe default): every float leaf. Required whenever some
        #   output is independent of some input (e.g. SDDMM's dA never
        #   reads A) — an unperturbed leaf the body provably ignores
        #   re-opens the LICM hoist and the measurement collapses.
        # - explicit index list: minimal covering set. Leaves outside it
        #   stay loop-invariant, so their DMA streams may overlap across
        #   iterations — measuring steady-state *throughput* (the roofline
        #   quantity) instead of fully-serialized latency (~5-8% higher).
        # Int leaves are skipped either way: x*0 folds legally for ints.
        float_leaves = [
            i for i, l in enumerate(sets[0][0])
            if jnp.issubdtype(l.dtype, jnp.floating)
        ]
        if perturb == "all":
            tgts = float_leaves or [0]
        else:
            tgts = [i for i in perturb if i in float_leaves] or [0]

        def step(carry, _):
            i, eps, all_ls = carry
            # Perturb FIRST, then read: each leaf's DUS is its only
            # writer and precedes every reader, so XLA updates in place
            # (write-after-read ordering made it copy instead).
            all_ls = [
                [
                    (
                        l.at[(0,) * l.ndim].add(eps.astype(l.dtype))
                        if j in tgts else l
                    )
                    for j, l in enumerate(ls)
                ]
                for ls in all_ls
            ]
            out = lax.switch(
                i % len(all_ls),
                [
                    (lambda ls, r=r: fn(*treedef.unflatten(ls[r])))
                    for r in range(len(all_ls))
                ],
                all_ls,
            )
            z = lax.optimization_barrier(out)
            # The checksum must touch EVERY output leaf: the barrier does
            # not prevent DCE of leaves nothing consumes (measured — a
            # multi-output body kept only its first leaf's computation).
            chk = jnp.float32(0)
            for leaf in jax.tree_util.tree_leaves(z):
                chk = chk + lax.convert_element_type(
                    leaf.ravel()[0], jnp.float32
                )
            eps = chk * 0.0
            return (i + 1, eps, all_ls), None

        (_, _, all_ls), _ = lax.scan(
            step,
            (jnp.int32(0), jnp.float32(0), [s[0] for s in sets]),
            None,
            length=k,
        )
        acc = lax.convert_element_type(
            all_ls[0][tgts[0]].ravel()[0], jnp.float32
        )
        # Return the (numerically unchanged) arg sets so callers can
        # rebind them — they were donated into this call.
        return acc, [treedef.unflatten(ls) for ls in all_ls]

    return jax.jit(loop, donate_argnums=tuple(range(n_sets)))


# perturb semantics shared by bench_fn:
#   "all"          -> serialize every input (safe; latency-flavored)
#   (i, j, ...)    -> only these arg positions (throughput-flavored;
#                     caller asserts every output depends on one of them)


def bench_fn(fn: Callable[..., Any], args: tuple = (), *,
             warmup: int = 1, iters="auto",
             repeats: int = 5, name: str = "bench",
             bytes_moved: Optional[float] = None,
             flops: Optional[float] = None,
             edges: Optional[int] = None,
             rotate: int = 1, perturb="all", **extra) -> BenchRecord:
    """Time ``fn(*args)`` per-iteration via two-point slope timing.

    Protocol (a host↔device round trip per call would swamp short
    kernels):

    1. build jitted loops that run the op ``iters[0]`` and ``iters[1]``
       times back-to-back on device, each iteration data-dependent on the
       last (see :func:`_chained_loop` — immune to lazy execution, result
       caching, and loop hoisting);
    2. time each loop end-to-end, fenced by fetching a 4-byte checksum;
    3. per-iteration time = (t_long − t_short) / (iters[1] − iters[0]),
       which cancels the fixed dispatch/round-trip cost exactly.

    ``iters="auto"`` (default) escalates the long-loop length until the
    slope signal clears the measured round-trip jitter — necessary
    because a fixed gap under-resolves µs-scale ops (slope drowns in
    host timing jitter) while wasting time on ms-scale ones. Pass an
    explicit ``(k_short, k_long)`` to pin it.

    ``rotate=R`` rotates over R independent copies of ``args`` so that
    the aggregate working set exceeds the on-chip cache — set it when
    measuring memory-bound ops whose single-iteration working set fits
    on-chip
    (see :func:`_chained_loop`). ``args`` must be non-empty (the
    loop-carried dependency rides on them) and ``fn`` must be
    jit-traceable with array leaves in/out. The reference's single-shot
    ``time.time()`` + sync protocol (wrapper.py:154-160) under-reports
    by including warmup.
    """
    if not args:
        raise ValueError(
            "bench_fn needs the op's inputs as `args` (the chained-loop "
            "dependency is threaded through them)"
        )
    args = tuple(jax.tree_util.tree_map(jnp_asarray, args))
    # Independent device copies (x + 0·x allocates a fresh buffer; passing
    # the same jax.Array twice would alias one buffer and defeat rotation).
    # The caller's arrays are never used directly: the loops donate their
    # inputs, which would delete buffers out from under the caller.
    copy = jax.jit(lambda t: jax.tree_util.tree_map(_fresh, t))
    args_sets = [copy(args) for _ in range(max(rotate, 1))]
    loops = {}

    def run(k):
        nonlocal args_sets
        if k not in loops:
            loops[k] = _chained_loop(fn, k, len(args_sets), perturb)
            acc, args_sets = loops[k](*args_sets)   # compile + first run
            np.asarray(acc)
        t0 = time.perf_counter()
        acc, args_sets = loops[k](*args_sets)
        np.asarray(acc)              # scalar fetch == execution fence
        return time.perf_counter() - t0

    if iters == "auto":
        k0 = 4
        for _ in range(max(warmup, 1)):
            run(k0)
        t0s = [run(k0) for _ in range(3)]
        jitter = max(t0s) - min(t0s)
        floor = max(6 * jitter, 0.04)      # signal ≫ noise, ≥40 ms
        k1, base = 32, float(np.median(t0s))
        while True:
            t1 = run(k1)
            if t1 - base >= floor or k1 >= 4096:
                break
            k1 *= 4
    else:
        k0, k1 = int(iters[0]), int(iters[1])
        for _ in range(max(warmup, 1)):   # compile + warm caches
            run(k0), run(k1)
    samples = []
    for _ in range(repeats):
        t_short = run(k0)
        t_long = run(k1)
        samples.append(max(t_long - t_short, 1e-9) / (k1 - k0))
    return BenchRecord(
        name=name,
        time_s=float(np.median(samples)),
        times=samples,
        bytes_moved=bytes_moved,
        flops=flops,
        edges=edges,
        extra=extra,
    )


def _fresh(leaf):
    """A new buffer with the same value and dtype (bool stays bool)."""
    return (leaf + 0).astype(leaf.dtype)


def jnp_asarray(x):
    """Put a leaf on device once, outside the timed region."""
    import jax.numpy as jnp

    return x if isinstance(x, jax.Array) else jnp.asarray(x)


def trace_fn(fn: Callable[..., Any], args: tuple, trace_dir: str, *,
             iters: int = 3) -> str:
    """Capture a ``jax.profiler`` trace of ``fn(*args)`` (SURVEY.md §5).

    Runs the same chained loop as :func:`bench_fn` under the profiler so
    the trace shows real device execution (not the enqueue). View with
    TensorBoard or Perfetto. Returns ``trace_dir``.
    """
    args = tuple(jax.tree_util.tree_map(jnp_asarray, args))
    # Private copy: the chained loop donates its inputs (same invariant
    # bench_fn protects), so never hand it the caller's buffers.
    args = jax.jit(lambda t: jax.tree_util.tree_map(_fresh, t))(args)
    loop = _chained_loop(fn, iters, 1)
    acc, sets = loop(args)       # compile outside the trace (args donated)
    np.asarray(acc)
    with jax.profiler.trace(trace_dir):
        acc, sets = loop(sets[0])
        np.asarray(acc)
    return trace_dir
