"""How every Pallas kernel of this package is launched.

The kernels compile for NVIDIA GPUs through Pallas's Triton route. On any
other backend they raise, unless the Pallas interpreter was switched on
explicitly with :func:`interpret_mode` (the CPU tests do this once, in
``tests/conftest.py``). Nothing falls back silently.
"""

from __future__ import annotations

import jax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

_INTERPRET = False


def interpret_mode(enabled: bool = True) -> None:
    """Run every kernel of this package in the Pallas interpreter."""
    global _INTERPRET
    _INTERPRET = bool(enabled)


def triton_call(kernel, *, grid, out_shape, name: str, num_warps: int = 4,
                num_stages: int = 2):
    """``pallas_call`` on the Triton route with whole-array refs: each
    program finds its own tiles by index (there is no scalar prefetch)."""
    backend = jax.default_backend()
    if not _INTERPRET and backend != "gpu":
        raise RuntimeError(
            f"Pallas kernel {name!r} is compiled for NVIDIA GPUs only "
            f"(Triton route) and the JAX backend is {backend!r}. Run on a "
            "GPU, or switch the interpreter on explicitly with "
            "custom_op_benchmark_tpu.ops.pallas.interpret_mode().")
    def call(*args):
        return pl.pallas_call(
            kernel,
            grid=grid,
            in_specs=[pl.no_block_spec] * len(args),
            out_specs=pl.no_block_spec,
            out_shape=out_shape,
            backend="triton",
            compiler_params=pl_triton.CompilerParams(
                num_warps=num_warps, num_stages=num_stages),
            interpret=_INTERPRET,
            name=name,
        )(*args)

    return call
