"""Pallas kernels over the block-sparse tiling, compiled for NVIDIA GPUs
through the Triton route (SURVEY.md §7.3).

They replace the reference's native stack (CUDA kernels + atomics +
launch-geometry tuning, graphop/graphop_kernel.cu + graphop/atomic.cuh):
every op is dense math over nonzero adjacency tiles, with one program
owning each output block — conflict-free by construction, no atomics,
deterministic. :func:`interpret_mode` runs them in the Pallas interpreter
instead (tests on the CPU).
"""

from custom_op_benchmark_tpu.ops.pallas.common import interpret_mode
from custom_op_benchmark_tpu.ops.pallas.tiled_kernels import (
    feat_block,
    sddmm_tiles_kernel,
    spmm_row_sweep_kernel,
)
from custom_op_benchmark_tpu.ops.pallas.attention import (
    fused_attention_rows,
)

__all__ = [
    "feat_block",
    "fused_attention_rows",
    "interpret_mode",
    "sddmm_tiles_kernel",
    "spmm_row_sweep_kernel",
]
