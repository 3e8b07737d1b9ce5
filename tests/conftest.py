"""Test config: run on CPU with 8 virtual devices (no accelerator needed).

Multi-chip sharding tests fake an 8-device mesh (SURVEY.md §4); the Pallas
kernels, which compile only for the GPU, run in the Pallas interpreter,
switched on explicitly below.
"""

import os

# Belt and braces for subprocesses.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

# Dense einsum oracles must not drift from the exact segment-op paths at a
# reduced matmul precision: tests compare at full precision.
jax.config.update("jax_default_matmul_precision", "highest")

from custom_op_benchmark_tpu.ops.pallas import interpret_mode  # noqa: E402
from custom_op_benchmark_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

interpret_mode()
enable_compile_cache()
# Many small compiles: cache them all, so a repeat run is cheap.
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
