import os
import sys

# Multi-device tests run on a virtual 8-device CPU mesh; parity tests need
# f64.  The platform is chosen before any backend is initialized.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from trajectory_optimization_matrix_lie_groups.utils.platform import (  # noqa: E402
    setup_compile_cache,
)

# CPU unless the caller picks a platform (JAX_PLATFORMS=cuda for the `gpu`
# tests on the card)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compilation cache: the parity tier's wall is dominated by
# multi-minute XLA:CPU compiles of the double-f32 polish graphs
setup_compile_cache()
