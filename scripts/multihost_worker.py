"""Worker for tests/test_multihost.py: one process of a 2-process CPU job.

Each process exposes 4 virtual CPU devices (the workers are pinned to the
CPU: they never open an accelerator); together they form an 8-device
global mesh.  The worker runs the sharded pipeline on its batch shard,
all-gathers the controls, and process 0 compares them against a local
single-process solve of the same problems.

Invocation: python scripts/multihost_worker.py <coordinator> <nprocs> <pid>
Prints "MULTIHOST_OK <max_err>" on success (process 0).
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

coordinator, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

from trajectory_optimization_matrix_lie_groups import parallel
from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups.tasks import se3_bench

parallel.initialize_multihost(coordinator, nprocs, pid)
assert len(jax.devices()) == 4 * nprocs, jax.devices()
mesh = parallel.global_batch_mesh()

import jax.numpy as jnp

H, B_GLOBAL, ITERS = 12, 16, 2
_, params, _, _, _, _ = se3_bench.build_problem(jnp.float64, H)
cp = params["cost"]
dp = params["dyn"]

# identical global problem set on every process (seeded)
dq = 0.05 * jax.random.normal(jax.random.PRNGKey(42), (B_GLOBAL, 6))
q0s_all = np.asarray(SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq)))
xi0s_all = np.broadcast_to(np.asarray(cp.xi_ref[0]), (B_GLOBAL, 6))
us0_all = np.zeros((B_GLOBAL, H, 6))

# each process contributes its local shard
B_local = B_GLOBAL // nprocs
sl = slice(pid * B_local, (pid + 1) * B_local)
q0s = parallel.distribute_batch(q0s_all[sl], mesh)
xi0s = parallel.distribute_batch(xi0s_all[sl], mesh)
us0 = parallel.distribute_batch(us0_all[sl], mesh)

pipe = PipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt))
sharded = parallel.ShardedPipelineSolver(pipe, mesh)
out = sharded.solve(dp, cp, q0s, xi0s, us0)
us_global = parallel.gather_to_all(out.us)

if pid == 0:
    single = PipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt))
    ref = single.solve(dp, cp, jnp.asarray(q0s_all),
                       jnp.asarray(xi0s_all), jnp.asarray(us0_all))
    err = float(np.max(np.abs(us_global - np.asarray(ref.us))))
    assert err < 1e-10, err
    print(f"MULTIHOST_OK {err:.3e}", flush=True)
