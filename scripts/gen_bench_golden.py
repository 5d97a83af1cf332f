"""Generate the f64 CPU golden for the bench's N=200 SE(3) tracking problem.

Solves `tasks/se3_bench.build_problem` (lane 0 of every bench and smoke
run) with the reference-exact `LieILQR` engine at float64 on the CPU, to a
gradient norm of 1e-10, checks that the fixed-budget batched engine
(`FastBatchSolver`, the pipeline's iterate oracle) lands on the same
controls, and writes tasks/golden/bench_se3_n200_{q0,xi0,us}.npy.

    python scripts/gen_bench_golden.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from trajectory_optimization_matrix_lie_groups.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)
from trajectory_optimization_matrix_lie_groups.tasks import se3_bench

N = se3_bench.HORIZON
model, params, q0, xi0, q_ref, xi_ref = se3_bench.build_problem(jnp.float64)
cfg = SolverConfig(N=N, multiple_shooting=True, rollout="nonlinear",
                   tol_grad_norm=1e-10, tol_d_norm=1e-10, tol_J=0.0,
                   max_iterations=100)
(qs, xis), us, J_hist, grad_hist, defect_hist, state = LieILQR(
    model, cfg).fit(params, (q0, xi0), jnp.zeros((N, 6)),
                    q_ref=jnp.asarray(q_ref), xi_ref=jnp.asarray(xi_ref))
us = np.asarray(us, np.float64)

fast = FastBatchSolver(model, N=N, iterations=30)
out = fast.solve(params, q0[None], xi0[None], jnp.zeros((1, N, 6)),
                 jnp.asarray(q_ref), jnp.asarray(xi_ref))
agree = float(np.max(np.abs(np.asarray(out.us[0]) - us)))
meta = dict(iterations=len(J_hist), J=J_hist[-1], grad_norm=grad_hist[-1],
            defect_norm=defect_hist[-1], fast_batch_max_diff=agree,
            us_absmax=float(np.abs(us).max()))
print(json.dumps(meta))
assert grad_hist[-1] < 1e-8 and agree < 1e-6, meta
for name, arr in (("q0", q0), ("xi0", xi0), ("us", us)):
    np.save(os.path.join(se3_bench.GOLDEN_DIR, f"bench_se3_n200_{name}.npy"),
            np.asarray(arr, np.float64))
print("written", se3_bench.GOLDEN_DIR)
