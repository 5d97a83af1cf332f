"""SO(3)-family lane-layout pipeline vs the generic batched engine.

VERDICT round-2 item 4: kernel path for SO(3) free attitude AND the 3-D
pendulum (state-dependent Fu through the Riccati kernel, gravity torque +
input-moment Jacobians in-kernel).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops.group import SO3
from trajectory_optimization_matrix_lie_groups.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups.solvers.pipeline_so3 import (
    SO3PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups.tasks.parity import (
    build_benchmark,
)


def _setup(name, H, B, seed):
    data, solver, params, x0, us0, _ = build_benchmark(name, True)
    cp = params["cost"]
    cut = lambda a: a[: H + 1]
    cp = cp._replace(q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
                     Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))
    params = {**params, "cost": cp}
    to32 = lambda t: jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, t)
    params = to32(params)
    cp = params["cost"]

    key = jax.random.PRNGKey(seed)
    dq = 0.05 * jax.random.normal(key, (B, 3), dtype=jnp.float32)
    q0s = SO3.normalize(cp.q_ref[0][None] @ SO3.exp(dq))
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 3))
    us0s = jnp.zeros((B, H, 3), jnp.float32)
    return solver.model, params, q0s, xi0s, us0s


@pytest.mark.parametrize("name,pendulum", [
    ("so3_tracking", False),
    ("pendulum_swingup", True),
])
def test_so3_pipeline_matches_fast_batch(name, pendulum):
    H, B, ITERS = 20, 3, 4
    model, params, q0s, xi0s, us0s = _setup(name, H, B, seed=0)
    cp, dp = params["cost"], params["dyn"]

    fast = FastBatchSolver(model, N=H, iterations=ITERS)
    ref = fast.solve(params, q0s, xi0s, us0s, cp.q_ref, cp.xi_ref)

    pipe = SO3PipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt),
                             pendulum=pendulum)
    out = pipe.solve(dp, cp, q0s, xi0s, us0s)

    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us),
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out.J_opt), np.asarray(ref.J_opt),
                               rtol=1e-4)
