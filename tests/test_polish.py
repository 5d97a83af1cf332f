"""High-precision mode: f32 pipeline + f64 polish recovers f64-grade us."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups.solvers.polish import (
    HighPrecisionSolver,
)
from trajectory_optimization_matrix_lie_groups.tasks.parity import (
    build_benchmark,
)


def _cut_problem(H):
    data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    cp = params["cost"]
    cut = lambda a: a[: H + 1]
    cp = cp._replace(q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
                     Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))
    return solver.model, {**params, "cost": cp}


@pytest.mark.slow
def test_polish_recovers_f64_accuracy():
    H, B, ITERS = 30, 2, 8
    model, params = _cut_problem(H)
    cp, dp = params["cost"], params["dyn"]

    dq = 0.05 * jax.random.normal(jax.random.PRNGKey(5), (B, 6))
    q0s = SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 6))
    us0s = jnp.zeros((B, H, 6))

    # f64 fixed point (well-converged reference answer)
    gold = FastBatchSolver(model, N=H, iterations=30).solve(
        params, q0s, xi0s, us0s, cp.q_ref, cp.xi_ref)

    f32only = PipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt))
    p32 = jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
        params)
    raw = f32only.solve(p32["dyn"], p32["cost"],
                        q0s.astype(jnp.float32), xi0s.astype(jnp.float32),
                        us0s.astype(jnp.float32))

    hp = HighPrecisionSolver(model, N=H, iterations=ITERS, dt=float(dp.dt),
                             polish_iters=2)
    out = hp.solve(params, q0s, xi0s, us0s)
    assert out.us.dtype == jnp.float64

    err_raw = float(np.max(np.abs(np.asarray(raw.us, np.float64)
                                  - np.asarray(gold.us))))
    err_hp = float(np.max(np.abs(np.asarray(out.us) - np.asarray(gold.us))))
    # the polish must contract the f32 error substantially and land inside
    # the BASELINE fidelity gate (1e-4)
    assert err_hp < 1e-4, (err_raw, err_hp)
    assert err_hp < err_raw / 3.0, (err_raw, err_hp)
    assert np.all(np.isfinite(np.asarray(out.J_opt)))
