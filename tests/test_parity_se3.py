"""Golden-trajectory parity vs the reference's stored benchmark solutions.

The reference cannot run here (manifpy/casadi absent), but its benchmark
pickles (`visualization/results_benchmark_2nd_draft/*.pkl`) store the full
problem spec AND the converged solutions of each solver.  These tests rebuild
the exact problem and require our solver to reproduce the reference's
converged control sequences — the BASELINE.json 1e-4 gate.

Marked slow: the SE3 tracking problem is N=955 and runs ~tens of iterations.
Run with `-m parity` or plain pytest (not skipped by default; it IS the
correctness gate).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from trajectory_optimization_matrix_lie_groups.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups.models.base import make_model
from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)
from trajectory_optimization_matrix_lie_groups.utils import load_benchmark_pickle

PKL = "/root/reference/visualization/results_benchmark_2nd_draft/results_se3_tracking_benchmark.pkl"

pytestmark = pytest.mark.skipif(not os.path.exists(PKL), reason="reference pickle absent")


def _build(prob, ms: bool, horizon=None):
    q_ref = np.asarray(prob["q_ref"])
    xi_ref = np.asarray(prob["xi_ref"])
    if horizon is not None:
        q_ref = q_ref[: horizon + 1]
        xi_ref = xi_ref[: horizon + 1]
    N = q_ref.shape[0] - 1
    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(prob["J"]), float(prob["dt"]))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(
        SE3, prob["Q"], prob["R"], prob["P"], q_ref, xi_ref
    )
    model, params = make_model(dyn, cd, dp, cp)
    cfg = SolverConfig(
        N=N,
        multiple_shooting=ms,
        line_search=False,
        rollout="nonlinear",
        n_alphas=20 if ms else 13,
        tol_grad_norm=1e-12,
        tol_d_norm=1e-6,
        max_iterations=200,
    )
    solver = LieILQR(model, cfg)
    q0, xi0 = prob["x0"]
    x0 = (jnp.asarray(q0), jnp.asarray(np.asarray(xi0).reshape(6)))
    us0 = jnp.zeros((N, 6))
    return solver, params, x0, us0


@pytest.mark.parity
def test_ms_se3_tracking_matches_reference():
    data = load_benchmark_pickle(PKL)
    solver, params, x0, us0 = _build(data["prob"], ms=True)
    (qs, xis), us, J_hist, grad_hist, defect_hist, state = solver.fit(
        params, x0, us0, n_iterations=200
    )
    us_ref = np.asarray(data["ms_se3"]["us"])
    err = np.max(np.abs(np.asarray(us) - us_ref))
    # reference converged J for comparison
    J_ref = float(data["ms_se3"]["J_hist"][-1])
    assert err < 1e-4, f"max |us - us_ref| = {err:.3e}, J={J_hist[-1]:.6f} vs {J_ref:.6f}"


@pytest.mark.parity
def test_ss_se3_tracking_matches_reference():
    data = load_benchmark_pickle(PKL)
    solver, params, x0, us0 = _build(data["prob"], ms=False)
    (qs, xis), us, J_hist, grad_hist, defect_hist, state = solver.fit(
        params, x0, us0, n_iterations=200
    )
    us_ref = np.asarray(data["ss_se3"]["us"])
    err = np.max(np.abs(np.asarray(us) - us_ref))
    J_ref = float(data["ss_se3"]["J_hist"][-1])
    assert err < 1e-4, f"max |us - us_ref| = {err:.3e}, J={J_hist[-1]:.6f} vs {J_ref:.6f}"
