"""Batched AL fast solver: input-box constrained SE(3) tracking for a batch
of perturbed starts in one SPMD program (solvers/al_fast.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models import (
    constraints as cs,
    costs,
    dynamics,
)
from trajectory_optimization_matrix_lie_groups.models.base import make_model
from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.solvers.al_fast import ALFastSolver
from trajectory_optimization_matrix_lie_groups.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups.utils import load_benchmark_pickle

PKL = "/root/reference/visualization/results_benchmark_2nd_draft/results_se3_tracking_benchmark.pkl"


@pytest.mark.parity
def test_al_fast_batched_input_box():
    data = load_benchmark_pickle(PKL)
    prob = data["prob"]
    H, B = 60, 4
    q_ref = jnp.asarray(np.asarray(prob["q_ref"])[: H + 1])
    xi_ref = jnp.asarray(np.asarray(prob["xi_ref"])[: H + 1].reshape(H + 1, 6))

    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(prob["J"]), float(prob["dt"]))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(SE3, prob["Q"], prob["R"], prob["P"],
                                    q_ref, xi_ref)

    dq = 0.03 * jax.random.normal(jax.random.PRNGKey(2), (B, 6))
    q0s = SE3.normalize(q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(xi_ref[0], (B, 6)) + 0.05
    us0 = jnp.zeros((B, H, 6))

    # unconstrained batched solve: must violate the box for every problem
    model_u, params_u = make_model(dyn, cd, dp, cp)
    unc = FastBatchSolver(model_u, N=H, iterations=25)
    st_u = unc.solve(params_u, q0s, xi0s, us0, q_ref, xi_ref)
    lb, ub = -100.0, 100.0
    per_prob_max = jnp.max(jnp.abs(st_u.us), axis=(1, 2))
    assert float(jnp.min(per_prob_max)) > ub, "constraint not exercised"

    # batched AL solve
    constr = cs.input_box(12, 6)
    constr_p = cs.input_box_params(lb, ub, 6)
    al_cd = costs.al_cost(cd, constr)
    model_c, _ = make_model(dyn, al_cd, dp, None)
    alp = costs.al_init_params(cp, constr_p, H, constr.constr_size, mu0=1e-2)
    inner = FastBatchSolver(model_c, N=H, iterations=25)
    al = ALFastSolver(inner, constr, tol_constr=1e-2)
    res = al.solve({"dyn": dp, "cost": alp}, q0s, xi0s, us0,
                   q_ref=q_ref, xi_ref=xi_ref, n_al_iters=15)

    assert res.constr_converged, (
        f"AL not converged in {res.outer_iterations} outers; "
        f"violations {np.asarray(res.max_violation)}")
    assert float(jnp.max(res.constr_eval)) < 1e-2
    assert float(jnp.max(res.us)) <= ub + 1e-2
    assert float(jnp.min(res.us)) >= lb - 1e-2
    # multipliers became per-problem after the first update
    assert res.al_params.lmbd.shape == (B, H + 1, constr.constr_size)
    # constrained costs exceed unconstrained (box binds), all finite
    assert bool(jnp.all(jnp.isfinite(res.J_opt)))
    assert bool(jnp.all(res.J_opt >= st_u.J_opt - 1e-6))


@pytest.mark.parity
def test_al_fast_rescue_hard_lane():
    """rescue=True re-solves lanes the fast inner cannot converge.

    Lane construction: PRNGKey(2) draw index 9 over B=32 is a start whose
    unconstrained optimum is far outside the box; the fixed-budget inner
    limit-cycles on it (violation plateaus ~75) while the line-searched
    batched inner converges it — all failing lanes re-solved as one
    batched program (see solvers/al_fast.ALFastSolver.solve docstring).
    """
    data = load_benchmark_pickle(PKL)
    prob = data["prob"]
    H = 60
    q_ref = jnp.asarray(np.asarray(prob["q_ref"])[: H + 1])
    xi_ref = jnp.asarray(np.asarray(prob["xi_ref"])[: H + 1].reshape(H + 1, 6))
    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(prob["J"]), float(prob["dt"]))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(SE3, prob["Q"], prob["R"], prob["P"],
                                    q_ref, xi_ref)
    lb, ub = -100.0, 100.0
    constr = cs.input_box(12, 6)
    al_cd = costs.al_cost(cd, constr)
    model_c, _ = make_model(dyn, al_cd, dp, None)
    alp = costs.al_init_params(cp, cs.input_box_params(lb, ub, 6), H,
                               constr.constr_size, mu0=1e-2)

    dq32 = 0.03 * jax.random.normal(jax.random.PRNGKey(2), (32, 6))
    q0s32 = SE3.normalize(q_ref[0][None] @ SE3.exp(dq32))
    q0s = q0s32[jnp.asarray([0, 9])]  # easy lane + hard lane
    xi0s = jnp.broadcast_to(xi_ref[0], (2, 6)) + 0.05
    us0 = jnp.zeros((2, H, 6))

    inner = FastBatchSolver(model_c, N=H, iterations=25)
    al = ALFastSolver(inner, constr, tol_constr=1e-2)
    res0 = al.solve({"dyn": dp, "cost": alp}, q0s, xi0s, us0,
                    q_ref=q_ref, xi_ref=xi_ref, n_al_iters=15)
    assert not res0.constr_converged  # the hard lane defeats the fast inner

    res = al.solve({"dyn": dp, "cost": alp}, q0s, xi0s, us0,
                   q_ref=q_ref, xi_ref=xi_ref, n_al_iters=15, rescue=True)
    assert res.constr_converged
    assert float(jnp.max(res.max_violation)) < 1e-2
    assert float(res.us.max()) <= ub + 1e-2
    assert float(res.us.min()) >= lb - 1e-2
