"""Error-state SE(3) solver family tests.

Generation task mirrors `main_errSE3ddp_nonlinear_rollout_generation.py`:
reach a goal pose from a spinning initial guess via the iterated
error-state scheme with anchor re-initialization.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models import errorstate as es
from trajectory_optimization_matrix_lie_groups.ops import se3
from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.solvers.errorstate_ilqr import (
    ErrorStateILQR,
    ESConfig,
)


def _params(N=60, dt=0.01, key=0):
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), jnp.eye(3)],
    ])
    q0 = jnp.eye(4)
    xi0 = jnp.array([0.3, 0.2, 0.5, 1.0, 1.0, 1.0])
    us0 = jnp.zeros((N, 6))
    p0 = es.errorstate_params(J, dt, jnp.zeros((N + 1, 4, 4)), jnp.zeros((N + 1, 6)))
    qs, xis = es.rollout_nominal(p0, q0, xi0, us0)
    return es.reanchor(p0, qs, xis), us0, q0, xi0


def test_errorstate_step_matches_reference_structure():
    """fd_euler of the error-state linearization: check At/ht structure at
    x = [0; xi_ref] equals the exact dynamics step in the velocity part."""
    p, us0, q0, xi0 = _params()
    x = jnp.concatenate([jnp.zeros(6), p.xi_ref[0]])
    u = jnp.ones(6)
    x_next = es.step_euler(p, x, u, 0)
    # velocity part must equal the exact group dynamics velocity update
    _, xi_next_exact = es.group_step(p, q0, p.xi_ref[0], u, 0)
    np.testing.assert_allclose(np.asarray(x_next[6:]), np.asarray(xi_next_exact), atol=1e-12)
    # error part: psi_dot = -ad(xi_ref) 0 + xi - xi_ref = 0 at the anchor
    np.testing.assert_allclose(np.asarray(x_next[:6]), 0.0, atol=1e-12)


def test_goal_cost_phi_closed_form():
    """phi_goal via closed-form Log must equal scipy logm."""
    from scipy.linalg import logm

    p, *_ = _params(N=5)
    X_goal = se3.exp(jnp.array([0.2, -0.1, 0.4, 3.0, -1.0, 2.0]))
    cp = es.goal_cost_params(jnp.eye(6), jnp.eye(6), jnp.eye(6), p.q_ref, X_goal)
    for i in [0, 3, 5]:
        M = logm(np.asarray(se3.inverse(p.q_ref[i]) @ X_goal))
        ref = np.asarray(se3.vee(jnp.asarray(M.real)))
        np.testing.assert_allclose(np.asarray(cp.phi_goal[i]), ref, atol=1e-9)


@pytest.mark.parity
def test_generation_nonlinear_reaches_goal():
    """Iterated error-state generation (ref main_errSE3ddp_nonlinear_rollout_
    generation.py config, shortened): final pose must approach the goal."""
    N, dt = 150, 0.01
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), jnp.eye(3)],
    ])
    R_goal = SE3.exp(jnp.array([0.0, 0.0, jnp.pi / 4, 0.0, 0.0, 0.0]))
    X_goal = R_goal.at[:3, 3].set(jnp.array([5.0, 5.0, 5.0]))
    q0 = jnp.eye(4)
    xi0 = jnp.concatenate([
        jnp.array([0.0, 0.0, jnp.pi / 4]) / (N * dt) + 0.3,
        jnp.array([5.0, 5.0, 5.0]) / (N * dt) + jnp.array([0.5, 0.5, -0.5]),
    ])
    us0 = jnp.zeros((N, 6))
    p0 = es.errorstate_params(J, dt, jnp.zeros((N + 1, 4, 4)), jnp.zeros((N + 1, 6)))
    qs, xis = es.rollout_nominal(p0, q0, xi0, us0)
    params = es.reanchor(p0, qs, xis)

    Q = jnp.eye(6) * 1.0
    P = jnp.eye(6) * 1e7
    Rm = jnp.eye(6) * 1e3
    cp = es.goal_cost_params(Q, Rm, P, params.q_ref, X_goal)

    cfg = ESConfig(N=N, mode="generation_nonlinear", n_alphas=15,
                   tol_grad_norm=1e-3, max_iterations=60)

    def reanchor_cost(cost_params, qs_new):
        return es.goal_cost_params(Q, Rm, P, qs_new, X_goal)

    solver = ErrorStateILQR(cfg, es.goal_cost, reanchor_cost=reanchor_cost)
    state, J_hist, grad_hist, _ = solver.fit(cp, params, us0)

    final_err = se3.log(se3.inverse(state.qs[-1]) @ X_goal)
    assert J_hist[-1] < J_hist[0]
    assert float(jnp.linalg.norm(final_err)) < 0.1, (
        f"final pose error {np.asarray(final_err)}"
    )


def test_tracking_errorstate_linear_rollout():
    """Error-state tracking with LTV rollout descends and stays bounded."""
    p, us0, q0, xi0 = _params(N=50)
    cp = es.ErrorStateTrackingCostParams(
        Q=jnp.eye(12), R=1e-3 * jnp.eye(6), P=10.0 * jnp.eye(12), xi_ref=p.xi_ref
    )
    cfg = ESConfig(N=50, mode="tracking", rollout="linear", n_alphas=10,
                   tol_grad_norm=1e-6, max_iterations=30)
    solver = ErrorStateILQR(cfg, es.tracking_cost_es)
    state, J_hist, grad_hist, _ = solver.fit(cp, p, us0)
    assert np.isfinite(J_hist[-1])
    assert J_hist[-1] <= J_hist[0]


def test_derivative_compare_runtime_flag():
    """Round-2 VERDICT item 10: the runtime analytic-vs-autodiff Jacobian
    check (the reference's debug={'derivative_compare': True},
    traopt_controller.py:3585-3624).  For the EULER step the analytic
    At is the *exact* Jacobian everywhere (the G terms cancel in
    fc_errstate and coad(xi)J + G(xi) is the exact derivative of
    coad(xi)Jxi — see models/errorstate.jac_analytic), so the check must
    agree to roundoff both at and off the anchor; a genuine deviation
    only appears for the RK4 step, where the analytic form stays the
    first-order I + At dt, and there the check must WARN, not fail (the
    reference's failure branch was `pass`)."""
    import warnings

    N, dt = 20, 0.01
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), jnp.eye(3)],
    ])
    q_ref = jnp.broadcast_to(jnp.eye(4), (N + 1, 4, 4))
    xi_ref = jnp.broadcast_to(jnp.asarray([0.1, -0.2, 0.3, 1.0, 0.0, 0.5]),
                              (N + 1, 6))
    p = es.errorstate_params(J, dt, q_ref, xi_ref)
    cfg = ESConfig(N=N, mode="tracking", derivative_compare=True)
    solver = ErrorStateILQR(cfg, cost=lambda *a, **k: 0.0)

    # trajectory AT the anchor: x = [psi = 0; xi = xi_ref]
    xs = jnp.concatenate([jnp.zeros((N + 1, 6)),
                          jnp.asarray(p.xi_ref)], axis=-1)
    us = jnp.zeros((N, 6))
    rep = solver.derivative_compare(p, xs, us)
    assert rep["fu_max_dev"] < 1e-12
    assert rep["fx_max_dev"] < 1e-12  # Euler analytic Jacobian is exact
    assert rep["within_tol"]

    # off-anchor the Euler analytic Jacobian is STILL exact
    xs_off = xs.at[:, 6:].add(0.5)
    rep_off = solver.derivative_compare(p, xs_off, us, tol=1e-9)
    assert rep_off["within_tol"], rep_off

    # RK4: the analytic form drops the O(dt^2) composition terms — a real,
    # documented deviation; the check warns and reports it
    solver_rk4 = ErrorStateILQR(cfg, cost=lambda *a, **k: 0.0,
                                step=es.step_rk4)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rep_rk4 = solver_rk4.derivative_compare(p, xs_off, us, tol=1e-9)
    assert not rep_rk4["within_tol"]
    assert rep_rk4["fx_max_dev"] > 1e-9  # O(dt^2) gap is real
    assert np.isfinite(rep_rk4["fx_max_dev"])
    assert any("derivative_compare" in str(x.message) for x in w)
