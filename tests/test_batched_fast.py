"""FastBatchSolver (batch-explicit XLA scan) vs the reference engine."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.solvers.batched import FastBatchSolver
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR
from trajectory_optimization_matrix_lie_groups.tasks.parity import build_benchmark


def test_fast_batch_matches_engine():
    data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    H, ITERS, B = 40, 5, 3
    cp = solver.model  # LieModel
    cfg = dataclasses.replace(solver.cfg, N=H, max_iterations=ITERS,
                              tol_grad_norm=0.0, tol_d_norm=0.0,
                              backward="sequential_fixed")
    engine = LieILQR(solver.model, cfg)
    cpar = params["cost"]
    cut = lambda a: a[: H + 1]
    params = {**params, "cost": cpar._replace(
        q_ref=cut(cpar.q_ref), q_ref_inv=cut(cpar.q_ref_inv),
        Ad_ref=cut(cpar.Ad_ref), xi_ref=cut(cpar.xi_ref))}
    q_ref = params["cost"].q_ref
    xi_ref = params["cost"].xi_ref

    key = jax.random.PRNGKey(0)
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3

    dq = 0.05 * jax.random.normal(key, (B, 6))
    q0s = SE3.normalize(q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(xi_ref[0], (B, 6))
    us0s = jnp.zeros((B, H, 6))

    fast = FastBatchSolver(solver.model, N=H, iterations=ITERS)
    out = fast.solve(params, q0s, xi0s, us0s, q_ref, xi_ref)

    # reference engine, lane by lane
    for b in range(B):
        st = engine._init_state_ms(q0s[b], xi0s[b], us0s[b], q_ref, xi_ref)
        st = engine._solve_jit(params, st)
        np.testing.assert_allclose(np.asarray(out.us[b]), np.asarray(st.us),
                                   atol=1e-8)


def test_fast_batch_line_search_matches_engine():
    """line_search=True: per-lane batched merit search == LieILQR's merit
    loop (same accept rule, d_weight schedule, alpha ladder), lane by lane."""
    data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    H, ITERS, B, NA = 40, 6, 3, 13
    cfg = dataclasses.replace(solver.cfg, N=H, max_iterations=ITERS,
                              tol_grad_norm=0.0, tol_d_norm=0.0,
                              backward="sequential_fixed", line_search=True,
                              rollout="nonlinear", n_alphas=NA)
    engine = LieILQR(solver.model, cfg)
    cpar = params["cost"]
    cut = lambda a: a[: H + 1]
    params = {**params, "cost": cpar._replace(
        q_ref=cut(cpar.q_ref), q_ref_inv=cut(cpar.q_ref_inv),
        Ad_ref=cut(cpar.Ad_ref), xi_ref=cut(cpar.xi_ref))}
    q_ref = params["cost"].q_ref
    xi_ref = params["cost"].xi_ref

    from trajectory_optimization_matrix_lie_groups.ops.group import SE3

    # large perturbations so short alphas actually get selected
    dq = 0.4 * jax.random.normal(jax.random.PRNGKey(3), (B, 6))
    q0s = SE3.normalize(q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(xi_ref[0], (B, 6)) + 0.3
    us0s = jnp.zeros((B, H, 6))

    fast = FastBatchSolver(solver.model, N=H, iterations=ITERS,
                           line_search=True, n_alphas=NA)
    out = fast.solve(params, q0s, xi0s, us0s, q_ref, xi_ref)

    for b in range(B):
        st = engine._init_state_ms(q0s[b], xi0s[b], us0s[b], q_ref, xi_ref)
        for _ in range(ITERS):
            st = engine._iteration_jit(params, st)
        np.testing.assert_allclose(np.asarray(out.us[b]), np.asarray(st.us),
                                   atol=1e-8)
        np.testing.assert_allclose(np.asarray(out.xis[b]), np.asarray(st.xis),
                                   atol=1e-8)


def test_fast_batch_drone_nu4():
    """nu=4 (drone) exercises the nu-parameterized Riccati kernel."""
    data, solver, params, x0, us0, _ = build_benchmark("drone_racing", True)
    H, ITERS, B = 30, 4, 2
    cfg = dataclasses.replace(solver.cfg, N=H, max_iterations=ITERS,
                              tol_grad_norm=0.0, tol_d_norm=0.0,
                              backward="sequential_fixed")
    engine = LieILQR(solver.model, cfg)
    cpar = params["cost"]
    cut = lambda a: a[: H + 1]
    params = {**params, "cost": cpar._replace(
        q_ref=cut(cpar.q_ref), q_ref_inv=cut(cpar.q_ref_inv),
        Ad_ref=cut(cpar.Ad_ref), xi_ref=cut(cpar.xi_ref))}
    q_ref = params["cost"].q_ref
    xi_ref = params["cost"].xi_ref

    key = jax.random.PRNGKey(1)
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3

    dq = 0.03 * jax.random.normal(key, (B, 6))
    q0s = SE3.normalize(q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(xi_ref[0], (B, 6))
    us0s = jnp.zeros((B, H, 4))

    fast = FastBatchSolver(solver.model, N=H, iterations=ITERS)
    out = fast.solve(params, q0s, xi0s, us0s, q_ref, xi_ref)

    for b in range(B):
        st = engine._init_state_ms(q0s[b], xi0s[b], us0s[b], q_ref, xi_ref)
        st = engine._solve_jit(params, st)
        np.testing.assert_allclose(np.asarray(out.us[b]), np.asarray(st.us),
                                   atol=1e-8)
