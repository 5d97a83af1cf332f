"""Tests for the Gauss-Newton tracking cost and the AL transformer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajectory_optimization_matrix_lie_groups.models import constraints as cs
from trajectory_optimization_matrix_lie_groups.models import costs
from trajectory_optimization_matrix_lie_groups.ops.group import SE3, SO3

KEY = jax.random.PRNGKey(1)


def _se3_cost(N=5, nu=6):
    k1, k2, k3 = jax.random.split(KEY, 3)
    q_ref = SE3.exp(0.4 * jax.random.normal(k1, (N + 1, 6)))
    xi_ref = 0.3 * jax.random.normal(k2, (N + 1, 6))
    Q = jnp.diag(jnp.concatenate([25.0 * jnp.ones(3), 10.0 * jnp.ones(3), jnp.ones(6)]))
    P = 1.5 * Q
    R = 1e-2 * jnp.eye(nu)
    cd = costs.tracking_cost(SE3, nu)
    cp = costs.tracking_cost_params(SE3, Q, R, P, q_ref, xi_ref)
    return cd, cp, k3


def test_stage_cost_value():
    cd, cp, k = _se3_cost()
    q = SE3.exp(0.2 * jax.random.normal(k, (6,)))
    xi = jnp.arange(6.0) * 0.1
    u = jnp.ones(6) * 0.5
    l = cd.stage_cost(cp, q, xi, u, 2)
    e = SE3.log(q @ SE3.inverse(cp.q_ref[2]))
    ev = xi - cp.xi_ref[2]
    expect = e @ cp.Q1 @ e + ev @ cp.Q2 @ ev + u @ cp.R @ u
    np.testing.assert_allclose(l, expect, rtol=1e-12)


def test_lx_matches_autodiff():
    """l_x must be the exact tangent-space gradient of the cost."""
    cd, cp, k = _se3_cost()
    q = SE3.exp(0.3 * jax.random.normal(k, (6,)))
    xi = jnp.arange(6.0) * 0.1
    u = jnp.zeros(6)

    def l_of_dx(dx):
        return cd.stage_cost(cp, q @ SE3.exp(dx[:6]), xi + dx[6:], u, 2)

    g_ad = jax.grad(l_of_dx)(jnp.zeros(12))
    _, lx, _, _, _, _ = cd.stage_quad(cp, q, xi, u, 2)
    np.testing.assert_allclose(lx, g_ad, atol=1e-9)

    # terminal variant
    def lt_of_dx(dx):
        return cd.term_cost(cp, q @ SE3.exp(dx[:6]), xi + dx[6:], 5)

    gt_ad = jax.grad(lt_of_dx)(jnp.zeros(12))
    _, lxt, _ = cd.term_quad(cp, q, xi, 5)
    np.testing.assert_allclose(lxt, gt_ad, atol=1e-9)


@pytest.mark.slow
def test_lxx_gauss_newton_structure():
    """l_xx is the GN approximation (J^T 2Q J); at zero error it equals the
    true Hessian."""
    cd, cp, k = _se3_cost()
    i = 3
    q = cp.q_ref[i]
    xi = cp.xi_ref[i]
    u = jnp.zeros(6)

    def l_of_dx(dx):
        return cd.stage_cost(cp, q @ SE3.exp(dx[:6]), xi + dx[6:], u, i)

    H_ad = jax.hessian(l_of_dx)(jnp.zeros(12))
    _, _, _, lxx, _, _ = cd.stage_quad(cp, q, xi, u, i)
    np.testing.assert_allclose(lxx, H_ad, atol=1e-7)


def test_so3_cost_lx_autodiff():
    k1, k2, k3 = jax.random.split(KEY, 3)
    N = 4
    q_ref = SO3.exp(0.4 * jax.random.normal(k1, (N + 1, 3)))
    xi_ref = 0.3 * jax.random.normal(k2, (N + 1, 3))
    Q = jnp.diag(jnp.array([3.0, 3.0, 3.0, 1.0, 1.0, 1.0]))
    cd = costs.tracking_cost(SO3, 3)
    cp = costs.tracking_cost_params(SO3, Q, 0.1 * jnp.eye(3), 2 * Q, q_ref, xi_ref)
    q = SO3.exp(0.2 * jax.random.normal(k3, (3,)))
    xi = jnp.array([0.1, -0.2, 0.3])
    u = jnp.array([1.0, 0.0, -1.0])

    def l_of_dx(dx):
        return cd.stage_cost(cp, q @ SO3.exp(dx[:3]), xi + dx[3:], u, 1)

    g_ad = jax.grad(l_of_dx)(jnp.zeros(6))
    _, lx, lu, _, _, _ = cd.stage_quad(cp, q, xi, u, 1)
    np.testing.assert_allclose(lx, g_ad, atol=1e-9)
    np.testing.assert_allclose(lu, 2.0 * cp.R @ u, atol=1e-12)


def test_al_cost_composition():
    """AL wrapper must reproduce LA = l + lambda^T g + 0.5 g^T Imu g and its
    derivative composition (ref traopt_cost.py:1236-1320)."""
    cd, cp, k = _se3_cost()
    N = 5
    constr = cs.input_box(12, 6)
    constr_p = cs.input_box_params(-10.0, 10.0, 6)
    al = costs.al_cost(cd, constr)
    alp = costs.al_init_params(cp, constr_p, N, constr.constr_size, mu0=1e-2)
    # nonzero multipliers to exercise all terms
    alp = alp._replace(lmbd=0.3 * jnp.ones((N + 1, 12)))

    q = SE3.exp(0.2 * jax.random.normal(k, (6,)))
    xi = jnp.arange(6.0) * 0.1
    u = 11.0 * jnp.ones(6)  # violates ub
    i = 2

    g = constr.g(constr_p, q, xi, u, i)
    base_l = cd.stage_cost(cp, q, xi, u, i)
    expect = base_l + alp.lmbd[i] @ g + 0.5 * g @ alp.Imu[i] @ g
    np.testing.assert_allclose(al.stage_cost(alp, q, xi, u, i), expect, rtol=1e-12)

    # lu composition: base + gu^T (lambda + Imu g)
    def l_of_u(uu):
        return al.stage_cost(alp, q, xi, uu, i)

    gu_ad = jax.grad(l_of_u)(u)
    lu2 = al.stage_quad(alp, q, xi, u, i)[2]
    np.testing.assert_allclose(lu2, gu_ad, atol=1e-9)


def test_al_update_params():
    """Multiplier ascent + active-set rebuild (ref traopt_controller.py:3270)."""
    cd, cp, _ = _se3_cost()
    constr = cs.input_box(12, 6)
    constr_p = cs.input_box_params(-1.0, 1.0, 6)
    alp = costs.al_init_params(cp, constr_p, 2, 12, mu0=1e-2)
    g = jnp.concatenate([jnp.full((3, 6), -0.5), jnp.full((3, 6), 0.2)], axis=-1)
    new = costs.al_update_params(alp, g, mu_scale=10.0)
    assert float(new.mu) == 0.1
    # lambda = clip(0 + 1e-2 * g, 0): negative g rows -> 0, positive -> 2e-3
    np.testing.assert_allclose(np.asarray(new.lmbd[:, :6]), 0.0)
    np.testing.assert_allclose(np.asarray(new.lmbd[:, 6:]), 2e-3, rtol=1e-12)
    # inactive (g<0, lmbd==0) entries get 0 penalty; active get mu_new
    diag = np.asarray(jax.vmap(jnp.diag)(new.Imu))
    np.testing.assert_allclose(diag[:, :6], 0.0)
    np.testing.assert_allclose(diag[:, 6:], 0.1, rtol=1e-12)
