"""Finite-difference / autodiff checks for the dynamics models.

Jacobians are on the tangent space: Fx = d( f(x (+) dx) (-) f(x) )/d(dx) with
(+)/(-) the group rplus/rminus on the pose part and plain +/- on the twist —
exactly the object the reference assembles from manif Jacobians.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajectory_optimization_matrix_lie_groups.models import dynamics as dyn
from trajectory_optimization_matrix_lie_groups.ops.group import SE3, SO3

KEY = jax.random.PRNGKey(42)


def tangent_jacobian(group, step, q, xi, u, i):
    """Autodiff ground truth for (Fx, Fu) in tangent coordinates."""
    d = group.dim

    def f_of_dx(dx):
        qp = group.rplus(q, dx[:d])
        xip = xi + dx[d:]
        qn, xin = step(qp, xip, u, i)
        qn0, xin0 = step(q, xi, u, i)
        return jnp.concatenate([group.rminus(qn, qn0), xin - xin0])

    def f_of_du(du):
        qn, xin = step(q, xi, u + du, i)
        qn0, xin0 = step(q, xi, u, i)
        return jnp.concatenate([group.rminus(qn, qn0), xin - xin0])

    Fx = jax.jacfwd(f_of_dx)(jnp.zeros(2 * d))
    Fu = jax.jacfwd(f_of_du)(jnp.zeros(u.shape[-1]))
    return Fx, Fu


def _rand_state(key, group):
    k1, k2, k3 = jax.random.split(key, 3)
    q = group.exp(0.7 * jax.random.normal(k1, (group.dim,)))
    xi = 0.5 * jax.random.normal(k2, (group.dim,))
    return q, xi, k3


@pytest.mark.parametrize("seed", [0, 1])
def test_so3_jacobians(seed):
    p = dyn.so3_params(jnp.diag(jnp.array([0.5, 0.7, 0.9])), 0.01)
    q, xi, ku = _rand_state(jax.random.PRNGKey(seed), SO3)
    u = jax.random.normal(ku, (3,))
    Fx, Fu = dyn._so3_jac(p, q, xi, u, 0)
    Fx_ad, Fu_ad = tangent_jacobian(
        SO3, lambda q, xi, u, i: dyn._so3_step(p, q, xi, u, i), q, xi, u, 0
    )
    # Pose rows are exact manif identities; velocity rows of the reference are
    # the continuous-time linearization (exact for this Euler scheme).
    np.testing.assert_allclose(Fx, Fx_ad, atol=1e-8)
    np.testing.assert_allclose(Fu, Fu_ad, atol=1e-8)


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_jacobians(seed):
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), 1.0 * jnp.eye(3)],
    ])
    p = dyn.se3_params(J, 0.004, ref_coad_swap=False)
    q, xi, ku = _rand_state(jax.random.PRNGKey(seed), SE3)
    u = jax.random.normal(ku, (6,))
    Fx, Fu = dyn._se3_jac(p, q, xi, u, 0)
    Fx_ad, Fu_ad = tangent_jacobian(
        SE3, lambda q, xi, u, i: dyn._se3_step(p, q, xi, u, i), q, xi, u, 0
    )
    np.testing.assert_allclose(Fx, Fx_ad, atol=1e-8)
    np.testing.assert_allclose(Fu, Fu_ad, atol=1e-8)


def test_pendulum3d_jacobians():
    p = dyn.pendulum3d_params(jnp.diag(jnp.array([0.3, 0.4, 0.5])), 1.2, 0.8, 0.01)
    q, xi, ku = _rand_state(jax.random.PRNGKey(7), SO3)
    u = jax.random.normal(ku, (3,))
    Fx, Fu = dyn._pendulum3d_jac(p, q, xi, u, 0)
    Fx_ad, Fu_ad = tangent_jacobian(
        SO3, lambda q, xi, u, i: dyn._pendulum3d_step(p, q, xi, u, i), q, xi, u, 0
    )
    np.testing.assert_allclose(Fx, Fx_ad, atol=1e-8)
    np.testing.assert_allclose(Fu, Fu_ad, atol=1e-8)


def test_rigid_body_exact_gravity_jacobian():
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), 2.0 * jnp.eye(3)],
    ])
    p = dyn.rigid_body_params(J, 0.01, exact_gravity_jacobian=True, ref_coad_swap=False)
    q, xi, ku = _rand_state(jax.random.PRNGKey(3), SE3)
    u = jax.random.normal(ku, (6,))
    Fx, Fu = dyn._rigid_body_jac(p, q, xi, u, 0)
    Fx_ad, Fu_ad = tangent_jacobian(
        SE3, lambda q, xi, u, i: dyn._rigid_body_step(p, q, xi, u, i), q, xi, u, 0
    )
    np.testing.assert_allclose(Fx, Fx_ad, atol=1e-8)
    np.testing.assert_allclose(Fu, Fu_ad, atol=1e-8)


def test_rigid_body_reference_gravity_quirk():
    """The reference-compatible mode omits the m*g factor in the gravity block
    (traopt_dynamics.py:1121-1134); verify the two modes differ by exactly it."""
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), 2.0 * jnp.eye(3)],
    ])
    q, xi, _ = _rand_state(jax.random.PRNGKey(3), SE3)
    u = jnp.zeros(6)
    p_ref = dyn.rigid_body_params(J, 0.01, exact_gravity_jacobian=False)
    p_ex = dyn.rigid_body_params(J, 0.01, exact_gravity_jacobian=True)
    Fx_ref, _ = dyn._rigid_body_jac(p_ref, q, xi, u, 0)
    Fx_ex, _ = dyn._rigid_body_jac(p_ex, q, xi, u, 0)
    blk_ref = Fx_ref[9:12, 0:3]
    blk_ex = Fx_ex[9:12, 0:3]
    np.testing.assert_allclose(np.asarray(blk_ex), np.asarray(2.0 * 9.8 * blk_ref), atol=1e-10)


def test_drone_input_projection():
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), 1.5 * jnp.eye(3)],
    ])
    p = dyn.drone_params(J, 0.004, exact_gravity_jacobian=True, ref_coad_swap=False)
    q, xi, ku = _rand_state(jax.random.PRNGKey(5), SE3)
    u = jax.random.normal(ku, (4,))
    Fx, Fu = dyn._rigid_body_jac(p, q, xi, u, 0)
    assert Fu.shape == (12, 4)
    Fx_ad, Fu_ad = tangent_jacobian(
        SE3, lambda q, xi, u, i: dyn._rigid_body_step(p, q, xi, u, i), q, xi, u, 0
    )
    np.testing.assert_allclose(Fx, Fx_ad, atol=1e-8)
    np.testing.assert_allclose(Fu, Fu_ad, atol=1e-8)


def test_ref_coad_swap_quirk():
    """ref_coad_swap=True reproduces the reference's f_x quirk
    (traopt_dynamics.py:819,832): H built from coad of the [v, w]-swapped
    twist.  Verified against the stored benchmark gradient in
    test_parity_se3; here just check the two modes differ only in the
    velocity-velocity block."""
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), 1.0 * jnp.eye(3)],
    ])
    q, xi, ku = _rand_state(jax.random.PRNGKey(11), SE3)
    u = jnp.zeros(6)
    Fx_ref, _ = dyn._se3_jac(dyn.se3_params(J, 0.004, ref_coad_swap=True), q, xi, u, 0)
    Fx_ex, _ = dyn._se3_jac(dyn.se3_params(J, 0.004, ref_coad_swap=False), q, xi, u, 0)
    np.testing.assert_allclose(np.asarray(Fx_ref[:6]), np.asarray(Fx_ex[:6]), atol=1e-14)
    assert np.abs(np.asarray(Fx_ref[6:, 6:]) - np.asarray(Fx_ex[6:, 6:])).max() > 1e-6


def test_batched_equals_single():
    """The whole-horizon batched call must equal per-stage evaluation."""
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), 1.0 * jnp.eye(3)],
    ])
    p = dyn.se3_params(J, 0.004)
    k1, k2, k3 = jax.random.split(KEY, 3)
    qs = SE3.exp(0.5 * jax.random.normal(k1, (10, 6)))
    xis = 0.3 * jax.random.normal(k2, (10, 6))
    us = jax.random.normal(k3, (10, 6))
    qn_b, xin_b = dyn._se3_step(p, qs, xis, us, jnp.arange(10))
    Fx_b, Fu_b = dyn._se3_jac(p, qs, xis, us, jnp.arange(10))
    for i in range(10):
        qn, xin = dyn._se3_step(p, qs[i], xis[i], us[i], i)
        Fx, Fu = dyn._se3_jac(p, qs[i], xis[i], us[i], i)
        np.testing.assert_allclose(qn_b[i], qn, atol=1e-14)
        np.testing.assert_allclose(xin_b[i], xin, atol=1e-14)
        np.testing.assert_allclose(Fx_b[i], Fx, atol=1e-14)
        np.testing.assert_allclose(Fu_b[i], Fu, atol=1e-14)
