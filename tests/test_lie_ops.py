"""Property tests for the SO(3)/SE(3) kernel suite.

Ground truth is (a) closed-form identities (exp/log inverses, adjoint
identities) and (b) jax autodiff of the exponential map — so the tests are
independent of any convention choice made inside the closed forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajectory_optimization_matrix_lie_groups.ops import se3, so3

KEY = jax.random.PRNGKey(0)


def rand_w(key, n, dim, scale=1.0):
    return scale * jax.random.normal(key, (n, dim))


def assert_close(a, b, tol=1e-9):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

class TestSO3:
    def test_hat_vee_roundtrip(self):
        w = rand_w(KEY, 16, 3)
        assert_close(so3.vee(so3.hat(w)), w)

    def test_exp_is_rotation(self):
        w = rand_w(KEY, 32, 3, scale=2.0)
        R = so3.exp(w)
        eye = jnp.broadcast_to(jnp.eye(3), R.shape)
        assert_close(jnp.swapaxes(R, -1, -2) @ R, eye, tol=1e-12)
        assert_close(jnp.linalg.det(R), jnp.ones(32), tol=1e-12)

    @pytest.mark.parametrize("scale", [1e-10, 1e-5, 1.0, 3.0])
    def test_log_exp_roundtrip(self, scale):
        w = rand_w(KEY, 32, 3)
        w = scale * w / jnp.linalg.norm(w, axis=-1, keepdims=True)
        assert_close(so3.log(so3.exp(w)), w, tol=1e-8)

    def test_log_near_pi(self):
        # Angles within 1e-7 of pi: the (R - R^T) formula fails here; the
        # quaternion path must not.
        axis = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [0.6, 0.8, 0.0]])
        for ang in [np.pi - 1e-7, np.pi - 1e-3, np.pi * 0.999999]:
            w = ang * axis
            assert_close(so3.log(so3.exp(w)), w, tol=1e-6)

    def test_exp_at_pi_exactly(self):
        w = jnp.array([np.pi, 0.0, 0.0])
        wl = so3.log(so3.exp(w))
        assert_close(jnp.abs(wl), jnp.abs(w), tol=1e-7)

    def test_left_jacobian_autodiff(self):
        # Exp(w + d) ~ Exp(Jl(w) d) Exp(w)  =>  Jl(w) = d/dd Log(Exp(w+d) Exp(w)^-1)
        def f(d, w):
            return so3.log(so3.exp(w + d) @ so3.inverse(so3.exp(w)))

        for w in [jnp.array([0.3, -0.2, 0.9]), jnp.array([1e-6, 0.0, 0.0]),
                  jnp.array([2.0, 1.0, -0.5])]:
            J_ad = jax.jacfwd(f)(jnp.zeros(3), w)
            assert_close(so3.left_jacobian(w), J_ad, tol=1e-6)

    def test_right_jacobian_autodiff(self):
        # Exp(w + d) ~ Exp(w) Exp(Jr(w) d)
        def f(d, w):
            return so3.log(so3.inverse(so3.exp(w)) @ so3.exp(w + d))

        w = jnp.array([0.7, -1.1, 0.4])
        J_ad = jax.jacfwd(f)(jnp.zeros(3), w)
        assert_close(so3.right_jacobian(w), J_ad, tol=1e-6)

    def test_jacobian_inverses(self):
        w = rand_w(KEY, 16, 3, scale=2.0)
        eye = jnp.broadcast_to(jnp.eye(3), (16, 3, 3))
        assert_close(so3.left_jacobian(w) @ so3.left_jacobian_inv(w), eye, tol=1e-9)
        assert_close(so3.right_jacobian(w) @ so3.right_jacobian_inv(w), eye, tol=1e-9)

    def test_quat_matrix_roundtrip(self):
        w = rand_w(KEY, 32, 3, scale=3.0)
        R = so3.exp(w)
        assert_close(so3.matrix_from_quat(so3.quat_from_matrix(R)), R, tol=1e-12)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

class TestSE3:
    def test_hat_vee_roundtrip(self):
        xi = rand_w(KEY, 16, 6)
        assert_close(se3.vee(se3.hat(xi)), xi)

    def test_exp_matches_expm(self):
        from scipy.linalg import expm

        xi = np.asarray(rand_w(KEY, 8, 6, scale=1.5))
        ours = np.asarray(se3.exp(jnp.asarray(xi)))
        for i in range(8):
            ref = expm(np.asarray(se3.hat(jnp.asarray(xi[i]))))
            np.testing.assert_allclose(ours[i], ref, atol=1e-10)

    @pytest.mark.parametrize("scale", [1e-9, 1e-4, 1.0, 3.0])
    def test_log_exp_roundtrip(self, scale):
        xi = scale * rand_w(KEY, 32, 6)
        # keep the rotation below pi — beyond it Log returns the principal value
        w = xi[..., :3]
        wn = jnp.linalg.norm(w, axis=-1, keepdims=True)
        w = jnp.where(wn > 3.0, w * 3.0 / wn, w)
        xi = jnp.concatenate([w, xi[..., 3:]], axis=-1)
        assert_close(se3.log(se3.exp(xi)), xi, tol=1e-7)

    def test_log_near_pi(self):
        w = (np.pi - 1e-6) * jnp.array([0.0, 0.0, 1.0])
        xi = jnp.concatenate([w, jnp.array([1.0, -2.0, 0.5])])
        assert_close(se3.log(se3.exp(xi)), xi, tol=1e-5)

    def test_inverse(self):
        xi = rand_w(KEY, 8, 6)
        T = se3.exp(xi)
        eye = jnp.broadcast_to(jnp.eye(4), T.shape)
        assert_close(T @ se3.inverse(T), eye, tol=1e-12)

    def test_Ad_identity(self):
        # T Exp(xi) T^-1 = Exp(Ad(T) xi)
        key1, key2 = jax.random.split(KEY)
        T = se3.exp(rand_w(key1, 4, 6))
        xi = rand_w(key2, 4, 6, scale=0.5)
        lhs = T @ se3.exp(xi) @ se3.inverse(T)
        rhs = se3.exp((se3.Ad(T) @ xi[..., None])[..., 0])
        assert_close(lhs, rhs, tol=1e-9)

    def test_ad_is_Ad_derivative(self):
        # Ad(Exp(t xi)) = expm(t ad(xi))
        from scipy.linalg import expm

        xi = np.asarray(rand_w(KEY, 1, 6))[0]
        lhs = np.asarray(se3.Ad(se3.exp(jnp.asarray(xi))))
        rhs = expm(np.asarray(se3.ad(jnp.asarray(xi))))
        np.testing.assert_allclose(lhs, rhs, atol=1e-10)

    def test_left_jacobian_autodiff(self):
        def f(d, xi):
            return se3.log(se3.exp(xi + d) @ se3.inverse(se3.exp(xi)))

        for xi in [jnp.array([0.3, -0.2, 0.9, 1.0, -0.5, 2.0]),
                   jnp.array([1e-7, 0.0, 0.0, 0.1, 0.2, 0.3]),
                   jnp.array([1.5, 1.0, -0.5, -2.0, 0.7, 0.1])]:
            J_ad = jax.jacfwd(f)(jnp.zeros(6), xi)
            assert_close(se3.left_jacobian(xi), J_ad, tol=1e-6)

    def test_right_jacobian_autodiff(self):
        def f(d, xi):
            return se3.log(se3.inverse(se3.exp(xi)) @ se3.exp(xi + d))

        xi = jnp.array([0.7, -1.1, 0.4, 0.2, 1.3, -0.6])
        J_ad = jax.jacfwd(f)(jnp.zeros(6), xi)
        assert_close(se3.right_jacobian(xi), J_ad, tol=1e-6)

    def test_jacobian_inverses(self):
        xi = rand_w(KEY, 16, 6, scale=2.0)
        eye = jnp.broadcast_to(jnp.eye(6), (16, 6, 6))
        assert_close(se3.left_jacobian(xi) @ se3.left_jacobian_inv(xi), eye, tol=1e-8)
        assert_close(se3.right_jacobian(xi) @ se3.right_jacobian_inv(xi), eye, tol=1e-8)

    def test_rminus_rplus_roundtrip(self):
        key1, key2 = jax.random.split(KEY)
        X = se3.exp(rand_w(key1, 8, 6))
        tau = rand_w(key2, 8, 6, scale=0.5)
        assert_close(se3.rminus(se3.rplus(X, tau), X), tau, tol=1e-9)

    def test_lminus_jacobian_autodiff(self):
        # Right-perturbation Jacobian of e(X) = Log(X Y^-1), the quantity the
        # reference gets from manif's lminus (traopt_cost.py:778) and we
        # compute as Jr_inv(e) @ Ad(Y).
        key1, key2 = jax.random.split(KEY)
        X = se3.exp(rand_w(key1, 1, 6))[0]
        Y = se3.exp(rand_w(key2, 1, 6))[0]

        def f(d):
            return se3.lminus(X @ se3.exp(d), Y)

        J_ad = jax.jacfwd(f)(jnp.zeros(6))
        e = se3.lminus(X, Y)
        J_closed = se3.right_jacobian_inv(e) @ se3.Ad(Y)
        assert_close(J_closed, J_ad, tol=1e-6)

    def test_quatpos_roundtrip(self):
        T = se3.exp(rand_w(KEY, 8, 6, scale=2.0))
        assert_close(se3.matrix_from_quatpos(se3.quatpos_from_matrix(T)), T, tol=1e-12)


def test_jit_and_vmap_compose():
    xi = rand_w(KEY, 128, 6)
    f = jax.jit(jax.vmap(lambda x: se3.log(se3.exp(x))))
    assert_close(f(xi), xi, tol=1e-8)
