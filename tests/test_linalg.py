"""Unrolled small-matrix Cholesky solve vs LAPACK."""

import numpy as np

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.utils.linalg import (
    chol_solve_psd,
    setup_inv,
)


def _spd(key, b, n, dtype):
    A = jax.random.normal(key, (b, n, n), dtype=dtype)
    return A @ jnp.swapaxes(A, -1, -2) + n * jnp.eye(n, dtype=dtype)


def test_chol_solve_matches_lu():
    for n in (3, 6, 12):
        key = jax.random.PRNGKey(n)
        k1, k2, k3 = jax.random.split(key, 3)
        A = _spd(k1, 4, n, jnp.float64)
        B = jax.random.normal(k2, (4, n, 5), dtype=jnp.float64)
        v = jax.random.normal(k3, (4, n), dtype=jnp.float64)
        np.testing.assert_allclose(np.asarray(chol_solve_psd(A, B)),
                                   np.asarray(jnp.linalg.solve(A, B)),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(chol_solve_psd(A, v)),
            np.asarray(jnp.linalg.solve(A, v[..., None])[..., 0]),
            rtol=1e-10, atol=1e-12)


def test_chol_solve_jit_grad():
    A = _spd(jax.random.PRNGKey(0), 2, 6, jnp.float64)
    v = jnp.ones((2, 6), jnp.float64)
    f = jax.jit(lambda A, v: jnp.sum(chol_solve_psd(A, v) ** 2))
    g = jax.grad(f)(A, v)
    assert np.all(np.isfinite(np.asarray(g)))


def test_setup_inv():
    J = np.diag([0.5, 0.7, 0.9]).astype(np.float32)
    out = setup_inv(J)
    assert out.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out, np.float64) @ J.astype(np.float64),
                               np.eye(3), atol=1e-6)

    # tracer fallback
    f = jax.jit(setup_inv)
    np.testing.assert_allclose(np.asarray(f(jnp.asarray(J, jnp.float64))),
                               np.linalg.inv(J.astype(np.float64)), atol=1e-12)
