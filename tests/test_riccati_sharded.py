"""Time-axis-sharded Riccati backward (parallel/riccati_sharded.py):
the two-level (local scan + cross-device aggregate) suffix sweep must
match the single-device associative sweep — the last §2.6 parallelism
box (horizon sharding for very long N, ref N up to 1400)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from trajectory_optimization_matrix_lie_groups.parallel.riccati_sharded import (
    sharded_parallel_backward,
)
from trajectory_optimization_matrix_lie_groups.solvers import riccati

pytestmark = pytest.mark.multidevice


def _random_ltv(N, n, m, seed=0, dtype=jnp.float64):
    """A stable random LTV problem with PD cost blocks."""
    rng = np.random.default_rng(seed)
    Fx = jnp.asarray(np.eye(n) + 0.02 * rng.normal(size=(N, n, n)), dtype)
    Fu = jnp.asarray(0.1 * rng.normal(size=(N, n, m)), dtype)
    d = jnp.asarray(0.01 * rng.normal(size=(N, n)), dtype)
    Lx = jnp.asarray(rng.normal(size=(N + 1, n)), dtype)
    Lu = jnp.asarray(rng.normal(size=(N, m)), dtype)
    mk_pd = lambda k, s: np.einsum("nij,nkj->nik", s, s) + np.eye(k)
    Lxx = jnp.asarray(mk_pd(n, rng.normal(size=(N + 1, n, n))), dtype)
    Luu = jnp.asarray(mk_pd(m, rng.normal(size=(N, m, m))), dtype)
    Lux = jnp.asarray(0.1 * rng.normal(size=(N, m, n)), dtype)
    return Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu


def _mesh(n=8):
    return Mesh(np.asarray(jax.devices()[:n]), ("time",))


@pytest.mark.slow
@pytest.mark.parametrize("N", [13])
def test_sharded_matches_single_device(N):
    """N+1 elements across a 2-device mesh (non-divisible horizon
    exercises the identity-element padding) must reproduce the one-device
    sweep.  Slow tier since round 4 (~54 s of XLA:CPU compile; the
    production wiring stays default-covered by
    test_lie_ilqr_backward_associative_sharded); the 8-device + larger-N
    variants also run in the
    `slow` tier."""
    prob = _random_ltv(N, n=4, m=2, seed=N)
    k1, K1, Vx1, Vxx1 = riccati.parallel_backward(*prob, mu=0.1)
    k2, K2, Vx2, Vxx2 = sharded_parallel_backward(*prob, mesh=_mesh(2),
                                                  mu=0.1)
    np.testing.assert_allclose(np.asarray(k2), np.asarray(k1),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(K2), np.asarray(K1),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(Vx2), np.asarray(Vx1),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(Vxx2), np.asarray(Vxx1),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.slow
@pytest.mark.parametrize("N", [31, 64, 120])
def test_sharded_matches_single_device_more(N):
    """Divisible and larger horizons at the SE(3)-like sizes."""
    prob = _random_ltv(N, n=6, m=3, seed=N)
    k1, K1, Vx1, Vxx1 = riccati.parallel_backward(*prob, mu=0.1)
    k2, K2, Vx2, Vxx2 = sharded_parallel_backward(*prob, mesh=_mesh(),
                                                  mu=0.1)
    np.testing.assert_allclose(np.asarray(k2), np.asarray(k1),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(Vxx2), np.asarray(Vxx1),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.slow
def test_sharded_al_scale_horizon():
    """The AL task scale (N=1400, `main_SE3ddp_tracking_exact_al_ms.py:50`)
    sharded across the mesh agrees with the sequential-equivalent
    single-device scan at n=12 (the SE(3) state dim)."""
    N = 1400
    prob = _random_ltv(N, n=12, m=6, seed=7)
    k1, K1, Vx1, Vxx1 = riccati.parallel_backward(*prob, mu=1e-3)
    k2, K2, Vx2, Vxx2 = sharded_parallel_backward(*prob, mesh=_mesh(),
                                                  mu=1e-3)
    np.testing.assert_allclose(np.asarray(k2), np.asarray(k1),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(Vxx2), np.asarray(Vxx1),
                               rtol=1e-8, atol=1e-8)


def test_lie_ilqr_backward_associative_sharded():
    """backward='associative_sharded' drops into LieILQR and reproduces
    the single-device associative solve (2-device mesh, small problem)."""
    import dataclasses

    from trajectory_optimization_matrix_lie_groups.parallel import (
        riccati_sharded,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
        LieILQR,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, solver, params, x0, us0, _ = build_benchmark("so3_tracking", True)
    N = 24
    cp = params["cost"]
    cut = lambda a: a[: N + 1]
    cp = cp._replace(q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
                     Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))
    params = {**params, "cost": cp}
    us0 = us0[:N]
    cfg_a = dataclasses.replace(solver.cfg, N=N, max_iterations=6,
                                tol_grad_norm=0.0, tol_d_norm=0.0,
                                backward="associative")
    s_a = LieILQR(solver.model, cfg_a)
    (_, _), us_a, *_ = s_a.fit(params, x0, us0)

    cfg_s = dataclasses.replace(cfg_a, backward="associative_sharded")
    s_s = LieILQR(solver.model, cfg_s)
    s_s.backward_mesh = riccati_sharded.default_time_mesh(n=2)
    (_, _), us_s, *_ = s_s.fit(params, x0, us0)
    np.testing.assert_allclose(np.asarray(us_s), np.asarray(us_a),
                               rtol=1e-8, atol=1e-8)
