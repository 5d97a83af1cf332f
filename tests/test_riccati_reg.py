"""Regularized parallel-prefix Riccati (solvers/riccati.py).

Pins the round-2 contract (VERDICT item 3):
  1. a fixed-mu parallel sweep is algebraically identical to the sequential
     fixed-mu recursion (mu threaded through elements AND gains);
  2. an indefinite stage Hessian breaks the mu = 0 sweep (non-finite) but
     the whole-sweep adaptive retry rescues it;
  3. on PD problems the adaptive version is a no-op vs mu = 0.
"""

import numpy as np

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.solvers import riccati

RNG = np.random.default_rng(11)


def _random_ltv(N=40, n=4, m=2, r_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    Fx = np.eye(n) + 0.08 * rng.standard_normal((N, n, n))
    Fu = 0.3 * rng.standard_normal((N, n, m))
    d = 0.01 * rng.standard_normal((N, n))
    Lx = rng.standard_normal((N + 1, n))
    Lu = rng.standard_normal((N, m))
    M = rng.standard_normal((N + 1, n, n))
    Lxx = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(n)
    Lux = 0.1 * rng.standard_normal((N, m, n))
    Lm = rng.standard_normal((N, m, m))
    Luu = r_scale * (Lm @ np.swapaxes(Lm, -1, -2) + 0.5 * np.eye(m))
    to = lambda x: jnp.asarray(x, jnp.float64)
    return tuple(to(x) for x in (Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu))


def _sequential_fixed_mu(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu):
    """Reference fixed-mu defect-aware recursion (numpy), the oracle:
    Quu/Qux regularized by fu^T (V + mu I) f*, Qxx not (SURVEY §2.2
    shared numerical policy; traopt_controller.py:482-484)."""
    N, n = Fx.shape[0], Fx.shape[-1]
    Vx = np.asarray(Lx[-1], np.float64)
    Vxx = np.asarray(Lxx[-1], np.float64)
    eye = np.eye(n)
    ks, Ks, Vxs, Vxxs = [], [], [], []
    for t in reversed(range(N)):
        fx, fu = np.asarray(Fx[t]), np.asarray(Fu[t])
        Vmod = Vx + Vxx @ np.asarray(d[t])
        Vreg = Vxx + mu * eye
        Qx = np.asarray(Lx[t]) + fx.T @ Vmod
        Qu = np.asarray(Lu[t]) + fu.T @ Vmod
        Qxx = np.asarray(Lxx[t]) + fx.T @ Vxx @ fx
        Qux = np.asarray(Lux[t]) + fu.T @ Vreg @ fx
        Quu = np.asarray(Luu[t]) + fu.T @ Vreg @ fu
        k = -np.linalg.solve(Quu, Qu)
        K = -np.linalg.solve(Quu, Qux)
        Vxs.append(Vx)
        Vxxs.append(Vxx)
        Vx = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
        Vxx = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
        Vxx = 0.5 * (Vxx + Vxx.T)
        ks.append(k)
        Ks.append(K)
    rev = lambda L: np.stack(L[::-1])
    return rev(ks), rev(Ks), rev(Vxs), rev(Vxxs)


def test_parallel_fixed_mu_equals_sequential():
    prob = _random_ltv(seed=1)
    for mu in (0.0, 0.37, 5.0):
        k_p, K_p, Vx_p, Vxx_p = riccati.parallel_backward(*prob, mu=mu)
        k_s, K_s, Vx_s, Vxx_s = _sequential_fixed_mu(*prob, mu=mu)
        np.testing.assert_allclose(np.asarray(k_p), k_s, atol=1e-9)
        np.testing.assert_allclose(np.asarray(K_p), K_s, atol=1e-9)
        np.testing.assert_allclose(np.asarray(Vx_p), Vx_s, atol=1e-8)
        np.testing.assert_allclose(np.asarray(Vxx_p), Vxx_s, atol=1e-8)


def _indefinite_problem():
    """The realistic PD-failure regime for the benchmark family: control
    penalty Luu ~ 2R = O(1e-5) (benchmark_SE3_tracking.py:190) and a
    nearly-flat terminal Hessian carrying one small NEGATIVE direction
    (what f32 rounding or DDP tensor terms inject).  Quu = Luu + fu' Vxx fu
    then loses positive definiteness at mu = 0, and a moderate mu restores
    it — the exact scenario the reference's per-step escalation serves.

    (Large indefinite stage costs are intentionally NOT tested: with
    Quu/Qux-only regularization — the reference's own scheme — the
    -mu Qux' Quu^-1 Qux feedback makes strongly indefinite problems
    unrescuable for ANY mu; those are outside the scheme's envelope.)"""
    rng = np.random.default_rng(2)
    N, n, m, rs = 30, 4, 2, 1e-5
    Fx = np.eye(n) + 0.08 * rng.standard_normal((N, n, n))
    Fu = 0.3 * rng.standard_normal((N, n, m))
    d = 0.01 * rng.standard_normal((N, n))
    Lx = rng.standard_normal((N + 1, n))
    Lu = rs * rng.standard_normal((N, m))
    M = rng.standard_normal((N + 1, n, n))
    Lxx = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(n)
    Lux = rs * 0.1 * rng.standard_normal((N, m, n))
    Lm = rng.standard_normal((N, m, m))
    Luu = rs * (Lm @ np.swapaxes(Lm, -1, -2) + 0.5 * np.eye(m))
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Lxx[N] = (Q * np.array([-0.05, 0.01, 0.01, 0.01])) @ Q.T
    to = lambda x: jnp.asarray(x, jnp.float64)
    return tuple(to(x) for x in (Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu))


def test_mu0_breaks_adaptive_rescues():
    """At mu = 0 the indefinite problem yields non-PD Quu — the gains point
    at a saddle, the exact failure the reference's PD check + mu escalation
    guards against (traopt_controller.py:910-923).  The whole-sweep
    adaptive retry must find a mu that restores PD-ness and produce
    descent-direction feedforward gains."""
    prob = _indefinite_problem()
    Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu = prob
    _, _, _, Vxx0 = riccati.parallel_backward(*prob, mu=0.0)
    assert not bool(riccati._all_quu_pd(Fx, Fu, Luu, Vxx0,
                                        jnp.asarray(0.0))), \
        "expected non-PD Quu at mu = 0 on the indefinite problem"

    k, K, Vx_n, Vxx_n, mu_out, delta_out, exceeded = \
        riccati.parallel_backward_adaptive(*prob, mu=0.0, delta=2.0)
    assert not bool(exceeded)
    for a in (k, K, Vx_n, Vxx_n):
        assert np.all(np.isfinite(np.asarray(a)))
    # k = -Quu_reg^-1 Qu with Quu_reg PD  =>  Qu . k < 0 at every stage
    # with Qu != 0 (true descent direction of the regularized model)
    Vmod = np.asarray(Vx_n) + np.einsum(
        "nij,nj->ni", np.asarray(Vxx_n), np.asarray(d))
    Qu = np.asarray(Lu) + np.einsum("nji,nj->ni", np.asarray(Fu), Vmod)
    dots = np.einsum("ni,ni->n", Qu, np.asarray(k))
    assert np.all(dots < 0.0), dots.max()


def test_adaptive_noop_when_pd():
    prob = _random_ltv(seed=3)
    k0, K0, Vx0, Vxx0 = riccati.parallel_backward(*prob, mu=0.0)
    k, K, Vx_n, Vxx_n, mu_out, delta_out, exceeded = \
        riccati.parallel_backward_adaptive(*prob, mu=0.0, delta=2.0)
    assert not bool(exceeded)
    assert float(mu_out) == 0.0
    np.testing.assert_allclose(np.asarray(k), np.asarray(k0), atol=0)
    np.testing.assert_allclose(np.asarray(K), np.asarray(K0), atol=0)
