"""Anchored-pose batched MS-iLQR: full f32 accuracy in f32 arithmetic.

The f32 throughput path has an accuracy floor (~1e-3 in the controls) that
no amount of mixed-precision arithmetic fixes: world-frame poses carry
positions of O(30 m), so storing them in f32 quantizes the trajectory at
~2e-6 m, and with control penalties as small as R = 1e-5 that input noise
alone moves the optimizer's stationary point by ~1e-3.

The fix is representational: store every pose *relative to the reference*,
    q_loc_i = qbar_i^-1 q_i   (near identity — f32 exact to ~1e-7),
and precompute the only large-magnitude objects once in f64:
    T_i    = qbar_{i+1}^-1 qbar_i    (reference transport, near Exp(-xibar dt))
    Adbar_i = Ad(qbar_i)             (for the left-error cost)

Every solver quantity is then algebraically identical to the world-frame
formulation but numerically well-scaled:
    dynamics   q_loc_{i+1} = T_i q_loc_i Exp(xi dt)
    error      e_i = Adbar_i Log(q_loc_i)          == Log(q_i qbar_i^-1)
    defect     d_q = Log(q_loc_{i+1}^-1 T_i q_loc_i Exp(xi dt))  == world d_q
    Jacobians  unchanged (they are local/tangent quantities already)

Scope: the SE(3) free rigid body (`se3_dynamics`) + GN tracking cost — the
MPC benchmark family.  Pose-dependent-force models (gravity/drone) need the
reference rotation plumbed through; that lands with the anchored variant of
those models.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from trajectory_optimization_matrix_lie_groups.models.dynamics import SE3Params, _coad_for_jac, _se3_G
from trajectory_optimization_matrix_lie_groups.ops import se3


def _bmv(M, v):
    return jnp.einsum("...ij,...j->...i", M, v)


class AnchoredProblem(NamedTuple):
    """Precomputed (in f64, stored at target dtype) anchored problem data."""

    dyn: SE3Params
    T: jnp.ndarray        # (N, 4, 4) reference transport qbar_{i+1}^-1 qbar_i
    Ad_ref: jnp.ndarray   # (N+1, 6, 6)
    xi_ref: jnp.ndarray   # (N+1, 6)
    Q1: jnp.ndarray
    Q2: jnp.ndarray
    R: jnp.ndarray
    P1: jnp.ndarray
    P2: jnp.ndarray


def build_anchored(J, dt, Q, R, P, q_ref, xi_ref, dtype=jnp.float32):
    """Precompute anchored problem data in f64, cast to `dtype`."""
    import numpy as np

    q64 = np.asarray(q_ref, np.float64)
    inv = np.linalg.inv(q64[1:])
    T = np.einsum("nij,njk->nik", inv, q64[:-1])
    P_hat = np.zeros((q64.shape[0], 6, 6))
    Rr = q64[:, :3, :3]
    p = q64[:, :3, 3]

    def hat(v):
        out = np.zeros(v.shape[:-1] + (3, 3))
        out[..., 0, 1], out[..., 0, 2] = -v[..., 2], v[..., 1]
        out[..., 1, 0], out[..., 1, 2] = v[..., 2], -v[..., 0]
        out[..., 2, 0], out[..., 2, 1] = -v[..., 1], v[..., 0]
        return out

    Ad = np.zeros((q64.shape[0], 6, 6))
    Ad[:, :3, :3] = Rr
    Ad[:, 3:, :3] = np.einsum("nij,njk->nik", hat(p), Rr)
    Ad[:, 3:, 3:] = Rr

    J = np.asarray(J, np.float64)
    Qm = np.asarray(Q, np.float64)
    Pm = np.asarray(P, np.float64)
    dynp = SE3Params(
        J=jnp.asarray(J, dtype), Jinv=jnp.asarray(np.linalg.inv(J), dtype),
        Ib=jnp.asarray(J[:3, :3], dtype), m=jnp.asarray(J[4, 4], dtype),
        dt=jnp.asarray(dt, dtype), ref_coad_swap=jnp.asarray(True),
    )
    c = lambda a: jnp.asarray(a, dtype)
    return AnchoredProblem(
        dyn=dynp, T=c(T), Ad_ref=c(Ad),
        xi_ref=c(np.asarray(xi_ref, np.float64).reshape(len(q64), 6)),
        Q1=c(Qm[:6, :6]), Q2=c(Qm[6:, 6:]), R=c(np.asarray(R, np.float64)),
        P1=c(Pm[:6, :6]), P2=c(Pm[6:, 6:]),
    )


class AnchoredFastSolver:
    """Fixed-budget anchored batched MS-iLQR (SE3 free body + GN tracking)."""

    def __init__(self, prob: AnchoredProblem, N: int, iterations: int):
        self.p = prob
        self.N = N
        self.iterations = iterations
        self._solve_jit = jax.jit(self._solve)

    # anchored dynamics step: q_loc' = T_i q_loc Exp(xi dt)
    def _step(self, q_loc, xi, u, i):
        p = self.p
        dp = p.dyn
        q_next = se3.normalize(p.T[i] @ q_loc @ se3.exp(xi * dp.dt))
        wrench = _bmv(se3.coad(xi), _bmv(dp.J, xi)) + u
        xi_next = xi + _bmv(dp.Jinv, wrench) * dp.dt
        return q_next, xi_next

    def _jac(self, xi):
        dp = self.p.dyn
        tau = xi * dp.dt
        J_q_q = se3.Ad(se3.exp(-tau))
        J_q_xi = se3.right_jacobian(tau) * dp.dt
        H = dp.Jinv @ (_coad_for_jac(dp, xi) @ dp.J + _se3_G(dp, xi))
        eye6 = jnp.broadcast_to(jnp.eye(6, dtype=xi.dtype), H.shape)
        Z = jnp.zeros_like(H)
        top = jnp.concatenate([J_q_q, J_q_xi], axis=-1)
        bot = jnp.concatenate([Z, eye6 + H * dp.dt], axis=-1)
        Fx = jnp.concatenate([top, bot], axis=-2)
        Fu = jnp.concatenate([jnp.zeros_like(dp.Jinv), dp.Jinv], axis=-2) * dp.dt
        Fu = jnp.broadcast_to(Fu, (*H.shape[:-2], 12, 6))
        return Fx, Fu

    def _quad(self, q_loc, xi, i, W1, W2):
        p = self.p
        psi = se3.log(q_loc)                      # small, f32-exact
        e = _bmv(p.Ad_ref[i], psi)                # == Log(q qbar^-1)
        ev = xi - p.xi_ref[i]
        J_e_x = se3.right_jacobian_inv(e) @ p.Ad_ref[i]
        JT2 = 2.0 * jnp.swapaxes(J_e_x, -1, -2)
        lx = jnp.concatenate([_bmv(JT2 @ W1, e), 2.0 * _bmv(W2, ev)], axis=-1)
        H_e = JT2 @ W1 @ J_e_x
        H_v = jnp.broadcast_to(2.0 * W2, H_e.shape)
        Z = jnp.zeros_like(H_e)
        lxx = jnp.concatenate(
            [jnp.concatenate([H_e, Z], axis=-1),
             jnp.concatenate([Z, H_v], axis=-1)], axis=-2)
        l = (jnp.einsum("...i,ij,...j->...", e, W1, e)
             + jnp.einsum("...i,ij,...j->...", ev, W2, ev))
        return l, lx, lxx

    def _linearize(self, qs, xis, us):
        p = self.p
        N = self.N
        idx = jnp.arange(N)
        q_s, xi_s = qs[:, :-1], xis[:, :-1]
        fq, fxi = self._step(q_s, xi_s, us, idx)
        Fx, Fu = self._jac(xi_s)
        l, lx, lxx = self._quad(q_s, xi_s, idx, p.Q1, p.Q2)
        l = l + jnp.einsum("...i,ij,...j->...", us, p.R, us)
        lu = 2.0 * _bmv(p.R, us)
        luu = jnp.broadcast_to(2.0 * p.R, lu.shape[:-1] + (6, 6))
        lux = jnp.zeros(lu.shape[:-1] + (6, 12), dtype=lu.dtype)
        lN, lNx, lNxx = self._quad(qs[:, -1], xis[:, -1], N, p.P1, p.P2)
        d_q = se3.log(se3.inverse(qs[:, 1:]) @ fq)
        d = jnp.concatenate([d_q, fxi - xis[:, 1:]], axis=-1)
        return dict(
            fq=fq, fxi=fxi, Fx=Fx, Fu=Fu, d=d,
            L=jnp.concatenate([l, lN[:, None]], axis=1),
            Lx=jnp.concatenate([lx, lNx[:, None]], axis=1), Lu=lu,
            Lxx=jnp.concatenate([lxx, lNxx[:, None]], axis=1),
            Lux=lux, Luu=luu,
        )

    def _backward(self, lin):
        from trajectory_optimization_matrix_lie_groups.solvers import riccati

        return jax.vmap(lambda *a: riccati.parallel_backward(*a, mu=0.0))(
            lin["Fx"], lin["Fu"], lin["d"], lin["Lx"], lin["Lu"], lin["Lxx"],
            lin["Lux"], lin["Luu"])

    def _grad_norm(self, lin, Vx1, Vxx1):
        g = lin["Lu"] + _bmv(
            jnp.swapaxes(lin["Fu"], -1, -2),
            Vx1 + _bmv(jnp.swapaxes(Vxx1, -1, -2), lin["d"]))
        return jnp.mean(jnp.linalg.norm(g, axis=-1), axis=-1)

    def _rollout(self, lin, qs, xis, us, k, K):
        dim = 6
        exp_d = se3.exp(lin["d"][..., :dim])
        fq_inv = se3.inverse(lin["fq"])
        tm = lambda a: jnp.swapaxes(a, 0, 1)

        def step(carry, inp):
            q_new, xi_new = carry
            q, xi, q_next, xi_next, u, k_i, K_i, d_i, fxi_i, exp_d_i, fq_inv_i, i = inp
            xs_err = jnp.concatenate(
                [se3.log(se3.inverse(q) @ q_new), xi_new - xi], axis=-1)
            u_new = u + k_i + _bmv(K_i, xs_err)
            fq_new, fxi_new = self._step(q_new, xi_new, u_new, i)
            q_nn = se3.normalize(q_next @ exp_d_i @ fq_inv_i @ fq_new)
            xi_nn = xi_next + fxi_new - fxi_i + d_i[..., dim:]
            return (q_nn, xi_nn), (q_nn, xi_nn, u_new)

        idx = jnp.arange(self.N)
        inputs = (tm(qs[:, :-1]), tm(xis[:, :-1]), tm(qs[:, 1:]), tm(xis[:, 1:]),
                  tm(us), tm(k), tm(K), tm(lin["d"]), tm(lin["fxi"]),
                  tm(exp_d), tm(fq_inv), idx)
        (_, _), (qs_t, xis_t, us_new) = lax.scan(step, (qs[:, 0], xis[:, 0]), inputs)
        qs_new = jnp.concatenate([qs[:, :1], tm(qs_t)], axis=1)
        xis_new = jnp.concatenate([xis[:, :1], tm(xis_t)], axis=1)
        return qs_new, xis_new, tm(us_new)

    def _solve(self, q0_locs, xi0s, us0):
        B = q0_locs.shape[0]
        p = self.p
        eye = jnp.eye(4, dtype=us0.dtype)
        qs = jnp.concatenate(
            [q0_locs[:, None],
             jnp.broadcast_to(eye, (B, self.N, 4, 4))], axis=1)
        xis = jnp.concatenate(
            [xi0s[:, None],
             jnp.broadcast_to(p.xi_ref[1:], (B,) + p.xi_ref[1:].shape)], axis=1)
        us = us0

        def body(_, carry):
            qs, xis, us, J, g = carry
            lin = self._linearize(qs, xis, us)
            k, K, Vx1, Vxx1 = self._backward(lin)
            g = self._grad_norm(lin, Vx1, Vxx1)
            qs, xis, us = self._rollout(lin, qs, xis, us, k, K)
            return qs, xis, us, jnp.sum(lin["L"], axis=-1), g

        init = (qs, xis, us, jnp.full((B,), jnp.inf, us.dtype),
                jnp.full((B,), jnp.inf, us.dtype))
        qs, xis, us, J, g = lax.fori_loop(0, self.iterations, body, init)
        return qs, xis, us, J, g

    def solve(self, q0_locs, xi0s, us0):
        """q0_locs = qbar_0^-1 q_0 (compute in f64 on host for accuracy)."""
        return self._solve_jit(jnp.asarray(q0_locs), jnp.asarray(xi0s),
                               jnp.asarray(us0))
