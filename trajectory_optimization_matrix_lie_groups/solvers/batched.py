"""Batch-explicit fast MS-iLQR (the generic XLA path).

`LieILQR` + `jax.vmap` keeps every stage op per-problem; this module keeps
the problem batch explicit end-to-end, for any `LieModel`:

    linearize  — model fns broadcast over (B, N, ...) in one fused call
    backward   — one `lax.scan` over time with a (B, ...) carry
    rollout    — one `lax.scan` over time with a (B, ...) carry
                 (gap-closing nonlinear rollout, alpha = 1)

It is the iterate oracle for the lane-layout pipeline
(`solvers/pipeline.py`) and the plain-XLA baseline it is measured against.

Fixed iteration budget, no line search, fixed mu = 0 — the bench/MPC
configuration (same iterates as `backward='sequential_fixed'`; see
tests/test_batched_fast.py for agreement with the reference engine).

``line_search=True`` adds a per-lane batched merit line search (the MS
merit loop of `traopt_controller.py:2549-2590`, here every alpha candidate
rolled out at once and every problem lane selecting its own first
acceptable step).  Lanes with no acceptable candidate keep their iterate —
the batched analog of the reference's line-search-exhausted hold.  This is
the robust inner used by `ALFastSolver` to converge hard constrained lanes
without falling back to serial per-lane solves.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from trajectory_optimization_matrix_lie_groups.models.base import LieModel
from trajectory_optimization_matrix_lie_groups.utils.linalg import (
    chol_solve_psd,
)


def _bmv(M, v):
    return jnp.einsum("...ij,...j->...i", M, v)


class FastBatchState(NamedTuple):
    qs: jnp.ndarray    # (B, N+1, m, m)
    xis: jnp.ndarray   # (B, N+1, d)
    us: jnp.ndarray    # (B, N, nu)
    J_opt: jnp.ndarray     # (B,)
    grad_norm: jnp.ndarray  # (B,)


class FastBatchSolver:
    """Fixed-budget batched MS-iLQR, plain XLA."""

    def __init__(self, model: LieModel, N: int, iterations: int,
                 line_search: bool = False, n_alphas: int = 13,
                 defect_mu0: float = 10.0, defect_rho: float = 0.5,
                 defect_gamma: float = 0.05, defect_mu_min: float = 10.0,
                 defect_kappa: float = 1e-12):
        """`line_search=True` enables the per-lane batched merit line search
        (constants mirror the reference MS controller,
        traopt_controller.py:2406-2410); candidate rollouts run under a
        vmap over the alpha ladder."""
        self.model = model
        self.N = N
        self.iterations = iterations
        self.line_search = line_search
        self.n_alphas = n_alphas
        self.defect_mu0 = defect_mu0
        self.defect_rho = defect_rho
        self.defect_gamma = defect_gamma
        self.defect_mu_min = defect_mu_min
        self.defect_kappa = defect_kappa
        self._solve_jit = jax.jit(self._solve)

    def _linearize(self, params, qs, xis, us):
        model = self.model
        N = self.N
        idx = jnp.arange(N)
        q_s, xi_s = qs[:, :-1], xis[:, :-1]
        fq, fxi = model.step(params, q_s, xi_s, us, idx)
        Fx, Fu = model.jac(params, q_s, xi_s, us, idx)
        L, Lx, Lu, Lxx, Lux, Luu = model.stage_quad(params, q_s, xi_s, us, idx)
        LN, LNx, LNxx = model.term_quad(params, qs[:, -1], xis[:, -1], N)
        d_q = model.group.rminus(fq, qs[:, 1:])
        d_xi = fxi - xis[:, 1:]
        d = jnp.concatenate([d_q, d_xi], axis=-1)
        return dict(
            fq=fq, fxi=fxi, Fx=Fx, Fu=Fu, d=d,
            L=jnp.concatenate([L, LN[:, None]], axis=1),
            Lx=jnp.concatenate([Lx, LNx[:, None]], axis=1),
            Lu=Lu,
            Lxx=jnp.concatenate([Lxx, LNxx[:, None]], axis=1),
            Lux=Lux, Luu=Luu,
        )

    def _backward(self, lin):
        # scan over time with batched carry
        def step(carry, inp):
            Vx, Vxx = carry
            fx, fu, dd, lx, lu, lxx, lux, luu = inp
            fxT = jnp.swapaxes(fx, -1, -2)
            fuT = jnp.swapaxes(fu, -1, -2)
            Vmod = Vx + _bmv(Vxx, dd)
            Qx = lx + _bmv(fxT, Vmod)
            Qu = lu + _bmv(fuT, Vmod)
            Qxx = lxx + fxT @ Vxx @ fx
            Qux = lux + fuT @ Vxx @ fx
            Quu = luu + fuT @ Vxx @ fu
            if Quu.dtype == jnp.float64:
                # unrolled Cholesky (Quu is PD by construction on this
                # fixed-mu path)
                k = -chol_solve_psd(Quu, Qu)
                K = -chol_solve_psd(Quu, Qux)
            else:
                k = -jnp.linalg.solve(Quu, Qu[..., None])[..., 0]
                K = -jnp.linalg.solve(Quu, Qux)
            KT = jnp.swapaxes(K, -1, -2)
            QuxT = jnp.swapaxes(Qux, -1, -2)
            Vx_n = Qx + _bmv(KT @ Quu, k) + _bmv(KT, Qu) + _bmv(QuxT, k)
            Vxx_n = Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K
            Vxx_n = 0.5 * (Vxx_n + jnp.swapaxes(Vxx_n, -1, -2))
            return (Vx_n, Vxx_n), (k, K, Vx, Vxx)

        tm = lambda a: jnp.swapaxes(a, 0, 1)  # (B, N, ...) -> (N, B, ...)
        (_, _), (k, K, Vx1, Vxx1) = lax.scan(
            step, (lin["Lx"][:, -1], lin["Lxx"][:, -1]),
            (tm(lin["Fx"]), tm(lin["Fu"]), tm(lin["d"]), tm(lin["Lx"][:, :-1]),
             tm(lin["Lu"]), tm(lin["Lxx"][:, :-1]), tm(lin["Lux"]),
             tm(lin["Luu"])),
            reverse=True,
        )
        return tm(k), tm(K), tm(Vx1), tm(Vxx1)

    def _grad_norm(self, lin, Vx1, Vxx1):
        g = lin["Lu"] + _bmv(
            jnp.swapaxes(lin["Fu"], -1, -2),
            Vx1 + _bmv(jnp.swapaxes(Vxx1, -1, -2), lin["d"]))
        return jnp.mean(jnp.linalg.norm(g, axis=-1), axis=-1)

    def _rollout(self, params, lin, qs, xis, us, k, K, alpha=None):
        """Gap-closing nonlinear rollout, batched carry.

        `alpha=None` is the alpha = 1 path; a traced scalar `alpha` scales
        the feedforward and the gap-closing defect exactly as the reference
        alpha-rollout (traopt_controller.py:2697-2726), so the rollout can
        sit under a vmap over the alpha ladder."""
        g = self.model.group
        if alpha is not None:
            # alpha-scaled quantities; K and the nominal trajectory are
            # untouched, so scaling (k, d) reproduces the reference rollout.
            k = alpha * k
            lin = dict(lin)
            lin["d"] = alpha * lin["d"]
        dim = g.dim
        exp_d = g.exp(lin["d"][..., :dim])
        fq_inv = g.inverse(lin["fq"])
        tm = lambda a: jnp.swapaxes(a, 0, 1)

        def step(carry, inp):
            q_new, xi_new = carry
            q, xi, q_next, xi_next, u, k_i, K_i, d_i, fxi_i, exp_d_i, fq_inv_i, i = inp
            xs_err = jnp.concatenate([g.rminus(q_new, q), xi_new - xi], axis=-1)
            u_new = u + k_i + _bmv(K_i, xs_err)
            fq_new, fxi_new = self.model.step(params, q_new, xi_new, u_new, i)
            q_nn = g.normalize(q_next @ exp_d_i @ fq_inv_i @ fq_new)
            xi_nn = xi_next + fxi_new - fxi_i + d_i[..., dim:]
            return (q_nn, xi_nn), (q_nn, xi_nn, u_new)

        idx = jnp.arange(self.N)
        inputs = (tm(qs[:, :-1]), tm(xis[:, :-1]), tm(qs[:, 1:]), tm(xis[:, 1:]),
                  tm(us), tm(k), tm(K), tm(lin["d"]), tm(lin["fxi"]),
                  tm(exp_d), tm(fq_inv), idx)
        (_, _), (qs_t, xis_t, us_new) = lax.scan(
            step, (qs[:, 0], xis[:, 0]), inputs)
        qs_new = jnp.concatenate([qs[:, :1], tm(qs_t)], axis=1)
        xis_new = jnp.concatenate([xis[:, :1], tm(xis_t)], axis=1)
        return qs_new, xis_new, tm(us_new)

    def _iteration(self, params, qs, xis, us):
        lin = self._linearize(params, qs, xis, us)
        k, K, Vx1, Vxx1 = self._backward(lin)
        grad = self._grad_norm(lin, Vx1, Vxx1)
        qs, xis, us = self._rollout(params, lin, qs, xis, us, k, K)
        return qs, xis, us, jnp.sum(lin["L"], axis=-1), grad

    # -- batched merit line search (line_search=True) -----------------------

    def _traj_cost_b(self, params, qs, xis, us):
        idx = jnp.arange(self.N)
        L = self.model.stage_cost(params, qs[:, :-1], xis[:, :-1], us, idx)
        LN = self.model.term_cost(params, qs[:, -1], xis[:, -1], self.N)
        return jnp.sum(L, axis=-1) + LN

    def _defect_norm_b(self, params, qs, xis, us):
        idx = jnp.arange(self.N)
        fq, fxi = self.model.step(params, qs[:, :-1], xis[:, :-1], us, idx)
        d_q = self.model.group.rminus(fq, qs[:, 1:])
        d_xi = fxi - xis[:, 1:]
        d = jnp.concatenate([d_q, d_xi], axis=-1)
        B = qs.shape[0]
        return jnp.linalg.norm(d.reshape(B, -1), axis=-1)

    def _probe_errs(self, lin, k, K):
        """alpha = 1 linear gap-closing probe (ref `_expected_cost_change`
        inputs): per-lane error trajectory via parallel prefix over the
        affine maps dx+ = (Fx + Fu K) dx + (Fu k + d)."""
        M = lin["Fx"] + lin["Fu"] @ K
        c = _bmv(lin["Fu"], k) + lin["d"]

        def combine(e1, e2):
            A1, b1 = e1
            A2, b2 = e2
            return A2 @ A1, _bmv(A2, b1) + b2

        _, b_pref = lax.associative_scan(combine, (M, c), axis=1)
        dx = jnp.concatenate([jnp.zeros_like(b_pref[:, :1]), b_pref], axis=1)
        us_err = k + _bmv(K, dx[:, :-1])
        return dx, us_err

    def _ecc_b(self, lin, xs_errs, us_errs):
        """Batched expected cost change (ref :2756-2769)."""
        first = (jnp.einsum("bni,bni->b", lin["Lx"], xs_errs)
                 + jnp.einsum("bni,bni->b", lin["Lu"], us_errs))
        second = (
            jnp.einsum("bni,bnij,bnj->b", xs_errs, lin["Lxx"], xs_errs)
            + jnp.einsum("bni,bnij,bnj->b", us_errs, lin["Luu"], us_errs)
            + 2.0 * jnp.einsum("bni,bnij,bnj->b", us_errs, lin["Lux"],
                               xs_errs[:, :-1])
        )
        return first, second

    def _iteration_ls(self, params, qs, xis, us, d_weight):
        """One MS iteration with the per-lane batched merit line search.

        Same accept rule / d_weight schedule as `LieILQR._iteration`
        (merit loop, traopt_controller.py:2549-2590), vectorized over both
        the alpha ladder and the problem batch; every lane picks its own
        first acceptable alpha and lanes with none keep their iterate."""
        from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
            alpha_ladder,
        )

        B = qs.shape[0]
        lin = self._linearize(params, qs, xis, us)
        k, K, Vx1, Vxx1 = self._backward(lin)
        grad = self._grad_norm(lin, Vx1, Vxx1)
        J_opt = jnp.sum(lin["L"], axis=-1)
        d_norm = jnp.linalg.norm(lin["d"].reshape(B, -1), axis=-1)

        xs_errs_p, us_errs_p = self._probe_errs(lin, k, K)
        ecc1, ecc2 = self._ecc_b(lin, xs_errs_p, us_errs_p)
        d_weight = jnp.where(
            d_norm < self.defect_kappa,
            d_weight,
            jnp.maximum(
                self.defect_mu_min,
                self.defect_mu0
                + jnp.abs(ecc1 + 0.5 * ecc2)
                / ((1.0 - self.defect_rho) * jnp.maximum(d_norm, 1e-30)),
            ),
        )
        merit = J_opt + d_weight * d_norm

        alphas = alpha_ladder(self.n_alphas, dtype=us.dtype)

        def candidate(alpha):
            qs_c, xis_c, us_c = self._rollout(params, lin, qs, xis, us, k, K,
                                              alpha=alpha)
            J_c = self._traj_cost_b(params, qs_c, xis_c, us_c)
            dn_c = self._defect_norm_b(params, qs_c, xis_c, us_c)
            return qs_c, xis_c, us_c, J_c, dn_c

        qs_a, xis_a, us_a, J_a, dn_a = jax.vmap(candidate)(alphas)
        J_exp = alphas[:, None] * ecc1 + 0.5 * alphas[:, None] ** 2 * ecc2
        merit_a = J_a + d_weight * dn_a
        ok_a = (merit_a - merit) < self.defect_gamma * (
            J_exp - alphas[:, None] * d_weight * d_norm)
        idx_first = jnp.argmax(ok_a, axis=0)          # (B,)
        accepted = jnp.any(ok_a, axis=0)              # (B,)
        lane = jnp.arange(B)
        sel = lambda arr: arr[idx_first, lane]
        pick = lambda new, old: jnp.where(
            accepted.reshape((B,) + (1,) * (new.ndim - 1)), new, old)
        qs_n = pick(sel(qs_a), qs)
        xis_n = pick(sel(xis_a), xis)
        us_n = pick(sel(us_a), us)
        return qs_n, xis_n, us_n, J_opt, grad, d_weight

    def _solve(self, params, q0s, xi0s, us0, q_ref, xi_ref):
        B = q0s.shape[0]
        qs = jnp.concatenate(
            [q0s[:, None], jnp.broadcast_to(q_ref[1:], (B,) + q_ref[1:].shape)],
            axis=1)
        xis = jnp.concatenate(
            [xi0s[:, None], jnp.broadcast_to(xi_ref[1:], (B,) + xi_ref[1:].shape)],
            axis=1)
        us = us0
        inf = jnp.full((B,), jnp.inf, us.dtype)

        if self.line_search:
            def body(_, carry):
                qs, xis, us, J, grad, dw = carry
                return self._iteration_ls(params, qs, xis, us, dw)

            dw0 = jnp.full((B,), self.defect_mu0, us.dtype)
            init = (qs, xis, us, inf, inf, dw0)
            qs, xis, us, J, grad, _ = lax.fori_loop(
                0, self.iterations, body, init)
        else:
            def body(_, carry):
                qs, xis, us, J, grad = carry
                return self._iteration(params, qs, xis, us)

            init = (qs, xis, us, inf, inf)
            qs, xis, us, J, grad = lax.fori_loop(0, self.iterations, body, init)
        return FastBatchState(qs=qs, xis=xis, us=us, J_opt=J, grad_norm=grad)

    def solve(self, params, q0s, xi0s, us0, q_ref, xi_ref):
        return self._solve_jit(params, jnp.asarray(q0s), jnp.asarray(xi0s),
                               jnp.asarray(us0), jnp.asarray(q_ref),
                               jnp.asarray(xi_ref))
