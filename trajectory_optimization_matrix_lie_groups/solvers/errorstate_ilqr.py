"""Error-state SE(3) iLQR solvers (12-d vector state, Lie-anchored).

Replaces the reference's three error-state controllers
(`traopt_controller.py`):

  - `iLQR_Tracking_ErrorState_Approx:3300` — track a fixed reference with
    the approximate error-state dynamics ('linear' LTV rollout or
    'nonlinear' group rollout that re-logs into the error state).
  - `iLQR_Generation_ErrorState_Approx_LinearRollout:3822` — goal-reaching
    with the linear error-state rollout about a fixed reference.
  - `iLQR_Generation_ErrorState_Approx_NonlinearRollout:4367` — the iterated
    error-state ("Lie-group SQP") scheme: nonlinear group rollout, error
    recovered by Log against the current anchor, and after each accepted
    step the anchor is re-set to the new trajectory
    (`traopt_controller.py:4546-4552`) — here a pure params update.

All per-stage work is batched; rollouts are `lax.scan`s; the backward pass
reuses the Lie engine's defect-free path with the per-step adaptive LM
schedule (ref :4759-4790).  The reference's `scipy.linalg.logm` in the
rollout (`:4606`) becomes the closed-form SE(3) Log.
"""

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from trajectory_optimization_matrix_lie_groups.models import errorstate as es
from trajectory_optimization_matrix_lie_groups.ops import se3
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
    _bmv,
    _is_pd,
    _sym,
    alpha_ladder,
)


@dataclasses.dataclass(frozen=True)
class ESConfig:
    N: int
    mode: str = "generation_nonlinear"  # 'tracking' | 'generation_linear' | 'generation_nonlinear'
    rollout: str = "nonlinear"           # for 'tracking': 'linear' | 'nonlinear'
    n_alphas: int = 15                   # ref :4452 (15); tracking/gen-linear use 10 (:3385, :3902)
    mu_init: float = 1.0
    mu_min: float = 1e-6
    mu_max: float = 1e10
    delta_0: float = 2.0
    tol_J: float = 1e-6
    tol_grad_norm: float = 1e-3
    max_iterations: int = 100
    # runtime analytic-vs-autodiff Jacobian check (the reference's
    # debug={'derivative_compare': True}, traopt_dynamics.py:1905-1933 /
    # traopt_controller.py:3585-3624): when on, `fit` compares both
    # Jacobian paths along the current trajectory each call and stores the
    # report (see ErrorStateILQR.derivative_compare); the reference's
    # failure branch was `pass` — here a warning is emitted above tol
    derivative_compare: bool = False
    derivative_compare_tol: float = 1e-6


class ESState(NamedTuple):
    xs: jnp.ndarray       # (N+1, 12) error states
    qs: jnp.ndarray       # (N+1, 4, 4) group trajectory
    xis: jnp.ndarray      # (N+1, 6)
    us: jnp.ndarray
    params: NamedTuple    # ErrorStateParams (carries the anchor q_ref/xi_ref)
    k: jnp.ndarray
    K: jnp.ndarray
    mu: jnp.ndarray
    delta: jnp.ndarray
    J_opt: jnp.ndarray
    grad_norm: jnp.ndarray
    alpha: jnp.ndarray
    iteration: jnp.ndarray
    converged: jnp.ndarray
    accepted: jnp.ndarray
    failed: jnp.ndarray


class ErrorStateILQR:
    """iLQR on the SE(3) error state with optional anchor re-initialization.

    cost(cost_params, x, u, i, terminal) -> scalar (autodiff-quadratized,
    ref traopt_cost.py:1365-1372); `reanchor_cost` maps (cost_params,
    qs_new) -> new cost params when the anchor moves (goal cost recomputes
    phi_goal; tracking cost is anchor-independent).
    """

    def __init__(self, config: ESConfig, cost: Callable,
                 reanchor_cost: Optional[Callable] = None,
                 step=es.step_euler):
        self.cfg = config
        self.cost = cost
        self.reanchor_cost = reanchor_cost
        self.step = step
        self._iteration_jit = jax.jit(self._iteration)

    # -- pieces --------------------------------------------------------------

    def _linearize(self, params, cost_params, xs, us):
        N = self.cfg.N
        idx = jnp.arange(N)

        def one(x, u, i):
            fx = jax.jacfwd(lambda xx: self.step(params, xx, u, i))(x)
            fu = jax.jacfwd(lambda uu: self.step(params, x, uu, i))(u)
            l = self.cost(cost_params, x, u, i, False)
            lx = jax.grad(lambda xx: self.cost(cost_params, xx, u, i, False))(x)
            lu = jax.grad(lambda uu: self.cost(cost_params, x, uu, i, False))(u)
            lxx = jax.hessian(lambda xx: self.cost(cost_params, xx, u, i, False))(x)
            lux = jax.jacfwd(
                lambda xx: jax.grad(lambda uu: self.cost(cost_params, xx, uu, i, False))(u)
            )(x)
            luu = jax.hessian(lambda uu: self.cost(cost_params, x, uu, i, False))(u)
            return fx, fu, l, lx, lu, lxx, lux, luu

        Fx, Fu, L, Lx, Lu, Lxx, Lux, Luu = jax.vmap(one)(xs[:-1], us, idx)
        lN = self.cost(cost_params, xs[-1], jnp.zeros_like(us[0]), N, True)
        lNx = jax.grad(lambda xx: self.cost(cost_params, xx, jnp.zeros_like(us[0]), N, True))(xs[-1])
        lNxx = jax.hessian(lambda xx: self.cost(cost_params, xx, jnp.zeros_like(us[0]), N, True))(xs[-1])
        return dict(Fx=Fx, Fu=Fu, L=jnp.concatenate([L, lN[None]]),
                    Lx=jnp.concatenate([Lx, lNx[None]], axis=0), Lu=Lu,
                    Lxx=jnp.concatenate([Lxx, lNxx[None]], axis=0), Lux=Lux,
                    Luu=Luu)

    def _backward(self, lin, mu, delta):
        """Per-step adaptive-mu backward pass (ref :4716-4790)."""
        cfg = self.cfg
        nx = lin["Fx"].shape[-1]
        eye = jnp.eye(nx, dtype=lin["Fx"].dtype)

        def step(carry, inp):
            Vx, Vxx, mu_c, delta_c = carry
            fx, fu, lx, lu, lxx, lux, luu = inp
            fxT = jnp.swapaxes(fx, -1, -2)
            fuT = jnp.swapaxes(fu, -1, -2)

            def quu_of(m):
                return luu + fuT @ (Vxx + m * eye) @ fu

            def cond(c):
                return jnp.logical_not(c[2])

            def body(c):
                mu_q, dlt, done = c
                Q = quu_of(mu_q)
                ok = _is_pd(Q + jnp.swapaxes(Q, -1, -2))
                dlt_dec = jnp.minimum(1.0, dlt) / cfg.delta_0
                mu_dec = mu_q * dlt_dec
                mu_dec = jnp.where(mu_dec <= cfg.mu_min, 0.0, mu_dec)
                dlt_inc = jnp.maximum(1.0, dlt) * cfg.delta_0
                mu_inc = jnp.maximum(cfg.mu_min, mu_q * dlt_inc)
                hit = mu_inc >= cfg.mu_max
                return (jnp.where(ok | hit, mu_q, mu_inc),
                        jnp.where(ok, dlt_dec, dlt_inc), ok | hit)

            mu_q, delta_n, _ = lax.while_loop(cond, body, (mu_c, delta_c, jnp.asarray(False)))
            # post-success state decrease mirrors the Lie engine
            mu_st = jnp.where(mu_q <= cfg.mu_min, 0.0, mu_q)

            Vreg = Vxx + mu_q * eye
            Qx = lx + _bmv(fxT, Vx)
            Qu = lu + _bmv(fuT, Vx)
            Qxx = lxx + fxT @ Vxx @ fx
            Qux = lux + fuT @ Vreg @ fx
            Quu = luu + fuT @ Vreg @ fu
            k = -jnp.linalg.solve(Quu, Qu)
            K = -jnp.linalg.solve(Quu, Qux)
            KT = jnp.swapaxes(K, -1, -2)
            QuxT = jnp.swapaxes(Qux, -1, -2)
            Vx_n = Qx + _bmv(KT @ Quu, k) + _bmv(KT, Qu) + _bmv(QuxT, k)
            Vxx_n = _sym(Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K)
            return (Vx_n, Vxx_n, mu_st, delta_n), (k, K)

        (_, _, mu_out, delta_out), (k, K) = lax.scan(
            step, (lin["Lx"][-1], lin["Lxx"][-1], mu, delta),
            (lin["Fx"], lin["Fu"], lin["Lx"][:-1], lin["Lu"],
             lin["Lxx"][:-1], lin["Lux"], lin["Luu"]),
            reverse=True,
        )
        return k, K, mu_out, delta_out

    def _grad_norm(self, lin):
        def step(p, inp):
            fx, fu, lx, lu = inp
            g = lu + _bmv(jnp.swapaxes(fu, -1, -2), p)
            return lx + _bmv(jnp.swapaxes(fx, -1, -2), p), g

        _, g = lax.scan(step, lin["Lx"][-1],
                        (lin["Fx"], lin["Fu"], lin["Lx"][:-1], lin["Lu"]),
                        reverse=True)
        return jnp.mean(jnp.linalg.norm(g, axis=-1))

    def _traj_cost(self, cost_params, xs, us):
        idx = jnp.arange(self.cfg.N)
        L = jax.vmap(lambda x, u, i: self.cost(cost_params, x, u, i, False))(
            xs[:-1], us, idx)
        lN = self.cost(cost_params, xs[-1], jnp.zeros_like(us[0]), self.cfg.N, True)
        return jnp.sum(L) + lN

    def _rollout_nonlinear(self, params, state, k, K, alpha):
        """Group rollout + re-log against the anchor (ref `_rollout:4576-4611`)."""
        cfg = self.cfg

        def step(carry, inp):
            x_new, q_new, xi_new = carry
            x_nom, q_anchor_next, u_nom, k_i, K_i, i = inp
            u = u_nom + alpha * k_i + _bmv(K_i, x_new - x_nom)
            q_n, xi_n = es.group_step(params, q_new, xi_new, u, i)
            psi = se3.log(se3.inverse(q_anchor_next) @ q_n)
            x_n = jnp.concatenate([psi, xi_n])
            return (x_n, q_n, xi_n), (x_n, q_n, xi_n, u)

        idx = jnp.arange(cfg.N)
        x0 = state.xs[0]
        init = (x0, state.qs[0], state.xis[0])
        inputs = (state.xs[:-1], params.q_ref[1:], state.us, k, K, idx)
        (_, _, _), (xs_t, qs_t, xis_t, us_new) = lax.scan(step, init, inputs)
        xs_new = jnp.concatenate([x0[None], xs_t], axis=0)
        qs_new = jnp.concatenate([state.qs[:1], qs_t], axis=0)
        xis_new = jnp.concatenate([state.xis[:1], xis_t], axis=0)
        return xs_new, qs_new, xis_new, us_new

    def _rollout_linear(self, params, state, k, K, alpha):
        """LTV rollout of the error-state dynamics (ref :3516)."""
        cfg = self.cfg

        def step(x_new, inp):
            x_nom, u_nom, k_i, K_i, i = inp
            u = u_nom + alpha * k_i + _bmv(K_i, x_new - x_nom)
            x_n = self.step(params, x_new, u, i)
            return x_n, (x_n, u)

        idx = jnp.arange(cfg.N)
        _, (xs_t, us_new) = lax.scan(
            step, state.xs[0], (state.xs[:-1], state.us, k, K, idx))
        xs_new = jnp.concatenate([state.xs[:1], xs_t], axis=0)
        # group trajectory reconstructed from the anchor + error state
        qs_new = params.q_ref @ se3.exp(xs_new[:, :6])
        xis_new = xs_new[:, 6:]
        return xs_new, qs_new, xis_new, us_new

    # -- iteration -----------------------------------------------------------

    def _iteration(self, cost_params, state: ESState):
        cfg = self.cfg
        params = state.params
        lin = self._linearize(params, cost_params, state.xs, state.us)
        J_opt = jnp.sum(lin["L"])
        k, K, mu_new, delta_new = self._backward(lin, state.mu, state.delta)
        grad_norm = self._grad_norm(lin)
        grad_conv = grad_norm < cfg.tol_grad_norm

        alphas = alpha_ladder(cfg.n_alphas, dtype=state.us.dtype)
        use_nl = (cfg.mode == "generation_nonlinear") or (
            cfg.mode == "tracking" and cfg.rollout == "nonlinear")

        def candidate(alpha):
            if use_nl:
                xs_c, qs_c, xis_c, us_c = self._rollout_nonlinear(params, state, k, K, alpha)
            else:
                xs_c, qs_c, xis_c, us_c = self._rollout_linear(params, state, k, K, alpha)
            return xs_c, qs_c, xis_c, us_c, self._traj_cost(cost_params, xs_c, us_c)

        xs_a, qs_a, xis_a, us_a, J_a = jax.vmap(candidate)(alphas)
        ok_a = J_a < J_opt
        idx_first = jnp.argmax(ok_a)
        improved = jnp.any(ok_a)
        J_new = J_a[idx_first]
        rel_conv = jnp.abs((J_opt - J_new) / J_opt) < cfg.tol_J
        accepted = grad_conv | improved
        converged = grad_conv | (improved & rel_conv)
        take_new = improved | grad_conv  # ref :4510-4517 updates on grad-conv too

        sel = lambda a: a[idx_first]
        pick = lambda new, old: jnp.where(take_new, new, old)
        xs_new, qs_new, xis_new, us_new = map(sel, (xs_a, qs_a, xis_a, us_a))
        failed = jnp.logical_not(accepted)
        return state._replace(
            xs=pick(xs_new, state.xs), qs=pick(qs_new, state.qs),
            xis=pick(xis_new, state.xis), us=pick(us_new, state.us),
            k=k, K=K, mu=mu_new, delta=delta_new,
            J_opt=jnp.where(take_new, J_new, J_opt), grad_norm=grad_norm,
            alpha=alphas[idx_first], iteration=state.iteration + 1,
            converged=converged, accepted=accepted, failed=failed,
        ), take_new

    # -- driver --------------------------------------------------------------

    def init_state(self, params: es.ErrorStateParams, us_init, x0=None):
        """Nominal anchor trajectory = the stored reference; error state 0
        (ref `_linearization:4683-4687`).  With ``x0`` (a 12-d error state,
        the reference tracking solver's perturbed start,
        `iLQR_Tracking_ErrorState_Approx.fit`), the initial trajectory is
        instead the rollout of ``us_init`` from ``x0``."""
        us = jnp.asarray(us_init)
        if x0 is None:
            xs = jnp.concatenate(
                [jnp.zeros_like(params.xi_ref), params.xi_ref], axis=-1)
            qs, xis = params.q_ref, params.xi_ref
        else:
            x0 = jnp.asarray(x0)
            q0 = params.q_ref[0] @ se3.exp(x0[:6])
            qs, xis = es.rollout_nominal(params, q0, x0[6:], us)
            psi = jax.vmap(lambda qb, q: se3.log(se3.inverse(qb) @ q))(
                params.q_ref, qs)
            xs = jnp.concatenate([psi, xis], axis=-1)
        dtype = us.dtype
        f = lambda v: jnp.asarray(v, dtype=dtype)
        nu = us.shape[-1]
        return ESState(
            xs=xs, qs=qs, xis=xis, us=us, params=params,
            k=jnp.zeros((self.cfg.N, nu), dtype=dtype),
            K=jnp.zeros((self.cfg.N, nu, 12), dtype=dtype),
            mu=f(self.cfg.mu_init), delta=f(self.cfg.delta_0),
            J_opt=f(jnp.inf), grad_norm=f(jnp.inf), alpha=f(1.0),
            iteration=jnp.asarray(0), converged=jnp.asarray(False),
            accepted=jnp.asarray(False), failed=jnp.asarray(False),
        )

    def derivative_compare(self, params, xs, us, tol=None):
        """Analytic-vs-autodiff Jacobian comparison along a trajectory.

        The runtime twin of the reference's `derivative_compare` debug mode
        (`traopt_dynamics.py:1905-1933`, threshold check at
        `traopt_controller.py:3616-3624` — whose failure branch is `pass`).
        Returns {'fx_max_dev', 'fu_max_dev', 'within_tol'} and warns when
        the deviation exceeds ``tol``.  For the Euler step the analytic
        Jacobian is exact (see `models/errorstate.jac_analytic`), so any
        deviation flags a real regression; with `step_rk4` the analytic
        form stays first-order I + At dt and an O(dt^2) deviation is
        expected."""
        import warnings

        tol = self.cfg.derivative_compare_tol if tol is None else tol
        idx = jnp.arange(us.shape[0])
        jac_ad = es.jac_autodiff(self.step)
        fx_d, fu_d = jax.vmap(lambda x, u, i: jac_ad(params, x, u, i))(
            xs[:-1], us, idx)
        fx_a, fu_a = jax.vmap(lambda x, u, i: es.jac_analytic(params, x, u, i))(
            xs[:-1], us, idx)
        rep = dict(
            fx_max_dev=float(jnp.max(jnp.abs(fx_d - fx_a))),
            fu_max_dev=float(jnp.max(jnp.abs(fu_d - fu_a))),
        )
        rep["within_tol"] = (rep["fx_max_dev"] < tol
                             and rep["fu_max_dev"] < tol)
        if not rep["within_tol"]:
            warnings.warn(
                f"derivative_compare: analytic vs autodiff Jacobians "
                f"deviate by fx={rep['fx_max_dev']:.2e} "
                f"fu={rep['fu_max_dev']:.2e} (> {tol:g}); expected only "
                f"for higher-order integrators (the analytic form is the "
                f"Euler-exact I + At dt — models/errorstate.jac_analytic)")
        return rep

    def fit(self, cost_params, params, us_init, n_iterations=None,
            on_iteration=None, x0=None):
        cfg = self.cfg
        n_iterations = n_iterations or cfg.max_iterations
        state = self.init_state(params, us_init, x0=x0)
        if cfg.derivative_compare:
            self.derivative_compare_report = self.derivative_compare(
                state.params, state.xs, us_init)
        J_hist, grad_hist = [], []
        for _ in range(n_iterations):
            state, took = self._iteration_jit(cost_params, state)
            J_hist.append(float(state.J_opt))
            grad_hist.append(float(state.grad_norm))
            if cfg.mode == "generation_nonlinear" and bool(took):
                # re-anchor the error-state dynamics and the goal cost to
                # the accepted trajectory (ref :4546-4552)
                new_params = es.reanchor(state.params, state.qs, state.xis)
                state = state._replace(
                    params=new_params,
                    xs=jnp.concatenate(
                        [jnp.zeros_like(state.xis), state.xis], axis=-1),
                )
                if self.reanchor_cost is not None:
                    cost_params = self.reanchor_cost(cost_params, state.qs)
            if on_iteration is not None:
                on_iteration(state)
            if bool(state.converged) or bool(state.failed):
                break
        return state, J_hist, grad_hist, cost_params
