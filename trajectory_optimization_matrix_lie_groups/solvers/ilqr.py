"""Euclidean-state iLQR/DDP (the reference's `iLQR`, traopt_controller.py:43-521).

Same numerical policy as the reference — single Levenberg-Marquardt mu per
backward pass with the delta-doubling schedule applied per *iteration*
(accept => decrease, reject => increase), `1.1**(-arange(10)**2)` line search
with the gradient-norm check folded in, optional DDP tensor terms — but
restructured for XLA: batched linearization, `lax.scan` backward pass, all
line-search candidates rolled out at once.
"""

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from trajectory_optimization_matrix_lie_groups.models.autodiff import EuclideanModel
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
    _bmv,
    _sym,
    alpha_ladder,
)


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    N: int
    n_alphas: int = 10
    mu_init: float = 1.0
    mu_min: float = 1e-6
    mu_max: float = 1e10
    delta_0: float = 2.0
    tol_J: float = 1e-6
    tol_grad_norm: float = 1e-3
    max_iterations: int = 100
    use_hessians: bool = False


class ILQRState(NamedTuple):
    xs: jnp.ndarray
    us: jnp.ndarray
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


class ILQR:
    """Euclidean iLQR/DDP with reference-identical acceptance rules."""

    def __init__(self, model: EuclideanModel, config: ILQRConfig):
        self.model = model
        self.cfg = config
        self._iteration_jit = jax.jit(self._iteration)
        self._solve_jit = jax.jit(self._solve_loop)

    def init_state(self, x0, us_init):
        cfg = self.cfg
        us = jnp.asarray(us_init)
        xs = self._rollout_open(jnp.asarray(x0), us)
        dtype = us.dtype
        f = lambda v: jnp.asarray(v, dtype=dtype)
        return ILQRState(
            xs=xs, us=us,
            k=jnp.zeros((cfg.N, self.model.nu), dtype=dtype),
            K=jnp.zeros((cfg.N, self.model.nu, self.model.nx), dtype=dtype),
            mu=f(cfg.mu_init), delta=f(cfg.delta_0),
            J_opt=f(jnp.inf), grad_norm=f(jnp.inf), alpha=f(1.0),
            iteration=jnp.asarray(0), converged=jnp.asarray(False),
            accepted=jnp.asarray(False), failed=jnp.asarray(False),
        )

    def _rollout_open(self, x0, us):
        def step(x, inp):
            u, i = inp
            xn = self.model.step(x, u, i)
            return xn, xn

        _, xs_tail = lax.scan(step, x0, (us, jnp.arange(self.cfg.N)))
        return jnp.concatenate([x0[None], xs_tail], axis=0)

    def _linearize(self, xs, us):
        idx = jnp.arange(self.cfg.N)
        Fx, Fu = jax.vmap(self.model.jac)(xs[:-1], us, idx)
        L, Lx, Lu, Lxx, Lux, Luu = jax.vmap(self.model.stage_quad)(xs[:-1], us, idx)
        LN, LNx, LNxx = self.model.term_quad(xs[-1], self.cfg.N)
        if self.cfg.use_hessians and self.model.has_hessians:
            Fxx, Fux, Fuu = jax.vmap(self.model.hess)(xs[:-1], us, idx)
        else:
            Fxx = Fux = Fuu = None
        return dict(Fx=Fx, Fu=Fu, L=jnp.concatenate([L, LN[None]]),
                    Lx=jnp.concatenate([Lx, LNx[None]], axis=0), Lu=Lu,
                    Lxx=jnp.concatenate([Lxx, LNxx[None]], axis=0), Lux=Lux,
                    Luu=Luu, Fxx=Fxx, Fux=Fux, Fuu=Fuu)

    def _backward(self, lin, mu):
        """Fixed-mu backward pass (ref `_backward_pass:358-432`)."""
        nx = self.model.nx
        eye = jnp.eye(nx, dtype=lin["Fx"].dtype)
        use_h = self.cfg.use_hessians and self.model.has_hessians

        def step(carry, inp):
            Vx, Vxx = carry
            if use_h:
                fx, fu, lx, lu, lxx, lux, luu, fxx, fux, fuu = inp
            else:
                fx, fu, lx, lu, lxx, lux, luu = inp
            fxT = jnp.swapaxes(fx, -1, -2)
            fuT = jnp.swapaxes(fu, -1, -2)
            Qx = lx + _bmv(fxT, Vx)
            Qu = lu + _bmv(fuT, Vx)
            Qxx = lxx + fxT @ Vxx @ fx
            Vreg = Vxx + mu * eye
            Qux = lux + fuT @ Vreg @ fx
            Quu = luu + fuT @ Vreg @ fu
            if use_h:
                # DDP tensor terms (ref :487-490)
                Qxx = Qxx + jnp.tensordot(Vx, fxx, axes=1)
                Qux = Qux + jnp.tensordot(Vx, fux, axes=1)
                Quu = Quu + jnp.tensordot(Vx, fuu, axes=1)
            k = -jnp.linalg.solve(Quu, Qu)
            K = -jnp.linalg.solve(Quu, Qux)
            KT = jnp.swapaxes(K, -1, -2)
            QuxT = jnp.swapaxes(Qux, -1, -2)
            Vx_n = Qx + _bmv(KT @ Quu, k) + _bmv(KT, Qu) + _bmv(QuxT, k)
            Vxx_n = _sym(Qxx + KT @ Quu @ K + KT @ Qux + QuxT @ K)
            return (Vx_n, Vxx_n), (k, K)

        inputs = [lin["Fx"], lin["Fu"], lin["Lx"][:-1], lin["Lu"],
                  lin["Lxx"][:-1], lin["Lux"], lin["Luu"]]
        if use_h:
            inputs += [lin["Fxx"], lin["Fux"], lin["Fuu"]]
        (_, _), (k, K) = lax.scan(step, (lin["Lx"][-1], lin["Lxx"][-1]),
                                  tuple(inputs), reverse=True)
        return k, K

    def _grad_norm(self, lin):
        def step(p, inp):
            fx, fu, lx, lu = inp
            g = lu + _bmv(jnp.swapaxes(fu, -1, -2), p)
            return lx + _bmv(jnp.swapaxes(fx, -1, -2), p), g

        _, g = lax.scan(step, lin["Lx"][-1],
                        (lin["Fx"], lin["Fu"], lin["Lx"][:-1], lin["Lu"]),
                        reverse=True)
        return jnp.mean(jnp.linalg.norm(g, axis=-1))

    def _control(self, xs, us, k, K, alpha):
        """Closed-loop rollout (ref `_control:224-250`)."""
        def step(x, inp):
            x_nom, u_nom, k_i, K_i, i = inp
            u = u_nom + alpha * k_i + _bmv(K_i, x - x_nom)
            xn = self.model.step(x, u, i)
            return xn, (xn, u)

        _, (xs_tail, us_new) = lax.scan(
            step, xs[0], (xs[:-1], us, k, K, jnp.arange(self.cfg.N)))
        return jnp.concatenate([xs[:1], xs_tail], axis=0), us_new

    def _traj_cost(self, xs, us):
        idx = jnp.arange(self.cfg.N)
        L = jax.vmap(self.model.stage_cost)(xs[:-1], us, idx)
        return jnp.sum(L) + self.model.term_cost(xs[-1], self.cfg.N)

    def _iteration(self, state: ILQRState) -> ILQRState:
        cfg = self.cfg
        lin = self._linearize(state.xs, state.us)
        J_opt = jnp.sum(lin["L"])
        k, K = self._backward(lin, state.mu)
        grad_norm = self._grad_norm(lin)
        grad_conv = grad_norm < cfg.tol_grad_norm

        alphas = alpha_ladder(cfg.n_alphas, dtype=state.us.dtype)

        def candidate(alpha):
            xs_c, us_c = self._control(state.xs, state.us, k, K, alpha)
            return xs_c, us_c, self._traj_cost(xs_c, us_c)

        xs_a, us_a, J_a = jax.vmap(candidate)(alphas)
        ok_a = J_a < J_opt
        idx_first = jnp.argmax(ok_a)
        improved = jnp.any(ok_a)
        J_new = J_a[idx_first]
        rel_conv = jnp.abs((J_opt - J_new) / J_opt) < cfg.tol_J

        # reference semantics (ref :160-189): grad-converged accepts without
        # updating the trajectory; otherwise first improving alpha accepts.
        accepted = grad_conv | improved
        converged = grad_conv | (improved & rel_conv)
        take_new = improved & jnp.logical_not(grad_conv)

        # mu schedule (ref :181-207)
        delta_dec = jnp.minimum(1.0, state.delta) / cfg.delta_0
        mu_dec = state.mu * delta_dec
        mu_dec = jnp.where(mu_dec <= cfg.mu_min, 0.0, mu_dec)
        delta_inc = jnp.maximum(1.0, state.delta) * cfg.delta_0
        mu_inc = jnp.maximum(cfg.mu_min, state.mu * delta_inc)
        mu_new = jnp.where(take_new, mu_dec, jnp.where(accepted, state.mu, mu_inc))
        delta_new = jnp.where(take_new, delta_dec,
                              jnp.where(accepted, state.delta, delta_inc))
        failed = jnp.logical_not(accepted) & (mu_inc >= cfg.mu_max)

        pick = lambda new, old: jnp.where(take_new, new, old)
        return ILQRState(
            xs=pick(xs_a[idx_first], state.xs),
            us=pick(us_a[idx_first], state.us),
            k=k, K=K, mu=mu_new, delta=delta_new,
            J_opt=jnp.where(take_new, J_new, J_opt),
            grad_norm=grad_norm, alpha=alphas[idx_first],
            iteration=state.iteration + 1, converged=converged,
            accepted=accepted, failed=failed,
        )

    def fit(self, x0, us_init, n_iterations=None, on_iteration=None,
            state: Optional[ILQRState] = None):
        n_iterations = n_iterations or self.cfg.max_iterations
        if state is None:
            state = self.init_state(x0, us_init)
        J_hist, grad_hist = [], []
        for _ in range(n_iterations):
            state = self._iteration_jit(state)
            J_hist.append(float(state.J_opt))
            grad_hist.append(float(state.grad_norm))
            if on_iteration is not None:
                on_iteration(state)
            if bool(state.converged) or bool(state.failed):
                break
        return state.xs, state.us, J_hist, grad_hist, state

    def _solve_loop(self, state):
        cfg = self.cfg

        def cond(s):
            return ((s.iteration < cfg.max_iterations)
                    & jnp.logical_not(s.converged) & jnp.logical_not(s.failed))

        return lax.while_loop(cond, self._iteration, state)

    def solve(self, x0, us_init):
        return self._solve_jit(self.init_state(x0, us_init))
