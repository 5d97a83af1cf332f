"""Batched augmented-Lagrangian MS-iLQR: constrained MPC at throughput.

The reference's constrained solver (`AL_iLQR_Tracking_SE3_MS`,
traopt_controller.py:3139-3293) solves ONE problem per process.  This module
runs the same AL outer loop around the batch-explicit `FastBatchSolver`, so
thousands of input-constrained problems (perturbed MPC instances) solve
simultaneously on one chip:

    outer k:  inner fixed-budget batched MS-iLQR solve (FastBatchSolver)
              -> per-problem constraint evaluation g (B, N+1, c)
              -> per-problem multiplier ascent + active-set penalty rebuild
                 (models.costs.al_update_params, broadcast over the batch)
              -> stop when every problem satisfies max g < tol

The AL state rides in the cost params pytree: after the first update the
multipliers are per-problem (B, N+1, c) and the inner solver re-jits once
for the batched-params shapes; subsequent outer iterations reuse both
traces.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from trajectory_optimization_matrix_lie_groups.models import costs
from trajectory_optimization_matrix_lie_groups.models.constraints import (
    ConstraintDef,
)
from trajectory_optimization_matrix_lie_groups.solvers.batched import (
    FastBatchSolver,
)


class ALFastResult(NamedTuple):
    qs: jnp.ndarray          # (B, N+1, 4, 4)
    xis: jnp.ndarray         # (B, N+1, 6)
    us: jnp.ndarray          # (B, N, nu)
    J_opt: jnp.ndarray       # (B,)
    al_params: costs.ALParams
    constr_eval: jnp.ndarray  # (B, N+1, c)
    max_violation: jnp.ndarray  # (B,)
    outer_iterations: int
    constr_converged: bool


class ALFastSolver:
    """AL outer loop around a FastBatchSolver built with the al_cost model."""

    def __init__(self, inner: FastBatchSolver, constraint: ConstraintDef,
                 mu_scale=10.0, mu_max=1e8, tol_constr=1e-2):
        self.inner = inner
        self.constraint = constraint
        self.mu_scale = mu_scale
        self.mu_max = mu_max
        self.tol_constr = tol_constr
        self._ls_inner = None

    def _ls_solver(self) -> FastBatchSolver:
        """Line-searched twin of the fast inner (built lazily, cached).

        Used by the batched rescue: same model/N, merit line search on, a
        larger iteration budget (the candidate rollouts run under a vmap
        over the alpha ladder)."""
        if self._ls_inner is None:
            inner = self.inner
            self._ls_inner = FastBatchSolver(
                inner.model, inner.N,
                iterations=max(inner.iterations, 60), line_search=True)
        return self._ls_inner

    def _eval_constraints(self, al: costs.ALParams, qs, xis, us):
        """Batched stage-wise g + terminal (ref :3242-3248)."""
        N = us.shape[-2]
        idx = jnp.arange(N)
        g_stage = self.constraint.g(al.constr, qs[:, :-1], xis[:, :-1], us,
                                    idx, False)
        u_term = jnp.zeros_like(us[:, 0])
        g_term = self.constraint.g(al.constr, qs[:, -1], xis[:, -1], u_term,
                                   N, True)
        return jnp.concatenate([g_stage, g_term[:, None]], axis=1)

    def solve(self, params, q0s, xi0s, us0, q_ref=None, xi_ref=None,
              n_al_iters=10, rescue=False):
        """params: {'dyn': ..., 'cost': ALParams}; batched initial states.

        Mirrors ref `fit:3218` (inner restarts from `us0` each outer
        iteration, traopt_controller.py:3237).

        ``rescue``: re-solve any still-unconverged problems with the
        line-searched batched inner (`FastBatchSolver(line_search=True)`).
        The fast inner (fixed budget, mu = 0, alpha = 1) can limit-cycle on
        problems whose unconstrained optimum is far outside the box; the
        merit line search converges those (verified on the al_batch
        workload's hard lanes), and the re-solve runs all failing lanes as
        ONE batched program rather than serial per-lane solves."""
        al = params["cost"]
        if q_ref is None:
            q_ref = al.cost.q_ref
        if xi_ref is None:
            xi_ref = al.cost.xi_ref
        if n_al_iters < 1:
            raise ValueError("n_al_iters must be >= 1")
        st, al, constr_eval, converged, outer = self._outer_loop(
            self.inner, params["dyn"], al, q0s, xi0s, us0, q_ref, xi_ref,
            n_al_iters)
        qs, xis, us, J_opt = st.qs, st.xis, st.us, st.J_opt
        if rescue and not converged:
            qs, xis, us, J_opt, constr_eval = self._rescue(
                params, q0s, xi0s, us0, qs, xis, us, J_opt, constr_eval,
                q_ref, xi_ref, n_al_iters)
            converged = bool(
                np.max(np.asarray(constr_eval)) < self.tol_constr)
        return ALFastResult(
            qs=qs, xis=xis, us=us, J_opt=J_opt, al_params=al,
            constr_eval=constr_eval,
            max_violation=jnp.max(constr_eval, axis=(1, 2)),
            outer_iterations=outer + 1, constr_converged=converged,
        )

    def _outer_loop(self, inner, dyn_params, al, q0s, xi0s, us0, q_ref,
                    xi_ref, n_al_iters):
        """The AL outer loop (ref fit:3218) around a given batched inner."""
        st = None
        constr_eval = None
        converged = False
        outer = 0
        for outer in range(n_al_iters):
            st = inner.solve({"dyn": dyn_params, "cost": al},
                             q0s, xi0s, us0, q_ref, xi_ref)
            constr_eval = self._eval_constraints(al, st.qs, st.xis, st.us)
            max_v = jnp.max(constr_eval, axis=(1, 2))
            converged = bool(np.max(np.asarray(max_v)) < self.tol_constr)
            if converged:
                break
            # per-problem freeze: stop updating problems already satisfying
            # the tolerance (see costs.al_update_params docstring)
            al = costs.al_update_params(al, constr_eval, self.mu_scale,
                                        self.mu_max,
                                        freeze=max_v < self.tol_constr)
        return st, al, constr_eval, converged, outer

    # -- fully-traceable variant (VERDICT round-2 item 6) -------------------

    @staticmethod
    def _broadcast_al(al: costs.ALParams, B: int) -> costs.ALParams:
        """Pre-broadcast AL state to per-problem shapes so a fori_loop
        carry keeps a fixed pytree structure across outer iterations."""
        if al.lmbd.ndim == 2:
            N1, c = al.lmbd.shape
            al = al._replace(
                lmbd=jnp.broadcast_to(al.lmbd, (B, N1, c)),
                Imu=jnp.broadcast_to(al.Imu, (B, N1, c, c)),
                mu=jnp.broadcast_to(al.mu, (B,)))
        return al

    def _outer_loop_graph(self, inner, dyn_params, al, q0s, xi0s, us0,
                          q_ref, xi_ref, n_al_iters):
        """In-graph AL outer loop: fixed budget, per-problem freeze —
        identical semantics to `_outer_loop` (frozen problems re-solve to
        the same iterate, so running the full budget is equivalent to the
        reference's convergence break, traopt_controller.py:3250)."""
        B = q0s.shape[0]
        N = us0.shape[1]
        m = q0s.shape[-1]
        d = self.inner.model.nx // 2
        c = al.lmbd.shape[-1]
        dtp = us0.dtype

        def body(_, carry):
            al, qs, xis, us, J, ce, mv = carry
            st = inner._solve({"dyn": dyn_params, "cost": al},
                              q0s, xi0s, us0, q_ref, xi_ref)
            ce = self._eval_constraints(al, st.qs, st.xis, st.us)
            mv = jnp.max(ce, axis=(1, 2))
            al = costs.al_update_params(al, ce, self.mu_scale, self.mu_max,
                                        freeze=mv < self.tol_constr)
            return al, st.qs, st.xis, st.us, st.J_opt, ce, mv

        init = (al,
                jnp.zeros((B, N + 1, m, m), dtp),
                jnp.zeros((B, N + 1, d), dtp),
                jnp.zeros((B, N, self.inner.model.nu), dtp),
                jnp.zeros((B,), dtp),
                jnp.zeros((B, N + 1, c), dtp),
                jnp.full((B,), jnp.inf, dtp))
        return jax.lax.fori_loop(0, n_al_iters, body, init)

    def solve_in_graph(self, params, q0s, xi0s, us0, q_ref=None, xi_ref=None,
                       n_al_iters=10, rescue=False, rescue_outers=None):
        """Fully-traceable AL solve with an optional MASKED rescue.

        Unlike `solve` (host-side convergence break + `np.where` lane
        patching, fine for offline batches but un-jittable), everything
        here is one XLA program: the outer loop is a `fori_loop` with
        per-problem freeze, and ``rescue=True`` re-runs the AL loop with
        the line-searched inner on ALL lanes, keeping its result only for
        lanes the fast pass left above tolerance (`jnp.where` on the
        unconverged mask).  This composes with jit — the closed-loop
        constrained MPC (`solvers/mpc.py`) uses the same pattern in-graph.

        Returns an `ALFastResult` whose `constr_converged` is a traced
        bool array (call `bool()` outside jit)."""
        al0 = params["cost"]
        if q_ref is None:
            q_ref = al0.cost.q_ref
        if xi_ref is None:
            xi_ref = al0.cost.xi_ref
        B = q0s.shape[0]
        al0b = self._broadcast_al(al0, B)
        al_f, qs, xis, us, J, ce, mv = self._outer_loop_graph(
            self.inner, params["dyn"], al0b, q0s, xi0s, us0, q_ref, xi_ref,
            n_al_iters)
        if rescue:
            n_r = rescue_outers if rescue_outers is not None \
                else max(n_al_iters, 20)
            al_r, qs_r, xis_r, us_r, J_r, ce_r, mv_r = self._outer_loop_graph(
                self._ls_solver(), params["dyn"], al0b, q0s, xi0s, us0,
                q_ref, xi_ref, n_r)
            bad = mv >= self.tol_constr
            w = lambda r, f: jnp.where(
                bad.reshape((B,) + (1,) * (f.ndim - 1)), r, f)
            qs, xis, us = w(qs_r, qs), w(xis_r, xis), w(us_r, us)
            J, ce = w(J_r, J), w(ce_r, ce)
            mv = jnp.where(bad, mv_r, mv)
            al_f = al_f._replace(
                lmbd=w(al_r.lmbd, al_f.lmbd), Imu=w(al_r.Imu, al_f.Imu),
                mu=jnp.where(bad, al_r.mu, al_f.mu))
        return ALFastResult(
            qs=qs, xis=xis, us=us, J_opt=J, al_params=al_f,
            constr_eval=ce, max_violation=mv,
            outer_iterations=n_al_iters,
            constr_converged=jnp.all(mv < self.tol_constr),
        )

    def _rescue(self, params, q0s, xi0s, us0, qs, xis, us, J_opt,
                constr_eval, q_ref, xi_ref, n_al_iters):
        """Batched re-solve of unconverged lanes (see ``solve``)."""
        al0 = params["cost"]
        maxv = np.asarray(jnp.max(constr_eval, axis=(1, 2)))
        bad = np.where(maxv >= self.tol_constr)[0]
        st_b, _, ce_b, _, _ = self._outer_loop(
            self._ls_solver(), params["dyn"], al0,
            jnp.asarray(q0s)[bad], jnp.asarray(xi0s)[bad],
            jnp.asarray(us0)[bad], q_ref, xi_ref,
            max(n_al_iters, 20))
        # np.asarray of a jax array is a read-only view; copy for patching
        qs, xis, us = (np.array(qs), np.array(xis), np.array(us))
        J_opt = np.array(J_opt)
        constr_eval = np.array(constr_eval)
        qs[bad], xis[bad], us[bad] = (np.asarray(st_b.qs),
                                      np.asarray(st_b.xis),
                                      np.asarray(st_b.us))
        J_opt[bad] = np.asarray(st_b.J_opt)
        constr_eval[bad] = np.asarray(ce_b)
        return (jnp.asarray(qs), jnp.asarray(xis), jnp.asarray(us),
                jnp.asarray(J_opt), jnp.asarray(constr_eval))
