"""Augmented-Lagrangian constrained MS-iLQR (ref `AL_iLQR_Tracking_SE3_MS`).

Outer loop (traopt_controller.py:3218-3293): solve the AL-weighted problem
with the inner MS-iLQR to convergence, evaluate constraints along the
solution, update multipliers by clipped first-order ascent with active-set
penalty rebuild, escalate the penalty geometrically, stop when
max g < tol_constr.

The AL state (lmbd, Imu, mu) lives in the cost params pytree
(models.costs.ALParams), so the inner solver jits once and every outer
iteration is a pure params update — no retracing.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from trajectory_optimization_matrix_lie_groups.models import costs
from trajectory_optimization_matrix_lie_groups.models.constraints import ConstraintDef
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR


class ALResult(NamedTuple):
    qs: jnp.ndarray
    xis: jnp.ndarray
    us: jnp.ndarray
    al_params: costs.ALParams
    constr_eval: jnp.ndarray
    outer_iterations: int
    constr_converged: bool
    inner_histories: list


class ALILQR:
    """AL outer loop around a LieILQR inner solver.

    `inner` must be built with the AL-wrapped cost (models.costs.al_cost)
    whose params pytree is an ALParams.
    """

    def __init__(self, inner: LieILQR, constraint: ConstraintDef,
                 mu_scale=10.0, mu_max=1e8, tol_constr=1e-2):
        self.inner = inner
        self.constraint = constraint
        self.mu_scale = mu_scale
        self.mu_max = mu_max
        self.tol_constr = tol_constr

    def _eval_constraints(self, al_params, qs, xis, us):
        """Stage-wise g over the trajectory + terminal (ref :3242-3248)."""
        N = us.shape[0]
        idx = jnp.arange(N)
        g_stage = self.constraint.g(al_params.constr, qs[:-1], xis[:-1], us, idx, False)
        u_term = jnp.zeros_like(us[0])
        g_term = self.constraint.g(al_params.constr, qs[-1], xis[-1], u_term, N, True)
        return jnp.concatenate([g_stage, g_term[None]], axis=0)

    def fit(self, params, x0, us_init, n_al_iters=100, n_ilqr_iters=200,
            on_iteration_al=None, on_iteration_ilqr=None):
        """params: {'dyn': ..., 'cost': ALParams}.  Mirrors ref `fit:3218`.

        Note the reference restarts the inner solve from `us_init` every
        outer iteration (traopt_controller.py:3237) — replicated here.
        """
        al = params["cost"]
        histories = []
        constr_converged = False
        outer = 0
        result = None
        for outer in range(n_al_iters):
            p = {"dyn": params["dyn"], "cost": al}
            (qs, xis), us, J_hist, grad_hist, defect_hist, state = self.inner.fit(
                p, x0, us_init, n_iterations=n_ilqr_iters,
                on_iteration=on_iteration_ilqr,
                q_ref=al.cost.q_ref, xi_ref=al.cost.xi_ref,
            )
            histories.append(dict(J=J_hist, grad=grad_hist, defect=defect_hist))
            constr_eval = self._eval_constraints(al, qs, xis, us)
            constr_converged = bool(jnp.max(constr_eval) < self.tol_constr)
            if on_iteration_al is not None:
                on_iteration_al(outer, constr_converged, al, constr_eval)
            result = ALResult(qs, xis, us, al, constr_eval, outer + 1,
                              constr_converged, histories)
            if constr_converged:
                break
            al = costs.al_update_params(al, constr_eval, self.mu_scale, self.mu_max)
        return result
