"""Receding-horizon MPC driver over the MS-iLQR engine.

The reference has no MPC loop (its `fit` is open-loop); BASELINE.json's
north-star metric is MPC solve throughput, so this module provides the
closed-loop driver: at each plant step, slice an H-step reference window out
of the full path (`lax.dynamic_slice` — no retracing), warm-start from the
shifted previous solution, run a fixed iLQR iteration budget, apply u0.

`make_closed_loop` returns a fully-jitted function that scans the whole
closed-loop simulation on-device — plant rollout, window slicing, and every
inner solve fused into one XLA program (zero host sync per step).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from trajectory_optimization_matrix_lie_groups.models import costs
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)


def _window(cp: costs.TrackingCostParams, t, H):
    """Slice the (H+1)-entry reference window starting at plant step t."""
    sl = lambda a: lax.dynamic_slice_in_dim(a, t, H + 1, axis=0)
    return cp._replace(
        q_ref=sl(cp.q_ref), q_ref_inv=sl(cp.q_ref_inv),
        Ad_ref=sl(cp.Ad_ref), xi_ref=sl(cp.xi_ref),
    )


class MPCResult(NamedTuple):
    qs: jnp.ndarray      # (T+1, m, m) closed-loop plant trajectory
    xis: jnp.ndarray     # (T+1, d)
    us: jnp.ndarray      # (T, nu) applied controls
    J_pred: jnp.ndarray  # (T,) predicted cost per solve


class BatchMPCResult(NamedTuple):
    qs: jnp.ndarray      # (B, T+1, 4, 4) closed-loop plant trajectories
    xis: jnp.ndarray     # (B, T+1, 6)
    us: jnp.ndarray      # (B, T, nu) applied controls
    J_pred: jnp.ndarray  # (B, T) predicted cost per solve


def make_closed_loop(solver: LieILQR, T: int):
    """Build a jitted closed-loop simulator.

    Args:
      solver: a LieILQR whose cost params carry an (H+1)-window reference
        (the per-step window is written into ``params['cost']``).
      T: number of closed-loop plant steps; the full reference must have at
        least T + H + 1 entries.

    Returns:
      run(params_full, q0, xi0): params_full's cost entry holds the FULL
        reference path; returns an MPCResult.
    """
    H = solver.cfg.N
    model = solver.model
    g = model.group

    def run(params_full, q0, xi0):
        cp_full = params_full["cost"]
        nu = model.nu

        def mpc_step(carry, t):
            q, xi, us_warm = carry
            cp_t = _window(cp_full, t, H)
            params_t = {**params_full, "cost": cp_t}
            state = solver._init_state_ms(q, xi, us_warm, cp_t.q_ref, cp_t.xi_ref)
            state = solver._solve_loop(params_t, state)
            u0 = state.us[0]
            q_next, xi_next = model.step(params_t, q, xi, u0, 0)
            # warm start: shift one step, repeat the tail control
            us_next = jnp.concatenate([state.us[1:], state.us[-1:]], axis=0)
            return (q_next, xi_next, us_next), (q_next, xi_next, u0, state.J_opt)

        us0 = jnp.zeros((H, nu), dtype=xi0.dtype)
        (_, _, _), (qs_t, xis_t, us_applied, J_pred) = lax.scan(
            mpc_step, (q0, xi0, us0), jnp.arange(T))
        qs = jnp.concatenate([q0[None], qs_t], axis=0)
        xis = jnp.concatenate([xi0[None], xis_t], axis=0)
        return MPCResult(qs=qs, xis=xis, us=us_applied, J_pred=J_pred)

    return jax.jit(run)


def make_closed_loop_batch_constrained(pipe, model, T: int, lb, ub,
                                       n_al_iters: int = 4, mu0: float = 1e-2,
                                       mu_scale: float = 10.0,
                                       mu_max: float = 1e8,
                                       tol_constr: float = 1e-2,
                                       rescue=None, rescue_outers: int = 8):
    """Batched closed-loop MPC with input box constraints, fully jitted.

    Every plant step runs a FIXED ``n_al_iters`` augmented-Lagrangian outer
    iterations around the pipeline solve (multiplier state is rebuilt per
    window from mu0 — the receding-horizon analog of
    `solvers/al_pipeline.ALPipelineSolver`, with the convergence break
    replaced by the static outer budget so the whole T-step x B-instance
    simulation stays one XLA program).  Returns BatchMPCResult plus a
    (B, T) max-violation history as a 5th field via the J_pred tuple —
    see ``run``'s docstring.

    ``rescue``: optional `solvers.al_fast.ALFastSolver` built on the
    matching al_cost model and input-box constraint.  When set, any window
    whose fixed-budget pipeline solve leaves a lane above ``tol_constr``
    is re-solved IN-GRAPH by the line-searched AL loop on all lanes, and
    `jnp.where` on the unconverged mask keeps the rescue result only for
    the hard lanes (VERDICT round-2 item 6: the masked, jittable
    replacement for the host-side lane patching of `al_fast._rescue`).
    ``rescue_outers`` bounds the rescue's AL outer iterations.
    """
    H = pipe.N

    def run(dp, cp_full, q0s, xi0s):
        """Returns (BatchMPCResult, maxv (B, T) per-step max violation)."""
        B = q0s.shape[0]
        nu = model.nu
        C = 2 * nu
        params = {"dyn": dp, "cost": cp_full}
        dtp = xi0s.dtype
        lb_a = jnp.broadcast_to(jnp.asarray(lb, dtp), (nu,))
        ub_a = jnp.broadcast_to(jnp.asarray(ub, dtp), (nu,))

        def al_solve(cp_t, qs, xis, us_warm):
            lmbd = jnp.zeros((B, H + 1, C), dtp)
            imu = jnp.full((B, H + 1, C), jnp.asarray(mu0, dtp))
            mu = jnp.full((B,), jnp.asarray(mu0, dtp))

            def outer(carry, _):
                lmbd, imu, mu, _ = carry
                out = pipe._solve(dp, cp_t, qs, xis, us_warm,
                                  al=(lb_a, ub_a, lmbd, imu))
                glo = lb_a[None, None] - out.us
                ghi = out.us - ub_a[None, None]
                g = jnp.concatenate(
                    [jnp.concatenate([glo, ghi], axis=-1),
                     jnp.zeros((B, 1, C), dtp)], axis=1)
                # shared update rule with per-problem freeze of
                # already-satisfied instances (costs.al_update_diag)
                lmbd, imu, mu = costs.al_update_diag(
                    lmbd, imu, mu, g, mu_scale, mu_max,
                    freeze=jnp.max(g, axis=(1, 2)) < tol_constr)
                return (lmbd, imu, mu, out), None

            # lax.scan would require `out` in the carry with a concrete
            # initial value; a static unroll of n_al_iters is simpler and
            # identical (n_al_iters is small)
            carry = (lmbd, imu, mu, None)
            for _ in range(n_al_iters):
                carry, _ = outer(carry, None)
            return carry[3]

        def mpc_step(carry, t):
            qs, xis, us_warm = carry
            cp_t = _window(cp_full, t, H)
            out = al_solve(cp_t, qs, xis, us_warm)
            if rescue is not None:
                from trajectory_optimization_matrix_lie_groups.models import (
                    constraints as _cs,
                )

                mv_f = jnp.max(jnp.maximum(
                    jnp.maximum(lb_a[None, None] - out.us,
                                out.us - ub_a[None, None]), 0.0),
                    axis=(1, 2))
                constr_p = _cs.input_box_params(lb_a, ub_a, nu)
                alp0 = costs.al_init_params(cp_t, constr_p, H, C, mu0=mu0,
                                            dtype=dtp)
                al_b = rescue._broadcast_al(alp0, B)
                (_, _, _, us_r, J_r, _, _) = rescue._outer_loop_graph(
                    rescue._ls_solver(), dp, al_b, qs, xis, us_warm,
                    cp_t.q_ref, cp_t.xi_ref, rescue_outers)
                bad = mv_f >= tol_constr
                out = out._replace(
                    us=jnp.where(bad[:, None, None], us_r, out.us),
                    J_opt=jnp.where(bad, J_r, out.J_opt))
            u0 = jnp.clip(out.us[:, 0], lb_a, ub_a)  # actuator saturation
            maxv = jnp.maximum(
                jnp.max(jnp.maximum(lb_a[None, None] - out.us,
                                    out.us - ub_a[None, None]), axis=(1, 2)),
                0.0)
            q_next, xi_next = model.step(params, qs, xis, u0, 0)
            us_next = jnp.concatenate([out.us[:, 1:], out.us[:, -1:]], axis=1)
            return (q_next, xi_next, us_next), (q_next, xi_next, u0,
                                                out.J_opt, maxv)

        us0 = jnp.zeros((B, H, nu), dtype=dtp)
        (_, _, _), (qs_t, xis_t, us_applied, J_pred, maxv_t) = lax.scan(
            mpc_step, (q0s, xi0s, us0), jnp.arange(T))
        tb = lambda x: jnp.moveaxis(x, 0, 1)
        qs = jnp.concatenate([q0s[:, None], tb(qs_t)], axis=1)
        xis = jnp.concatenate([xi0s[:, None], tb(xis_t)], axis=1)
        return BatchMPCResult(qs=qs, xis=xis, us=tb(us_applied),
                              J_pred=tb(J_pred)), tb(maxv_t)

    return jax.jit(run)


def make_closed_loop_batch(pipe, model, T: int):
    """Batched Monte-Carlo closed-loop MPC on the lane-layout pipeline.

    B plant instances (perturbed starts / disturbance draws) track the SAME
    reference path in lockstep: every plant step slices one H-window of the
    reference, solves all B instances with the lane-layout pipeline
    (`solvers.pipeline.PipelineSolver` — ``pipe.iterations`` is the
    per-step budget, warm-started from the shifted previous solution),
    applies each instance's first control to its own plant, and advances.
    The whole T-step x B-instance simulation is one XLA program.

    Args:
      pipe: PipelineSolver with N = horizon H (its ``gravity`` flag
        must match ``model``).
      model: the LieModel of the same family (plant stepping).
      T: closed-loop steps; the full reference needs >= T + H + 1 entries.

    Returns:
      run(dp, cp_full, q0s, xi0s, noise_key=None, noise_sigma=0.0) ->
      BatchMPCResult.  With a key, every plant step adds i.i.d. twist
      disturbances sigma*N(0,1) per instance (Monte-Carlo robustness
      evaluation — the solver never sees the noise, only its effect).
    """
    H = pipe.N

    def run(dp, cp_full, q0s, xi0s, noise_key=None, noise_sigma=0.0):
        B = q0s.shape[0]
        nu = model.nu
        params = {"dyn": dp, "cost": cp_full}
        if noise_key is None:
            noise = jnp.zeros((T, B, 6), dtype=xi0s.dtype)
        else:
            noise = noise_sigma * jax.random.normal(
                noise_key, (T, B, 6), dtype=xi0s.dtype)

        def mpc_step(carry, inp):
            t, w = inp
            qs, xis, us_warm = carry
            cp_t = _window(cp_full, t, H)
            out = pipe._solve(dp, cp_t, qs, xis, us_warm)
            u0 = out.us[:, 0]
            q_next, xi_next = model.step(params, qs, xis, u0, 0)
            xi_next = xi_next + w
            us_next = jnp.concatenate([out.us[:, 1:], out.us[:, -1:]], axis=1)
            return (q_next, xi_next, us_next), (q_next, xi_next, u0,
                                                out.J_opt)

        us0 = jnp.zeros((B, H, nu), dtype=xi0s.dtype)
        (_, _, _), (qs_t, xis_t, us_applied, J_pred) = lax.scan(
            mpc_step, (q0s, xi0s, us0), (jnp.arange(T), noise))
        # scan stacks along axis 0 (time); move batch first
        tb = lambda x: jnp.moveaxis(x, 0, 1)
        qs = jnp.concatenate([q0s[:, None], tb(qs_t)], axis=1)
        xis = jnp.concatenate([xi0s[:, None], tb(xis_t)], axis=1)
        return BatchMPCResult(qs=qs, xis=xis, us=tb(us_applied),
                              J_pred=tb(J_pred))

    return jax.jit(run)
