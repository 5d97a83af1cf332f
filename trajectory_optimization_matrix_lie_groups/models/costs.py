"""Gauss-Newton tracking costs on SO(3)/SE(3) and the AL cost transformer.

Replaces the reference cost classes (`traoptlibrary/traopt_cost.py`):

  - `SO3TrackingQuadraticGaussNewtonCost:280` / `SE3TrackingQuadraticGaussNewtonCost:570`
    / `DroneTrackingQuadraticGaussNewtonCost:870` -> one group-generic
    `tracking_cost` (the drone variant is the SE(3) cost with nu=4, which is
    how the reference scripts actually use it,
    `benchmark_drone_racing_tracking.py:210`).
  - `ALConstrainedCost:1173` -> `al_cost` transformer carrying (lmbd, Imu, mu)
    in its params pytree.

Cost (ref docstring traopt_cost.py:578-584):
    l  = ||Log(X Xbar^-1)||^2_Q1 + ||xi - xibar||^2_Q2 + ||u||^2_R
    lN = ||Log(X Xbar^-1)||^2_P1 + ||xi - xibar||^2_P2

The pose error is the *left* difference (manif `lminus`,
traopt_cost.py:695), whose right-perturbation Jacobian is
``J_e_x = Jr^-1(e) @ Ad(Xbar)`` — closed form here where the reference calls
into manif.  ``Ad(Xbar_i)`` is reference-only, so it is precomputed once at
construction instead of per solver iteration.
"""

from typing import NamedTuple

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models.base import CostDef
from trajectory_optimization_matrix_lie_groups.ops.group import Group


def _bmv(M, v):
    return jnp.einsum("...ij,...j->...i", M, v)


class TrackingCostParams(NamedTuple):
    Q1: jnp.ndarray       # (d, d) pose-error weight
    Q2: jnp.ndarray       # (d, d) velocity-error weight
    R: jnp.ndarray        # (nu, nu)
    P1: jnp.ndarray       # (d, d) terminal pose weight
    P2: jnp.ndarray       # (d, d) terminal velocity weight
    q_ref: jnp.ndarray    # (N+1, m, m)
    q_ref_inv: jnp.ndarray  # (N+1, m, m) precomputed inverses
    Ad_ref: jnp.ndarray   # (N+1, d, d) precomputed Ad(q_ref)
    xi_ref: jnp.ndarray   # (N+1, d)


def tracking_cost_params(group: Group, Q, R, P, q_ref, xi_ref):
    """Build params from the reference's stacked Q/R/P layout.

    Q and P are (2d, 2d) with pose block first (ref traopt_cost.py:697-702).
    """
    d = group.dim
    Q = jnp.asarray(Q)
    P = jnp.asarray(P)
    q_ref = jnp.asarray(q_ref)
    xi_ref = jnp.asarray(xi_ref).reshape(q_ref.shape[0], d)
    return TrackingCostParams(
        Q1=Q[:d, :d], Q2=Q[d:, d:], R=jnp.asarray(R), P1=P[:d, :d], P2=P[d:, d:],
        q_ref=q_ref, q_ref_inv=group.inverse(q_ref), Ad_ref=group.Ad(q_ref),
        xi_ref=xi_ref,
    )


def tracking_cost(group: Group, nu: int, ref_so3_terminal_quirk: bool = False) -> CostDef:
    """Gauss-Newton tracking cost.

    `ref_so3_terminal_quirk` replicates the reference SO(3) cost class's
    terminal inconsistency (`SO3TrackingQuadraticGaussNewtonCost`,
    traopt_cost.py:433-438 and :477-487 vs :526-531): the terminal *value*
    and *gradient* use the stage weights Q, while the terminal *Hessian*
    uses P.  The SE(3) class (traopt_cost.py:709-738, :781-786) uses P
    consistently, so the flag is only set for SO(3)-family parity builds.
    """
    d = group.dim

    def _err(p: TrackingCostParams, q, xi, i):
        # left difference Log(X Xbar^-1)  (ref traopt_cost.py:695)
        e = group.log(q @ p.q_ref_inv[i])
        ev = xi - p.xi_ref[i]
        return e, ev

    def stage_cost(p, q, xi, u, i):
        e, ev = _err(p, q, xi, i)
        return (
            jnp.einsum("...i,ij,...j->...", e, p.Q1, e)
            + jnp.einsum("...i,ij,...j->...", ev, p.Q2, ev)
            + jnp.einsum("...i,ij,...j->...", u, p.R, u)
        )

    def term_cost(p, q, xi, i):
        e, ev = _err(p, q, xi, i)
        W1, W2 = (p.Q1, p.Q2) if ref_so3_terminal_quirk else (p.P1, p.P2)
        return (
            jnp.einsum("...i,ij,...j->...", e, W1, e)
            + jnp.einsum("...i,ij,...j->...", ev, W2, ev)
        )

    def _quad(p, q, xi, i, W1, W2):
        e, ev = _err(p, q, xi, i)
        J_e_x = group.Jr_inv(e) @ p.Ad_ref[i]
        JT2 = 2.0 * jnp.swapaxes(J_e_x, -1, -2)
        lx = jnp.concatenate([_bmv(JT2 @ W1, e), 2.0 * _bmv(W2, ev)], axis=-1)
        H_e = JT2 @ W1 @ J_e_x
        H_v = jnp.broadcast_to(2.0 * W2, H_e.shape)
        Z = jnp.zeros_like(H_e)
        lxx = jnp.concatenate(
            [jnp.concatenate([H_e, Z], axis=-1), jnp.concatenate([Z, H_v], axis=-1)],
            axis=-2,
        )
        l = (
            jnp.einsum("...i,ij,...j->...", e, W1, e)
            + jnp.einsum("...i,ij,...j->...", ev, W2, ev)
        )
        return l, lx, lxx

    def stage_quad(p, q, xi, u, i):
        l, lx, lxx = _quad(p, q, xi, i, p.Q1, p.Q2)
        l = l + jnp.einsum("...i,ij,...j->...", u, p.R, u)
        lu = 2.0 * _bmv(p.R, u)
        luu = jnp.broadcast_to(2.0 * p.R, (*lu.shape[:-1], nu, nu))
        lux = jnp.zeros((*lu.shape[:-1], nu, 2 * d), dtype=lu.dtype)
        return l, lx, lu, lxx, lux, luu

    def term_quad(p, q, xi, i):
        if not ref_so3_terminal_quirk:
            return _quad(p, q, xi, i, p.P1, p.P2)
        # quirk: value+gradient from Q, Hessian from P (see docstring)
        l, lx, _ = _quad(p, q, xi, i, p.Q1, p.Q2)
        _, _, lxx = _quad(p, q, xi, i, p.P1, p.P2)
        return l, lx, lxx

    return CostDef(
        nx=2 * d, nu=nu, stage_cost=stage_cost, term_cost=term_cost,
        stage_quad=stage_quad, term_quad=term_quad,
    )


def tracking_error(group: Group, p: TrackingCostParams, q, xi, i):
    """Pose/velocity error vs the reference (ref `_err`, traopt_cost.py:659)."""
    e = group.log(q @ p.q_ref_inv[i])
    return e, xi - p.xi_ref[i]


# ---------------------------------------------------------------------------
# Augmented Lagrangian transformer  (ref ALConstrainedCost, traopt_cost.py:1173)
# ---------------------------------------------------------------------------

class ALParams(NamedTuple):
    cost: TrackingCostParams
    constr: NamedTuple
    lmbd: jnp.ndarray  # (N+1, c)
    Imu: jnp.ndarray   # (N+1, c, c)
    mu: jnp.ndarray    # scalar penalty


def al_cost(base: CostDef, constraint) -> CostDef:
    """Wrap a cost with LA = l + lambda^T g + 1/2 g^T Imu g.

    `constraint` is a ConstraintDef (models.constraints).  Derivative
    composition follows traopt_cost.py:1251-1320 exactly.
    """

    def _terms(p: ALParams, q, xi, u, i, terminal):
        g = constraint.g(p.constr, q, xi, u, i, terminal)
        gx = constraint.g_x(p.constr, q, xi, u, i, terminal)
        gu = constraint.g_u(p.constr, q, xi, u, i, terminal)
        # stage-indexed from the trailing axes so per-problem (batched)
        # multipliers (B, N+1, c) work transparently alongside (N+1, c)
        lam = jnp.take(p.lmbd, i, axis=-2)
        Imu = jnp.take(p.Imu, i, axis=-3)
        return g, gx, gu, lam, Imu

    def stage_cost(p, q, xi, u, i):
        g, _, _, lam, Imu = _terms(p, q, xi, u, i, False)
        base_l = base.stage_cost(p.cost, q, xi, u, i)
        return base_l + jnp.einsum("...c,...c->...", lam, g) + 0.5 * jnp.einsum(
            "...c,...cd,...d->...", g, Imu, g
        )

    def term_cost(p, q, xi, i):
        u = jnp.zeros(base.nu, dtype=xi.dtype)
        g, _, _, lam, Imu = _terms(p, q, xi, u, i, True)
        base_l = base.term_cost(p.cost, q, xi, i)
        return base_l + jnp.einsum("...c,...c->...", lam, g) + 0.5 * jnp.einsum(
            "...c,...cd,...d->...", g, Imu, g
        )

    def stage_quad(p, q, xi, u, i):
        l0, lx0, lu0, lxx0, lux0, luu0 = base.stage_quad(p.cost, q, xi, u, i)
        g, gx, gu, lam, Imu = _terms(p, q, xi, u, i, False)
        lig = lam + _bmv(Imu, g)
        gxT = jnp.swapaxes(gx, -1, -2)
        guT = jnp.swapaxes(gu, -1, -2)
        l = l0 + jnp.einsum("...c,...c->...", lam, g) + 0.5 * jnp.einsum(
            "...c,...cd,...d->...", g, Imu, g
        )
        lx = lx0 + _bmv(gxT, lig)
        lu = lu0 + _bmv(guT, lig)
        lxx = lxx0 + gxT @ Imu @ gx
        luu = luu0 + guT @ Imu @ gu
        lux = lux0 + guT @ Imu @ gx
        return l, lx, lu, lxx, lux, luu

    def term_quad(p, q, xi, i):
        u = jnp.zeros(base.nu, dtype=xi.dtype)
        l0, lx0, lxx0 = base.term_quad(p.cost, q, xi, i)
        g, gx, gu, lam, Imu = _terms(p, q, xi, u, i, True)
        lig = lam + _bmv(Imu, g)
        gxT = jnp.swapaxes(gx, -1, -2)
        l = l0 + jnp.einsum("...c,...c->...", lam, g) + 0.5 * jnp.einsum(
            "...c,...cd,...d->...", g, Imu, g
        )
        lx = lx0 + _bmv(gxT, lig)
        lxx = lxx0 + gxT @ Imu @ gx
        return l, lx, lxx

    return CostDef(
        nx=base.nx, nu=base.nu, stage_cost=stage_cost, term_cost=term_cost,
        stage_quad=stage_quad, term_quad=term_quad,
    )


def al_init_params(cost_params, constr_params, N, constr_size, mu0=1e-2, dtype=jnp.float64):
    """Initial AL state (ref AL_iLQR_Tracking_SE3_MS:3182-3189)."""
    return ALParams(
        cost=cost_params,
        constr=constr_params,
        lmbd=jnp.zeros((N + 1, constr_size), dtype=dtype),
        Imu=jnp.tile(mu0 * jnp.eye(constr_size, dtype=dtype), (N + 1, 1, 1)),
        mu=jnp.asarray(mu0, dtype=dtype),
    )


def al_update_diag(lmbd, imu, mu, g, mu_scale=10.0, mu_max=1e8,
                   freeze=None):
    """Diagonal-Imu variant of `al_update_params` for batched engines that
    carry (B, N+1, c) multipliers and (B, N+1, c) diagonal penalties
    (the fused pipeline and the jitted constrained MPC).  Same rule:
    lmbd <- clip(lmbd + imu g, 0, inf); mu <- min(mu scale, cap);
    imu <- (g < 0 and lmbd == 0) ? 0 : mu — with the optional per-problem
    ``freeze`` mask (B,) leaving converged problems untouched."""
    lmbd_new = jnp.clip(lmbd + imu * g, 0.0, None)
    mu_new = jnp.minimum(mu * mu_scale, mu_max)
    if freeze is not None:
        frz = freeze[:, None, None]
        lmbd_new = jnp.where(frz, lmbd, lmbd_new)
        mu_new = jnp.where(freeze, mu, mu_new)
    imu_new = jnp.where((g < 0.0) & (lmbd_new == 0.0), 0.0,
                        mu_new[:, None, None])
    if freeze is not None:
        imu_new = jnp.where(freeze[:, None, None], imu, imu_new)
    return lmbd_new, imu_new, mu_new


def al_update_params(p: ALParams, constr_eval, mu_scale=10.0, mu_max=1e8,
                     freeze=None):
    """First-order multiplier update + penalty escalation.

    ref `_al_update_param` (traopt_controller.py:3270-3290):
        lmbd <- clip(lmbd + Imu g, 0, inf)
        mu   <- min(mu * scale, mu_max)
        Imu  <- diag(where(g < 0 and lmbd == 0, 0, mu))

    ``freeze``: optional (B,) bool mask of problems whose AL state must NOT
    change.  The reference solves one problem and STOPS updating at
    convergence (traopt_controller.py:3250); the faithful batch
    generalization freezes each converged problem individually — without
    it, a batch's collective outer loop keeps escalating penalties on
    problems already sitting on the constraint boundary (g ~ 0 keeps
    Imu = mu growing to mu_max) until it destabilizes them.
    """
    lmbd_new = jnp.clip(
        p.lmbd + jnp.einsum("...cd,...d->...c", p.Imu, constr_eval), 0.0, None
    )
    mu_new = jnp.minimum(p.mu * mu_scale, mu_max)
    if freeze is not None:
        # per-problem mu: broadcast a scalar mu up to (B,) on first use
        mu_b = jnp.broadcast_to(p.mu, freeze.shape)
        mu_new = jnp.where(freeze, mu_b, jnp.minimum(mu_b * mu_scale, mu_max))
        lmbd_new = jnp.where(freeze[:, None, None], p.lmbd, lmbd_new)
    act_mu = mu_new[..., None, None] if freeze is not None else mu_new
    active = jnp.where((constr_eval < 0.0) & (lmbd_new == 0.0), 0.0, act_mu)
    c = constr_eval.shape[-1]
    Imu_new = active[..., :, None] * jnp.eye(c, dtype=active.dtype)
    if freeze is not None:
        Imu_new = jnp.where(freeze[:, None, None, None], p.Imu, Imu_new)
    return p._replace(lmbd=lmbd_new, Imu=Imu_new, mu=mu_new)
