"""Error-state SE(3) dynamics and costs (12-d vector state).

Replaces the reference's error-state family:

  - `ErrorStateSE3ApproxLinearRolloutDynamics`   (traopt_dynamics.py:1534)
  - `ErrorStateSE3ApproxNonlinearRolloutDynamics` (traopt_dynamics.py:2038)
  - `ErrorStateSE3ApproxTrackingQuadraticAutodiffCost` (traopt_cost.py:1326)
  - `ErrorStateSE3ApproxGenerationQuadraticAutodiffCost` (traopt_cost.py:1577)

State x = [psi (6), xi (6)]: psi = Log(Xref_i^-1 X) is the left-invariant
error w.r.t. a stored reference trajectory, xi the body twist.  The
continuous error-state linearization about (q_ref, xi_ref) is
(ref `_fc_errstate`, traopt_dynamics.py:2235-2281):

    xdot = At x + Bt u + ht,
    At = [[-ad(xi_ref_i), I], [0, Ht(xi)]],  Ht = Jinv (coad(xi) J + G(xi)),
    ht = [-xi_ref_i; -Jinv G(xi) xi],  Bt = [0; Jinv]

Note At/ht depend on the *current* x through Ht — the reference autodiffs
the discretized map (`jit(jacfwd(fd_euler))`, traopt_dynamics.py:2113) and
so do we (vmapped over all stages at once).

The reference re-anchors by mutating `dynamics._q_ref` / calling
`cost.ref_reinitialize` (traopt_controller.py:4546-4552, with scipy `logm`);
here re-anchoring is a pure params update with the closed-form SE(3) Log.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.utils.linalg import setup_inv
from trajectory_optimization_matrix_lie_groups.ops import se3


def _bmv(M, v):
    return jnp.einsum("...ij,...j->...i", M, v)


class ErrorStateParams(NamedTuple):
    J: jnp.ndarray        # (6, 6)
    Jinv: jnp.ndarray
    Ib: jnp.ndarray
    m: jnp.ndarray
    dt: jnp.ndarray
    q_ref: jnp.ndarray    # (N+1, 4, 4) anchor trajectory
    xi_ref: jnp.ndarray   # (N+1, 6)


def errorstate_params(J, dt, q_ref, xi_ref):
    J = jnp.asarray(J)
    q_ref = jnp.asarray(q_ref)
    return ErrorStateParams(
        J=J, Jinv=setup_inv(J), Ib=J[:3, :3], m=J[4, 4],
        dt=jnp.asarray(dt), q_ref=q_ref,
        xi_ref=jnp.asarray(xi_ref).reshape(q_ref.shape[0], 6),
    )


def _G(p, xi):
    w, v = xi[..., :3], xi[..., 3:]
    from trajectory_optimization_matrix_lie_groups.ops import so3
    Gw = so3.hat(_bmv(p.Ib, w))
    Gv = p.m * so3.hat(v)
    top = jnp.concatenate([Gw, Gv], axis=-1)
    bot = jnp.concatenate([Gv, jnp.zeros_like(Gw)], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def fc_errstate(p: ErrorStateParams, x, u, i):
    """Continuous linearized error-state dynamics (ref :2235-2281)."""
    psi = x[..., :6]
    xi = x[..., 6:]
    H = p.Jinv @ (se3.coad(xi) @ p.J + _G(p, xi))
    bt = -_bmv(p.Jinv @ _G(p, xi), xi)
    xi_ref_i = p.xi_ref[i]
    psi_dot = -_bmv(se3.ad(xi_ref_i), psi) + xi - xi_ref_i
    xi_dot = _bmv(H, xi) + _bmv(p.Jinv, u) + bt
    return jnp.concatenate([psi_dot, xi_dot], axis=-1)


def step_euler(p: ErrorStateParams, x, u, i):
    """fd_euler of the error-state linearization (ref :2283-2296)."""
    return x + fc_errstate(p, x, u, i) * p.dt


def step_rk4(p: ErrorStateParams, x, u, i):
    """fd_rk4 (ref :2298-2316)."""
    s1 = fc_errstate(p, x, u, i)
    s2 = fc_errstate(p, x + p.dt / 2 * s1, u, i)
    s3 = fc_errstate(p, x + p.dt / 2 * s2, u, i)
    s4 = fc_errstate(p, x + p.dt * s3, u, i)
    return x + p.dt / 6 * (s1 + 2 * s2 + 2 * s3 + s4)


def jac_autodiff(step):
    """Batched autodiff Jacobians of an error-state step (ref :2113-2114)."""

    def jac(p, x, u, i):
        fx = jax.jacfwd(lambda xx: step(p, xx, u, i))(x)
        fu = jax.jacfwd(lambda uu: step(p, x, uu, i))(u)
        return fx, fu

    return jac


def jac_analytic(p: ErrorStateParams, x, u, i):
    """The reference's ANALYTIC error-state Jacobians
    (`At`/`Bt`, traopt_dynamics.py:1742-1800): continuous
    At = [[-ad(xi_ref), I], [0, Ht]] with Ht = Jinv(coad(xi) J + G(xi)),
    Bt = [0; Jinv]; Euler-discretized Fx = I + At dt, Fu = Bt dt.

    For the EULER step this is the *exact* Jacobian of `step_euler`: in
    `fc_errstate` the G terms cancel algebraically
    (Ht(xi) xi + bt(xi) = Jinv coad(xi) J xi) and
    d/dxi [coad(xi) J xi] = coad(xi) J + G(xi), so autodiff of the Euler
    map agrees with I + At dt to roundoff at every x — not just at the
    anchor.  A genuine analytic-vs-autodiff gap (what the reference's
    `derivative_compare` debug flag measures,
    `traopt_controller.py:3585-3624`) appears only for higher-order
    integrators (`step_rk4`), where this closed form stays first-order
    I + At dt while the autodiff Jacobian carries the O(dt^2) composition
    terms."""
    del u
    xi = x[..., 6:]
    H = p.Jinv @ (se3.coad(xi) @ p.J + _G(p, xi))
    Z = jnp.zeros_like(H)
    eye6 = jnp.broadcast_to(jnp.eye(6, dtype=x.dtype), H.shape)
    ad_ref = jnp.broadcast_to(se3.ad(p.xi_ref[i]), H.shape)
    At = jnp.concatenate([
        jnp.concatenate([-ad_ref, eye6], axis=-1),
        jnp.concatenate([Z, H], axis=-1),
    ], axis=-2)
    Bt = jnp.concatenate(
        [jnp.zeros_like(p.Jinv), p.Jinv], axis=-2)
    Fx = jnp.broadcast_to(jnp.eye(12, dtype=x.dtype), At.shape) + At * p.dt
    Fu = jnp.broadcast_to(Bt, x.shape[:-1] + (12, 6)) * p.dt
    return Fx, Fu


def group_step(p: ErrorStateParams, q, xi, u, i):
    """Exact nonlinear group rollout step (`_fd_euler_fc_group`, ref :2371)."""
    q_next = se3.normalize(q @ se3.exp(xi * p.dt))
    xi_dot = _bmv(p.Jinv, _bmv(se3.coad(xi), _bmv(p.J, xi)) + u)
    return q_next, xi + xi_dot * p.dt


def rollout_nominal(p: ErrorStateParams, q0, xi0, us):
    """Roll the group trajectory from u (ref `rollout_nominal...`, :2214)."""
    def step(carry, inp):
        q, xi = carry
        u, i = inp
        qn, xin = group_step(p, q, xi, u, i)
        return (qn, xin), (qn, xin)

    N = us.shape[0]
    (_, _), (qs_t, xis_t) = jax.lax.scan(step, (q0, xi0), (us, jnp.arange(N)))
    qs = jnp.concatenate([q0[None], qs_t], axis=0)
    xis = jnp.concatenate([xi0[None], xis_t], axis=0)
    return qs, xis


def reanchor(p: ErrorStateParams, qs_new, xis_new):
    """Re-anchor the reference to a new group trajectory (pure update).

    ref traopt_controller.py:4546-4552 mutates dynamics/cost state; here the
    returned params replace it.
    """
    return p._replace(q_ref=qs_new, xi_ref=xis_new)


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------

class ErrorStateTrackingCostParams(NamedTuple):
    Q: jnp.ndarray      # (12, 12)
    R: jnp.ndarray      # (nu, nu)
    P: jnp.ndarray      # (12, 12)
    xi_ref: jnp.ndarray  # (N+1, 6)


def tracking_cost_es(p: ErrorStateTrackingCostParams, x, u, i, terminal=False):
    """y = Ct x - dt with velocity coupling Ct (ref traopt_cost.py:1436-1445)."""
    psi = x[..., :6]
    xi = x[..., 6:]
    xi_ref_i = p.xi_ref[i]
    y = jnp.concatenate([psi, -_bmv(se3.ad(xi_ref_i), psi) + xi - xi_ref_i], axis=-1)
    W = p.P if terminal else p.Q
    c = jnp.einsum("...i,ij,...j->...", y, W, y)
    if not terminal:
        c = c + jnp.einsum("...i,ij,...j->...", u, p.R, u)
    return c


class ErrorStateGoalCostParams(NamedTuple):
    Q: jnp.ndarray       # (6, 6) pose-error weight
    R: jnp.ndarray
    P: jnp.ndarray       # (6, 6)
    phi_goal: jnp.ndarray  # (N+1, 6): Log(Xref_i^-1 X_goal)


def goal_cost_params(Q, R, P, q_ref, X_goal):
    """phi_goal_i = Log(Xref_i^-1 X_goal) — closed form, replacing the
    reference's per-stage scipy `logm` (traopt_cost.py:1624-1638)."""
    q_ref = jnp.asarray(q_ref)
    phi = se3.log(se3.inverse(q_ref) @ jnp.asarray(X_goal))
    return ErrorStateGoalCostParams(
        Q=jnp.asarray(Q), R=jnp.asarray(R), P=jnp.asarray(P), phi_goal=phi
    )


def goal_cost(p: ErrorStateGoalCostParams, x, u, i, terminal=False):
    """l = ||psi - phi_goal_i||^2_Q (+ u^T R u)  (ref traopt_cost.py:1717-1761)."""
    y = x[..., :6] - p.phi_goal[i]
    W = p.P if terminal else p.Q
    c = jnp.einsum("...i,ij,...j->...", y, W, y)
    if not terminal:
        c = c + jnp.einsum("...i,ij,...j->...", u, p.R, u)
    return c
