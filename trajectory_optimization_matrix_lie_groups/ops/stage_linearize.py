"""Lane-layout stage math of the SE(3) linearization + GN quadratization.

Per stage, with B problems on the trailing (lane) axis:

    dynamics eval   fq = normalize(q Exp(xi dt)),  fxi (Euler-Poincare)
    dynamics jac    Fx = [[Ad(Exp(-tau)), Jr(tau) dt], [0, I + H dt]]
                    (H with the reference coad-swap quirk)
    cost quad       e = Log(q qbar^-1),  J_e_x = Jr^-1(e) Ad(qbar),
                    l, lx, lxx (Gauss-Newton)

Used by the pipeline's stage recursions (`solvers/pipeline.py`) and the
double-f32 polish (every function is DF-polymorphic).

Scope: `se3_dynamics` + GN tracking cost (the MPC benchmark family).
"""

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops import dfx
from trajectory_optimization_matrix_lie_groups.ops import lie_lane as ll


def _cross(a, b):
    return ll._vec([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def stage_dynamics_eval(R, p, xi, u, Jl, Jil, Pu, mg, *, dt, gravity,
                        terms=None, renorm=None):
    """Semi-implicit Euler step in lane layout (models/dynamics.py:196,287):
    fq = normalize(q Exp(xi dt)); fxi = xi + dt Jinv (coad(xi) J xi
    [+ m g R^T down] + Pu u).  Shared by the linearization and the
    rollout.  ``terms``/``renorm``: DF series truncation and renormalizer
    override for the polish rollout (whose per-step rotation |xi| dt is
    small; defaults unchanged)."""
    Re, pe = ll.se3_exp(xi * dt, terms=terms)
    fqR, fqp = ll.se3_compose(R, p, Re, pe)
    fqR = (renorm or ll.so3_normalize)(fqR)
    Jxi = ll.matvec(Jl, xi, 6)
    w, v = xi[:3], xi[3:]
    nu = u.shape[0]
    wrench = dfx.concatenate(
        [-_cross(w, Jxi[:3]) - _cross(v, Jxi[3:]), -_cross(w, Jxi[3:])],
        axis=0) + ll.matvec(Pu, u, nu)
    if gravity:
        # down = (0, 0, -1): R^T down = -(third row of R)
        g_lin = -mg[0][None, :] * R[2]
        wrench = wrench + dfx.concatenate(
            [dfx.zeros_like(g_lin), g_lin], axis=0)
    fxi = xi + dt * ll.matvec(Jil, wrench, 6)
    return fqR, fqp, fxi


def stage_jacobian(R, xi, Jl, Jil, mg, *, dt, gravity, exact_grav):
    """Lane-layout Fx (models/dynamics.py:234 free body, :1092 gravity) with
    the reference's coad-swap quirk #1 (traopt_dynamics.py:819,832) and its
    gravity-Jacobian quirk #2 (no m*g factor unless ``exact_grav``,
    traopt_dynamics.py:1121-1134)."""
    bs = R.shape[2:]  # trailing batch dims
    dtp = R.dtype
    w, v = xi[:3], xi[3:]
    tau = xi * dt
    ReN, peN = ll.se3_exp(-tau)
    J_q_q = ll.se3_Ad(ReN, peN)
    J_q_xi = ll.se3_right_jacobian(tau) * dt
    # coad(eta) = ad(eta)^T = [[-hat(ew), -hat(ev)], [0, -hat(ew)]],
    # applied to the [v, w]-SWAPPED twist (reference quirk #1)
    coad_sw = ll.blk(-ll.hat(v), -ll.hat(w),
                      dfx.zeros((3, 3) + bs, dtp, like=v), -ll.hat(v))
    Ibw = ll.matvec3(Jl[0:3, 0:3], w)
    m = Jl[4, 4]
    Gw = ll.hat(Ibw)
    Gv = m[None, None] * ll.hat(v)
    G = ll.blk(Gw, Gv, Gv, dfx.zeros((3, 3) + bs, dtp, like=Gv))
    H = ll.matmul(Jil, ll.matmul(coad_sw, Jl, 6) + G, 6)
    eye6 = ll.blk(ll._eye3(dtp, bs), jnp.zeros((3, 3) + bs, dtp),
                   jnp.zeros((3, 3) + bs, dtp), ll._eye3(dtp, bs))
    if gravity:
        grow = -R[2] if not exact_grav else -(mg[0][None] * R[2])
        Z3 = dfx.zeros((3, 3) + bs, dtp, like=R)
        J_xi_q = ll.matmul(Jil, ll.blk(Z3, Z3, ll.hat(grow), Z3), 6) * dt
    else:
        J_xi_q = dfx.zeros((6, 6) + bs, dtp, like=R)
    return ll.blk(J_q_q, J_q_xi, J_xi_q, eye6 + H * dt)


def stage_cost_quad(R, p, xi, RbiR, Rbip, Adb, xib, W1, W2):
    """Lane-layout GN tracking quadratization (models/costs.py:103):
    e = Log(q q_ref^-1), J_e_x = Jr^-1(e) Ad_ref; returns (lx (12,B),
    lxx (12,12,B), l (B,)).  Also the terminal quadratization with (P1, P2)
    weights (the Riccati recursion's carry init)."""
    bs = R.shape[2:]  # trailing batch dims
    dtp = R.dtype
    Reb, peb = ll.se3_compose(R, p, RbiR, Rbip)
    e = ll.se3_log(Reb, peb)
    ev = xi - xib
    Jex = ll.matmul(ll.se3_right_jacobian_inv(e), Adb, 6)
    JT2 = 2.0 * ll.transpose(Jex)
    W1e = ll.matvec(W1, e, 6)
    W2ev = ll.matvec(W2, ev, 6)
    lx = dfx.concatenate([ll.matvec(JT2, W1e, 6), 2.0 * W2ev], axis=0)
    H_e = ll.matmul(ll.matmul(JT2, W1, 6), Jex, 6)
    lxx = ll.blk(H_e, dfx.zeros((6, 6) + bs, dtp, like=H_e),
                  dfx.zeros((6, 6) + bs, dtp, like=H_e), 2.0 * W2)
    l_val = (sum(e[i] * W1e[i] for i in range(6))
             + sum(ev[i] * W2ev[i] for i in range(6)))
    return lx, lxx, l_val
