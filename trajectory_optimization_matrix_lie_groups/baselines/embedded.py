"""Embedded-Euclidean baselines as JAX programs.

The reference's baseline family (`traoptlibrary/traopt_baseline.py`, 18
classes) optimizes over raw quaternion/rotation entries with CasADi+IPOPT.
IPOPT cannot run on an accelerator (and casadi is not installed here), so the same
*formulations* are re-expressed as JAX programs solved with this framework's
own engines:

  - `su2_model` — the "Embedded Euclidean SU(2)" formulation
    (`EmbeddedEuclideanSU2_SE3:642`): state x = [quat(4), pos(3), xi(6)] in
    R^13, quaternion kinematics with NO manifold constraint, chordal cost on
    the raw quaternion difference (`traopt_baseline.py:891-893`), solved by
    single-shooting iLQR instead of an equality-constrained NLP.

Deviation note: the reference's velocity dynamics constraint drops the
`+ xi_k` integrator term (`traopt_baseline.py:866-867`:
``xik_prop = dt*J_inv(...)`` with no ``xik +``) — an apparent bug not
replicated here; we integrate ``xi_{k+1} = xi_k + dt J^-1(coad(xi) J xi + u)``
like every other model in the reference.

The embedded method's characteristic failure mode — quaternion norm drift
(no manifold enforcement) — is preserved: nothing renormalizes q, and
`utils.metrics.quat_norm_violation` measures it, mirroring the benchmark's
orthogonality-violation metric (`benchmark_SE3_tracking.py:414-418`).
"""

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models.autodiff import autodiff_model
from trajectory_optimization_matrix_lie_groups.ops import se3
from trajectory_optimization_matrix_lie_groups.solvers.ilqr import ILQR, ILQRConfig


def _quat_mul(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def _quat_rotate(q, v):
    """Rotate v by (possibly non-unit) quaternion q, as the embedded method
    does — through the quaternion sandwich without normalization."""
    qv = jnp.concatenate([jnp.zeros_like(v[..., :1]), v], axis=-1)
    qc = q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)
    return _quat_mul(_quat_mul(q, qv), qc)[..., 1:]


def su2_model(J, dt, q_ref, xi_ref, Q, R, P, nu=6):
    """Embedded SU(2)/R^13 model + cost, solved by Euclidean iLQR.

    q_ref: (N+1, 4, 4) SE(3) reference (converted to quat-pos here);
    weights follow the reference's slicing (`traopt_baseline.py:684-697`):
    alpha = Q[0,0] on the raw quaternion difference, Qp = Q[3:6,3:6] on
    position, Qw = Q[6:,6:] on the twist.
    """
    J = jnp.asarray(J)
    Jinv = jnp.linalg.inv(J)
    quat_ref = se3.quatpos_from_matrix(jnp.asarray(q_ref))  # (N+1, 7)
    xi_ref = jnp.asarray(xi_ref).reshape(quat_ref.shape[0], 6)
    Q = jnp.asarray(Q)
    P = jnp.asarray(P)
    alpha, alphaN = Q[0, 0], P[0, 0]
    Qp, Pp = Q[3:6, 3:6], P[3:6, 3:6]
    Qw, Pw = Q[6:, 6:], P[6:, 6:]
    R = jnp.asarray(R)

    def f(x, u, i):
        q, p, xi = x[:4], x[4:7], x[7:]
        w, v = xi[:3], xi[3:]
        q_next = q + dt * 0.5 * _quat_mul(q, jnp.concatenate([jnp.zeros(1), w]))
        p_next = p + dt * _quat_rotate(q, v)
        wrench = se3.coad(xi) @ (J @ xi) + u
        xi_next = xi + dt * (Jinv @ wrench)
        return jnp.concatenate([q_next, p_next, xi_next])

    def _stage(x, i, a, Wp, Ww):
        dq = x[:4] - quat_ref[i, :4]
        dp = x[4:7] - quat_ref[i, 4:]
        dxi = x[7:] - xi_ref[i]
        return a * dq @ dq + dp @ Wp @ dp + dxi @ Ww @ dxi

    def l(x, u, i):
        return _stage(x, i, alpha, Qp, Qw) + u @ R @ u

    def l_terminal(x, i):
        return _stage(x, i, alphaN, Pp, Pw)

    return autodiff_model(f, l, l_terminal, 13, nu)


def solve_su2(J, dt, q_ref, xi_ref, Q, R, P, x0, us_init, nu=6,
              n_iterations=200, tol_grad_norm=1e-6):
    """Build and solve the embedded baseline; returns (xs, us, J_hist, ...)."""
    model = su2_model(J, dt, q_ref, xi_ref, Q, R, P, nu=nu)
    N = jnp.asarray(us_init).shape[0]
    cfg = ILQRConfig(N=int(N), tol_grad_norm=tol_grad_norm,
                     max_iterations=n_iterations)
    solver = ILQR(model, cfg)
    q0, xi0 = x0
    x0_vec = jnp.concatenate([se3.quatpos_from_matrix(jnp.asarray(q0)),
                              jnp.asarray(xi0).reshape(6)])
    return solver.fit(x0_vec, us_init, n_iterations=n_iterations)


# ---------------------------------------------------------------------------
# Embedded rotation-matrix families (R^18 state)
# ---------------------------------------------------------------------------

def se3_matrix_model(J, dt, q_ref, xi_ref, Q, R, P, variant="dynconstr",
                     kappa=1.0, nu=6):
    """Embedded rotation-entry baselines as R^18 iLQR models.

    Re-expresses the reference's remaining CasADi baseline families — the
    optimizer works on raw rotation-matrix entries, with the manifold
    structure entering only through the chosen propagation/cost:

      - 'dynconstr':  exp-map propagation of R, chordal cost ||R - Rbar||_F^2
        (`EmbeddedEuclideanSE3_DynamicsConstr:4321`; the IPOPT equality
        constraints become the rollout dynamics of a single-shooting iLQR)
      - 'logcost':    exp-map propagation, geodesic cost ||Log(R Rbar^T)||^2
        (`EmbeddedEuclideanSE3_DynamicsConstr_LogCost:3553`)
      - 'stabilized': Baumgarte-style orthogonality-restoring propagation
        R' = R (Exp(w dt) + kappa/2 ((R^T R)^-1 - I)), chordal cost — the
        "MatrixNorm" family (`ConstraintStabilizationSE3_MatrixNorm:5420`,
        form at traopt_baseline.py:2644-2646)
      - 'stabilized_logcost': the same kappa-propagation with the geodesic
        cost (`ConstraintStabilizationSE3:5028`)

    State x = [vec(R) (9), p (3), xi (6)].
    """
    J = jnp.asarray(J)
    Jinv = jnp.linalg.inv(J)
    q_ref = jnp.asarray(q_ref)
    R_ref = q_ref[:, :3, :3]
    p_ref = q_ref[:, :3, 3]
    xi_ref = jnp.asarray(xi_ref).reshape(q_ref.shape[0], 6)
    Q = jnp.asarray(Q)
    P = jnp.asarray(P)
    alpha, alphaN = Q[0, 0], P[0, 0]
    Qp, Pp = Q[3:6, 3:6], P[3:6, 3:6]
    Qw, Pw = Q[6:, 6:], P[6:, 6:]
    Rw = jnp.asarray(R)

    from trajectory_optimization_matrix_lie_groups.ops import so3

    def f(x, u, i):
        Rm = x[:9].reshape(3, 3)
        p = x[9:12]
        xi = x[12:]
        w, v = xi[:3], xi[3:]
        E = so3.exp(w * dt)
        if variant in ("stabilized", "stabilized_logcost"):
            RtR = Rm.T @ Rm
            E = E + kappa / 2.0 * (jnp.linalg.inv(RtR) - jnp.eye(3))
        R_next = Rm @ E
        p_next = p + dt * (Rm @ v)
        wrench = se3.coad(xi) @ (J @ xi) + u
        xi_next = xi + dt * (Jinv @ wrench)
        return jnp.concatenate([R_next.reshape(9), p_next, xi_next])

    def _att_cost(Rm, i, a):
        if variant in ("logcost", "stabilized_logcost"):
            e = so3.log(Rm @ R_ref[i].T)
            return a * (e @ e)
        dR = Rm - R_ref[i]
        return a * jnp.sum(dR * dR)

    def _stage(x, i, a, Wp, Ww):
        Rm = x[:9].reshape(3, 3)
        dp = x[9:12] - p_ref[i]
        dxi = x[12:] - xi_ref[i]
        return _att_cost(Rm, i, a) + dp @ Wp @ dp + dxi @ Ww @ dxi

    def l(x, u, i):
        return _stage(x, i, alpha, Qp, Qw) + u @ Rw @ u

    def l_terminal(x, i):
        return _stage(x, i, alphaN, Pp, Pw)

    return autodiff_model(f, l, l_terminal, 18, nu)


def solve_se3_matrix(J, dt, q_ref, xi_ref, Q, R, P, x0, us_init,
                     variant="dynconstr", kappa=1.0, nu=6,
                     n_iterations=200, tol_grad_norm=1e-6):
    """Solve an embedded rotation-matrix baseline with Euclidean iLQR."""
    model = se3_matrix_model(J, dt, q_ref, xi_ref, Q, R, P, variant=variant,
                             kappa=kappa, nu=nu)
    N = jnp.asarray(us_init).shape[0]
    cfg = ILQRConfig(N=int(N), tol_grad_norm=tol_grad_norm,
                     max_iterations=n_iterations)
    solver = ILQR(model, cfg)
    q0, xi0 = x0
    q0 = jnp.asarray(q0)
    x0_vec = jnp.concatenate([q0[:3, :3].reshape(9), q0[:3, 3],
                              jnp.asarray(xi0).reshape(6)])
    return solver.fit(x0_vec, us_init, n_iterations=n_iterations)


# ---------------------------------------------------------------------------
# SO(3)-family baselines: SU(2)/R^7 and rotation-matrix/R^12 states
# (free attitude + 3-D pendulum; completes the reference's 4-mechanism x
#  4-system matrix — VERDICT round-2 item 5)
# ---------------------------------------------------------------------------

_DOWN3 = (0.0, 0.0, -1.0)


def _pend_torque(Rm, w, u, J, Jinv, m, length, g):
    """Pendulum torque on the EMBEDDED rotation (raw entries, exactly the
    baselines' form, traopt_baseline.py:2375-2390): cross(J w, w) +
    cross(m g rho, R^T down) + cross(m rho, R^T u)."""
    down = jnp.asarray(_DOWN3, dtype=w.dtype)
    rho = length / 2.0 * down
    g_term = jnp.cross(m * g * rho, Rm.T @ down)
    M = jnp.cross(m * rho, Rm.T @ u)
    return jnp.cross(J @ w, w) + g_term + M


def su2_so3_model(J, dt, R_ref, xi_ref, Q, R, P, pendulum=False,
                  m=1.0, length=1.0, g=9.8):
    """Embedded SU(2)/R^7 attitude baselines (`EmbeddedEuclideanSU2:15`,
    `_Pendulum3D:320`): state x = [quat(4), w(3)], quaternion kinematics
    q_next = q - dt/2 [0, w] (x) q (the reference's Omega-matrix left
    product, traopt_baseline.py:133-151,504) with NO manifold constraint,
    chordal cost alpha ||q - q_ref||^2.  The pendulum torque uses the
    NORMALIZED quaternion's rotation (spatial_casadi conversion at
    traopt_baseline.py:511) while the kinematics never renormalizes."""
    J = jnp.asarray(J)
    Jinv = jnp.linalg.inv(J)
    R_ref = jnp.asarray(R_ref)
    # quaternion reference via the SE(3) quat-pos converter (p = 0)
    T_ref = jnp.zeros(R_ref.shape[:-2] + (4, 4), R_ref.dtype)
    T_ref = T_ref.at[..., :3, :3].set(R_ref).at[..., 3, 3].set(1.0)
    quat_ref = se3.quatpos_from_matrix(T_ref)[..., :4]
    xi_ref = jnp.asarray(xi_ref).reshape(R_ref.shape[0], 3)
    Q = jnp.asarray(Q)
    P = jnp.asarray(P)
    alpha, alphaN = Q[0, 0], P[0, 0]
    Qw, Pw = Q[3:, 3:], P[3:, 3:]
    Rw = jnp.asarray(R)
    m = jnp.asarray(m)
    length = jnp.asarray(length)
    g = jnp.asarray(g)

    def _rot_of(q):
        qn = q / jnp.sqrt(q @ q)
        qw, qx, qy, qz = qn
        return jnp.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx * qx + qy * qy)],
        ])

    def f(x, u, i):
        q, w = x[:4], x[4:]
        # q - dt/2 Omega(w) q  ==  q - dt/2 [0, w] (x) q
        wq = jnp.concatenate([jnp.zeros(1, dtype=x.dtype), w])
        q_next = q - dt * 0.5 * _quat_mul(wq, q)
        if pendulum:
            torque = _pend_torque(_rot_of(q), w, u, J, Jinv, m, length, g)
        else:
            torque = jnp.cross(J @ w, w) + u
        w_next = w + dt * (Jinv @ torque)
        return jnp.concatenate([q_next, w_next])

    def _stage(x, i, a, Ww):
        dq = x[:4] - quat_ref[i]
        dw = x[4:] - xi_ref[i]
        return a * dq @ dq + dw @ Ww @ dw

    def l(x, u, i):
        return _stage(x, i, alpha, Qw) + u @ Rw @ u

    def l_terminal(x, i):
        return _stage(x, i, alphaN, Pw)

    return autodiff_model(f, l, l_terminal, 7, 3)


def so3_matrix_model(J, dt, R_ref, xi_ref, Q, R, P, variant="dynconstr",
                     kappa=1.0, pendulum=False, m=1.0, length=1.0, g=9.8):
    """Embedded rotation-matrix attitude baselines as R^12 iLQR models.

    State x = [vec(R) (9), w (3)].  The (propagation x cost) grid covers
    the reference's four SO(3)-attitude mechanism families:

      - 'dynconstr':           exp-map propagation, chordal ||R - Rbar||_F^2
        (`EmbeddedEuclideanSO3_DynamicsConstr:1955`, pendulum `:2210`)
      - 'logcost':             exp-map propagation, geodesic ||Log(R Rbar^T)||^2
        (`..._LogCost:1402`, pendulum `:1672`)
      - 'stabilized_logcost':  Baumgarte kappa-propagation
        R' = R(Exp(w dt) + kappa/2((R^T R)^-1 - I)), geodesic cost
        (`ConstraintStabilizationSO3:2487`, pendulum `:2754`)
      - 'stabilized':          kappa-propagation, chordal cost — the
        "MatrixNorm" family (`ConstraintStabilizationSO3_MatrixNorm:3023`,
        pendulum `:3276`; same propagation as :2487, traopt_baseline.py:
        3167-3170, but matrix-norm attitude cost)

    ``pendulum`` switches the velocity dynamics to the pivot-actuated
    pendulum torque (raw embedded R in the gravity/input moments,
    traopt_baseline.py:2375-2390).
    """
    J = jnp.asarray(J)
    Jinv = jnp.linalg.inv(J)
    R_ref = jnp.asarray(R_ref)
    xi_ref = jnp.asarray(xi_ref).reshape(R_ref.shape[0], 3)
    Q = jnp.asarray(Q)
    P = jnp.asarray(P)
    alpha, alphaN = Q[0, 0], P[0, 0]
    Qw, Pw = Q[3:, 3:], P[3:, 3:]
    Rw = jnp.asarray(R)
    m = jnp.asarray(m)
    length = jnp.asarray(length)
    g = jnp.asarray(g)

    from trajectory_optimization_matrix_lie_groups.ops import so3

    def f(x, u, i):
        Rm = x[:9].reshape(3, 3)
        w = x[9:]
        E = so3.exp(w * dt)
        if variant in ("stabilized", "stabilized_logcost"):
            RtR = Rm.T @ Rm
            E = E + kappa / 2.0 * (jnp.linalg.inv(RtR) - jnp.eye(3))
        R_next = Rm @ E
        if pendulum:
            torque = _pend_torque(Rm, w, u, J, Jinv, m, length, g)
        else:
            torque = jnp.cross(J @ w, w) + u
        w_next = w + dt * (Jinv @ torque)
        return jnp.concatenate([R_next.reshape(9), w_next])

    def _att_cost(Rm, i, a):
        if variant in ("logcost", "stabilized_logcost"):
            e = so3.log(Rm @ R_ref[i].T)
            return a * (e @ e)
        dR = Rm - R_ref[i]
        return a * jnp.sum(dR * dR)

    def _stage(x, i, a, Ww):
        Rm = x[:9].reshape(3, 3)
        dw = x[9:] - xi_ref[i]
        return _att_cost(Rm, i, a) + dw @ Ww @ dw

    def l(x, u, i):
        return _stage(x, i, alpha, Qw) + u @ Rw @ u

    def l_terminal(x, i):
        return _stage(x, i, alphaN, Pw)

    return autodiff_model(f, l, l_terminal, 12, 3)


def solve_so3_family(J, dt, R_ref, xi_ref, Q, R, P, x0, us_init,
                     formulation="dynconstr", kappa=1.0, pendulum=False,
                     m=1.0, length=1.0, g=9.8, n_iterations=200,
                     tol_grad_norm=1e-6):
    """Build and solve any SO(3)-attitude baseline.

    ``formulation``: 'su2' (R^7) or an `so3_matrix_model` variant
    ('dynconstr' | 'logcost' | 'stabilized' | 'stabilized_logcost').
    ``x0`` = (R0 (3,3), w0 (3,)).
    """
    if formulation == "su2":
        model = su2_so3_model(J, dt, R_ref, xi_ref, Q, R, P,
                              pendulum=pendulum, m=m, length=length, g=g)
        R0, w0 = x0
        T0 = jnp.zeros((4, 4), jnp.asarray(R0).dtype)
        T0 = T0.at[:3, :3].set(jnp.asarray(R0)).at[3, 3].set(1.0)
        x0_vec = jnp.concatenate([se3.quatpos_from_matrix(T0)[:4],
                                  jnp.asarray(w0).reshape(3)])
    else:
        model = so3_matrix_model(J, dt, R_ref, xi_ref, Q, R, P,
                                 variant=formulation, kappa=kappa,
                                 pendulum=pendulum, m=m, length=length, g=g)
        R0, w0 = x0
        x0_vec = jnp.concatenate([jnp.asarray(R0).reshape(9),
                                  jnp.asarray(w0).reshape(3)])
    N = jnp.asarray(us_init).shape[0]
    cfg = ILQRConfig(N=int(N), tol_grad_norm=tol_grad_norm,
                     max_iterations=n_iterations)
    solver = ILQR(model, cfg)
    return solver.fit(x0_vec, us_init, n_iterations=n_iterations)
