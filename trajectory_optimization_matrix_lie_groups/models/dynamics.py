"""Rigid-body dynamics families on SO(3)/SE(3) with analytic Jacobians.

JAX re-implementations of the reference models
(`traoptlibrary/traopt_dynamics.py`):

  - SO(3) rigid body            (ref `SO3Dynamics:275`)
  - 3-D pendulum on SO(3)       (ref `Pendulum3dDyanmics:421`)
  - SE(3) rigid body            (ref `SE3Dynamics:629`)
  - SE(3) rigid body + gravity  (ref `RigidBodyDynamics:901`)
  - drone (4-input projection)  (ref `DroneDynamics:1209`)

All models share the semi-implicit Euler discretization of the reference
(`fd_euler`): pose integrates by the exponential map of the *current* twist,
the twist by the Euler-Poincare equation.  Jacobians are closed-form on the
tangent space (no autodiff at solve time) and broadcast over leading batch
dims, so one `vmap` covers the whole horizon in a single fused XLA call
instead of the reference's N-per-iteration manif round-trips.

Parity notes (reference quirks faithfully replicated, each behind a flag,
because matching the reference's converged controls requires matching the
fixed point of *its* iteration):

1. `ref_coad_swap` (default True): the reference's SE(3)-family `f_x`
   converts the twist to a manif tangent (`se32manifse3`, coeffs ordered
   ``[v, omega]``) and then feeds ``xi.coeffs()`` into its own
   ``coadjoint`` helper which expects ``[omega, v]``
   (`traopt_dynamics.py:819,832` — likewise `:1111,1140` and `:1435,1464`).
   The velocity-coupling block H is therefore built from the coadjoint of
   the *swapped* twist.  The dynamics step itself is unaffected (it uses the
   raw ``[omega, v]`` vector, `:785`).  Verified: with the swap, our
   initial-trajectory gradient matches the reference's stored
   `grad_hist[0]` to 13 significant digits; without it, to only 3.
   Set False for the mathematically exact Jacobian.

2. `exact_gravity_jacobian` (default False = reference-compatible): the
   reference's gravity Jacobian block omits the `m*g` scale factor
   (`traopt_dynamics.py:1121-1134` builds `J_v_R` from the unit down-vector
   action only).  True gives the exact block.
"""

from typing import NamedTuple

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models.base import DynamicsDef
from trajectory_optimization_matrix_lie_groups.utils.linalg import setup_inv
from trajectory_optimization_matrix_lie_groups.ops import se3, so3
from trajectory_optimization_matrix_lie_groups.ops.group import SE3, SO3

_DOWN = (0.0, 0.0, -1.0)


def _bmv(M, v):
    """Batched matrix @ vector over leading dims."""
    return jnp.einsum("...ij,...j->...i", M, v)


def _blk2(A, B, C, D):
    """Assemble [[A, B], [C, D]] over leading batch dims."""
    top = jnp.concatenate([A, B], axis=-1)
    bot = jnp.concatenate([C, D], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


# ---------------------------------------------------------------------------
# SO(3) rigid body  (ref SO3Dynamics, traopt_dynamics.py:275-419)
# ---------------------------------------------------------------------------

class SO3Params(NamedTuple):
    J: jnp.ndarray     # (3, 3) inertia
    Jinv: jnp.ndarray  # (3, 3)
    dt: jnp.ndarray    # scalar


def so3_params(J, dt):
    J = jnp.asarray(J)
    return SO3Params(J=J, Jinv=setup_inv(J), dt=jnp.asarray(dt))


def _so3_step(p: SO3Params, q, xi, u, i):
    # q_next = q . Exp(xi dt);  xi_next = xi + Jinv(ad(xi)^T J xi + u) dt
    # ref traopt_dynamics.py:369-380
    del i
    q_next = so3.normalize(q @ so3.exp(xi * p.dt))
    torque = _bmv(jnp.swapaxes(so3.hat(xi), -1, -2), _bmv(p.J, xi)) + u
    xi_next = xi + _bmv(p.Jinv, torque) * p.dt
    return q_next, xi_next


def _so3_jac(p: SO3Params, q, xi, u, i):
    # ref traopt_dynamics.py:385-403: manif rplus Jacobians + H block
    del q, u, i
    tau = xi * p.dt
    J_q_q = so3.exp(-tau)               # Ad(Exp(tau))^-1 for SO(3)
    J_q_xi = so3.right_jacobian(tau) * p.dt
    G = so3.hat(_bmv(p.J, xi))
    H = p.Jinv @ (jnp.swapaxes(so3.hat(xi), -1, -2) @ p.J + G)
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), H.shape)
    Z = jnp.zeros_like(H)
    Fx = _blk2(J_q_q, J_q_xi, Z, eye3 + H * p.dt)
    Fu = jnp.concatenate([jnp.zeros_like(p.Jinv), p.Jinv], axis=-2) * p.dt
    Fu = jnp.broadcast_to(Fu, (*H.shape[:-2], 6, 3))
    return Fx, Fu


def so3_dynamics():
    return DynamicsDef(group=SO3, nx=6, nu=3, step=_so3_step, jac=_so3_jac)


# ---------------------------------------------------------------------------
# 3-D pendulum actuated at the pivot  (ref Pendulum3dDyanmics:421-627)
# ---------------------------------------------------------------------------

class Pendulum3dParams(NamedTuple):
    J: jnp.ndarray
    Jinv: jnp.ndarray
    m: jnp.ndarray
    l: jnp.ndarray
    g: jnp.ndarray
    dt: jnp.ndarray


def pendulum3d_params(J, m, length, dt, g=9.8):
    J = jnp.asarray(J)
    return Pendulum3dParams(
        J=J, Jinv=setup_inv(J), m=jnp.asarray(m), l=jnp.asarray(length),
        g=jnp.asarray(g), dt=jnp.asarray(dt),
    )


def _pend_rho(p):
    down = jnp.asarray(_DOWN, dtype=p.J.dtype)
    return p.l / 2.0 * down, down


def _pendulum3d_step(p: Pendulum3dParams, q, xi, u, i):
    # ref traopt_dynamics.py:531-554
    del i
    rho, down = _pend_rho(p)
    Rt = jnp.swapaxes(q, -1, -2)
    g_term = _bmv(so3.hat(p.m * p.g * rho), _bmv(Rt, down))
    M = _bmv(so3.hat(p.m * rho), _bmv(Rt, u))
    torque = _bmv(jnp.swapaxes(so3.hat(xi), -1, -2), _bmv(p.J, xi)) + g_term + M
    q_next = so3.normalize(q @ so3.exp(xi * p.dt))
    xi_next = xi + _bmv(p.Jinv, torque) * p.dt
    return q_next, xi_next


def _pendulum3d_jac(p: Pendulum3dParams, q, xi, u, i):
    # ref traopt_dynamics.py:559-611.  L1/L2 come from the manif chain
    # (q^-1).act(vec): J_act_Xinv = -R^T hat(vec), J_inv_X = -Ad(q) = -R,
    # so L = hat(m*g*rho) R^T hat(down) R + hat(m*rho) R^T hat(u) R.
    del i
    rho, down = _pend_rho(p)
    tau = xi * p.dt
    J_q_q = so3.exp(-tau)
    J_q_xi = so3.right_jacobian(tau) * p.dt
    G = so3.hat(_bmv(p.J, xi))
    H = p.Jinv @ (jnp.swapaxes(so3.hat(xi), -1, -2) @ p.J + G)
    Rt = jnp.swapaxes(q, -1, -2)
    L1 = so3.hat(p.m * p.g * rho) @ Rt @ so3.hat(down) @ q
    L2 = so3.hat(p.m * rho) @ Rt @ so3.hat(u) @ q
    L = p.Jinv @ (L1 + L2)
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), H.shape)
    Fx = _blk2(J_q_q, J_q_xi, L * p.dt, eye3 + H * p.dt)
    # f_u: bt = Jinv hat(m rho) R^T  (ref :592-611)
    bt = p.Jinv @ so3.hat(p.m * rho) @ Rt
    Fu = jnp.concatenate([jnp.zeros_like(bt), bt], axis=-2) * p.dt
    return Fx, Fu


def pendulum3d_dynamics():
    return DynamicsDef(group=SO3, nx=6, nu=3, step=_pendulum3d_step, jac=_pendulum3d_jac)


# ---------------------------------------------------------------------------
# SE(3) rigid body  (ref SE3Dynamics:629-899)
# ---------------------------------------------------------------------------

class SE3Params(NamedTuple):
    J: jnp.ndarray     # (6, 6) generalized inertia diag(Ib, m I)
    Jinv: jnp.ndarray
    Ib: jnp.ndarray    # (3, 3)
    m: jnp.ndarray     # scalar mass
    dt: jnp.ndarray
    ref_coad_swap: jnp.ndarray  # bool: replicate the reference f_x quirk (#1)


def se3_params(J, dt, ref_coad_swap=True):
    J = jnp.asarray(J)
    return SE3Params(
        J=J, Jinv=setup_inv(J), Ib=J[:3, :3], m=J[4, 4], dt=jnp.asarray(dt),
        ref_coad_swap=jnp.asarray(ref_coad_swap),
    )


def _se3_wrench_free(p, xi, u):
    return _bmv(se3.coad(xi), _bmv(p.J, xi)) + u


def _se3_step(p: SE3Params, q, xi, u, i):
    # ref traopt_dynamics.py:763-787.  The reference routes the pose through
    # manif (quaternion) objects, which renormalizes the rotation at every
    # step; `se3.normalize` mirrors that (without it, orthogonality drift
    # accumulates over solver iterations and destabilizes the MS defect
    # feedback).
    del i
    q_next = se3.normalize(q @ se3.exp(xi * p.dt))
    xi_next = xi + _bmv(p.Jinv, _se3_wrench_free(p, xi, u)) * p.dt
    return q_next, xi_next


def _coad_for_jac(p, xi):
    """coad(xi) for the H block, with the reference's omega/v swap quirk."""
    xi_sw = jnp.concatenate([xi[..., 3:], xi[..., :3]], axis=-1)
    return jnp.where(p.ref_coad_swap, se3.coad(xi_sw), se3.coad(xi))


def _se3_G(p, xi):
    # G = [[hat(Ib w), m hat(v)], [m hat(v), 0]]  (ref :828-831)
    w = xi[..., :3]
    v = xi[..., 3:]
    Gw = so3.hat(_bmv(p.Ib, w))
    Gv = p.m * so3.hat(v)
    return _blk2(Gw, Gv, Gv, jnp.zeros_like(Gw))


def _se3_pose_blocks(p, xi):
    tau = xi * p.dt
    J_q_q = se3.Ad(se3.exp(-tau))       # Ad(Exp(tau))^-1
    J_q_xi = se3.right_jacobian(tau) * p.dt
    return J_q_q, J_q_xi


def _se3_jac(p: SE3Params, q, xi, u, i):
    # ref traopt_dynamics.py:802-850
    del q, u, i
    J_q_q, J_q_xi = _se3_pose_blocks(p, xi)
    H = p.Jinv @ (_coad_for_jac(p, xi) @ p.J + _se3_G(p, xi))
    eye6 = jnp.broadcast_to(jnp.eye(6, dtype=xi.dtype), H.shape)
    Z = jnp.zeros_like(H)
    Fx = _blk2(J_q_q, J_q_xi, Z, eye6 + H * p.dt)
    Fu = jnp.concatenate([jnp.zeros_like(p.Jinv), p.Jinv], axis=-2) * p.dt
    Fu = jnp.broadcast_to(Fu, (*H.shape[:-2], 12, 6))
    return Fx, Fu


def se3_dynamics():
    return DynamicsDef(group=SE3, nx=12, nu=6, step=_se3_step, jac=_se3_jac)


# ---------------------------------------------------------------------------
# SE(3) rigid body with gravity  (ref RigidBodyDynamics:901-1207)
# ---------------------------------------------------------------------------

class RigidBodyParams(NamedTuple):
    J: jnp.ndarray
    Jinv: jnp.ndarray
    Ib: jnp.ndarray
    m: jnp.ndarray
    g: jnp.ndarray
    dt: jnp.ndarray
    Pu: jnp.ndarray            # (6, nu) input projection (identity for 6-input)
    exact_gravity_jacobian: jnp.ndarray  # bool scalar
    ref_coad_swap: jnp.ndarray           # bool: replicate the reference f_x quirk (#1)


def rigid_body_params(J, dt, g=9.8, Pu=None, exact_gravity_jacobian=False,
                      ref_coad_swap=True):
    J = jnp.asarray(J)
    if Pu is None:
        Pu = jnp.eye(6, dtype=J.dtype)
    return RigidBodyParams(
        J=J, Jinv=setup_inv(J), Ib=J[:3, :3], m=J[4, 4], g=jnp.asarray(g),
        dt=jnp.asarray(dt), Pu=jnp.asarray(Pu),
        exact_gravity_jacobian=jnp.asarray(exact_gravity_jacobian),
        ref_coad_swap=jnp.asarray(ref_coad_swap),
    )


def _gravity_wrench(p, q):
    down = jnp.asarray(_DOWN, dtype=q.dtype)
    Rt = jnp.swapaxes(q[..., :3, :3], -1, -2)
    g_lin = p.m * p.g * _bmv(Rt, down)
    return jnp.concatenate([jnp.zeros_like(g_lin), g_lin], axis=-1)


def _rigid_body_step(p: RigidBodyParams, q, xi, u, i):
    # ref traopt_dynamics.py:1049-1077 (and DroneDynamics :1373 via Pu)
    del i
    wrench = _bmv(se3.coad(xi), _bmv(p.J, xi)) + _gravity_wrench(p, q) + _bmv(p.Pu, u)
    q_next = se3.normalize(q @ se3.exp(xi * p.dt))
    xi_next = xi + _bmv(p.Jinv, wrench) * p.dt
    return q_next, xi_next


def _rigid_body_jac(p: RigidBodyParams, q, xi, u, i):
    # ref traopt_dynamics.py:1092-1158.  J_v_R = R^T hat(down) R = hat(R^T down);
    # the reference omits the m*g factor (see module docstring) — replicated
    # unless exact_gravity_jacobian.
    del u, i
    J_q_q, J_q_xi = _se3_pose_blocks(p, xi)
    H = p.Jinv @ (_coad_for_jac(p, xi) @ p.J + _se3_G(p, xi))
    down = jnp.asarray(_DOWN, dtype=q.dtype)
    R = q[..., :3, :3]
    J_v_R = so3.hat(_bmv(jnp.swapaxes(R, -1, -2), down))
    J_v_R = jnp.where(p.exact_gravity_jacobian, p.m * p.g * J_v_R, J_v_R)
    Z3 = jnp.zeros_like(J_v_R)
    J_xi_q = p.Jinv @ _blk2(Z3, Z3, J_v_R, Z3) * p.dt
    eye6 = jnp.broadcast_to(jnp.eye(6, dtype=xi.dtype), H.shape)
    Fx = _blk2(J_q_q, J_q_xi, J_xi_q, eye6 + H * p.dt)
    bt = p.Jinv @ p.Pu
    Fu = jnp.concatenate([jnp.zeros_like(bt), bt], axis=-2) * p.dt
    Fu = jnp.broadcast_to(Fu, (*H.shape[:-2], 12, p.Pu.shape[-1]))
    return Fx, Fu


def rigid_body_dynamics():
    return DynamicsDef(group=SE3, nx=12, nu=6, step=_rigid_body_step, jac=_rigid_body_jac)


def drone_params(J, dt, g=9.8, exact_gravity_jacobian=False, ref_coad_swap=True):
    """Drone = rigid body + 6x4 projection (3 torques + z-thrust).

    ref DroneDynamics.__init__ (traopt_dynamics.py:1250-1258).
    """
    J = jnp.asarray(J)
    Pu = jnp.zeros((6, 4), dtype=J.dtype)
    Pu = Pu.at[0, 0].set(1.0).at[1, 1].set(1.0).at[2, 2].set(1.0).at[5, 3].set(1.0)
    return rigid_body_params(J, dt, g=g, Pu=Pu,
                             exact_gravity_jacobian=exact_gravity_jacobian,
                             ref_coad_swap=ref_coad_swap)


def drone_dynamics():
    return DynamicsDef(group=SE3, nx=12, nu=4, step=_rigid_body_step, jac=_rigid_body_jac)
