"""The reference's N=1400 AL-constrained SE(3) tracking problem.

Rebuilds `main_SE3ddp_tracking_exact_al_ms.py:49-160` exactly: a constant-
twist screw reference (w = (0,0,1), v = (2,0,0.2), dt = 0.01) over a 1400-
stage horizon, GN tracking cost with Q = diag(10,10,10,1,1,1, 1...1),
P = 10 Q, R = 0, input box u in [-10, 10]^6, initial state offset
p0 = (-1,-1,-0.2) with xi0 = (0,0,0.1, 2,0,0.2).

Used by scripts/gen_al1400_golden.py (f64 CPU golden).
"""

import numpy as np

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups.ops.group import SE3

__all__ = ["build_al1400", "build_al1400_np64"]


def build_al1400(dtype=jnp.float64, horizon=1400):
    """Returns (params {dyn, cost}, lb, ub, q0, xi0, q_ref, xi_ref)."""
    dt = 0.01
    m = 1.0
    Ib = np.diag([0.5, 0.7, 0.9])
    J = np.block([[Ib, np.zeros((3, 3))],
                  [np.zeros((3, 3)), m * np.eye(3)]])

    xi0_ref = np.concatenate([np.array([0.0, 0.0, 1.0]),
                              np.array([1.0, 0.0, 0.1]) * 2.0])
    # constant-twist screw reference: X_{k+1} = X_k expm(hat(xi) dt)
    step = np.asarray(SE3.exp(jnp.asarray(xi0_ref * dt, jnp.float64)),
                      np.float64)
    q_ref = np.zeros((horizon + 1, 4, 4))
    q_ref[0] = np.eye(4)
    for i in range(horizon):
        q_ref[i + 1] = q_ref[i] @ step
    xi_ref = np.broadcast_to(xi0_ref, (horizon + 1, 6)).copy()

    Q = np.diag([10.0, 10.0, 10.0, 1.0, 1.0, 1.0,
                 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    P = Q * 10.0
    R = np.zeros((6, 6))

    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(J, dtype), jnp.asarray(dt, dtype))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(
        SE3, jnp.asarray(Q, dtype), jnp.asarray(R, dtype),
        jnp.asarray(P, dtype), jnp.asarray(q_ref, dtype),
        jnp.asarray(xi_ref, dtype))

    q0 = np.eye(4)
    q0[:3, 3] = [-1.0, -1.0, -0.2]
    xi0 = np.array([0.0, 0.0, 0.1, 2.0, 0.0, 0.2])
    return ({"dyn": dp, "cost": cp}, -10.0, 10.0,
            jnp.asarray(q0, dtype), jnp.asarray(xi0, dtype),
            jnp.asarray(q_ref, dtype), jnp.asarray(xi_ref, dtype))


def build_al1400_np64(horizon=1400):
    """Pure-numpy float64 params for the same problem — the DF polish's
    split input (mirrors bench.build_problem_np64: full precision must
    survive in a process whose jax runs without x64, so no jnp on the
    construction path)."""
    from trajectory_optimization_matrix_lie_groups.baselines.numpy_serial import (
        _se3_exp,
    )
    from trajectory_optimization_matrix_lie_groups.models.costs import (
        TrackingCostParams,
    )
    from trajectory_optimization_matrix_lie_groups.models.dynamics import (
        SE3Params,
    )

    dt = 0.01
    m = 1.0
    Ib = np.diag([0.5, 0.7, 0.9])
    J = np.block([[Ib, np.zeros((3, 3))],
                  [np.zeros((3, 3)), m * np.eye(3)]])
    xi0_ref = np.concatenate([np.array([0.0, 0.0, 1.0]),
                              np.array([1.0, 0.0, 0.1]) * 2.0])
    step = _se3_exp(xi0_ref * dt)
    q_ref = np.zeros((horizon + 1, 4, 4))
    q_ref[0] = np.eye(4)
    for i in range(horizon):
        q_ref[i + 1] = q_ref[i] @ step
    xi_ref = np.broadcast_to(xi0_ref, (horizon + 1, 6)).copy()
    Q = np.diag([10.0, 10.0, 10.0, 1.0, 1.0, 1.0,
                 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    P = Q * 10.0
    R = np.zeros((6, 6))

    q_ref_inv = np.swapaxes(q_ref, -1, -2).copy()
    q_ref_inv[..., :3, 3] = -np.einsum(
        "nji,nj->ni", q_ref[..., :3, :3], q_ref[..., :3, 3])
    q_ref_inv[..., 3, :3] = 0.0
    Rr, pr = q_ref[..., :3, :3], q_ref[..., :3, 3]
    hat = np.zeros(pr.shape[:-1] + (3, 3))
    hat[..., 0, 1], hat[..., 0, 2] = -pr[..., 2], pr[..., 1]
    hat[..., 1, 0], hat[..., 1, 2] = pr[..., 2], -pr[..., 0]
    hat[..., 2, 0], hat[..., 2, 1] = -pr[..., 1], pr[..., 0]
    Ad = np.zeros((horizon + 1, 6, 6))
    Ad[..., :3, :3] = Rr
    Ad[..., 3:, 3:] = Rr
    Ad[..., 3:, :3] = hat @ Rr
    dp64 = SE3Params(J=J, Jinv=np.linalg.inv(J), Ib=Ib,
                     m=np.float64(m), dt=np.float64(dt),
                     ref_coad_swap=np.asarray(True))
    cp64 = TrackingCostParams(
        Q1=Q[:6, :6], Q2=Q[6:, 6:], R=R, P1=P[:6, :6], P2=P[6:, 6:],
        q_ref=q_ref, q_ref_inv=q_ref_inv, Ad_ref=Ad, xi_ref=xi_ref)
    return {"dyn": dp64, "cost": cp64}
