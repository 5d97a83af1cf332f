"""Batched closed-form SE(3) kernels, twist order ``[omega, v]``.

First-party replacement for `manifpy.SE3` (reference import sites:
`traoptlibrary/traopt_dynamics.py:11`, `traopt_cost.py:11`,
`traopt_controller.py:7-8`).  The reference stores twists in ``[omega, v]``
order and papers over manif's ``[v, omega]`` order with `Jmnf2J` /
`se32manifse3` shims (`traopt_utilis.py:356-399`); here ``[omega, v]`` is the
one and only convention, so no reorder shims exist anywhere.

Group elements are (..., 4, 4) homogeneous matrices.  All functions broadcast
over leading batch dims and are jit/vmap/pjit-safe with Taylor-guarded
small-angle branches (no `scipy.linalg.expm/logm` anywhere — the closed forms
are what make this accelerator-friendly).
"""

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops import so3

_EPS = 1e-8


def hat(xi):
    """(..., 6) [w, v] -> (..., 4, 4) se(3) matrix.  Ref: traopt_utilis.py:43."""
    w = xi[..., :3]
    v = xi[..., 3:]
    W = so3.hat(w)
    top = jnp.concatenate([W, v[..., :, None]], axis=-1)
    bot = jnp.zeros_like(top[..., :1, :])
    return jnp.concatenate([top, bot], axis=-2)


def vee(M):
    """(..., 4, 4) -> (..., 6) [w, v].  Ref: traopt_utilis.py:57."""
    return jnp.concatenate([so3.vee(M[..., :3, :3]), M[..., :3, 3]], axis=-1)


def ad(xi):
    """Small adjoint [[W, 0], [V, W]] in [w, v] order.  Ref: traopt_utilis.py:75."""
    W = so3.hat(xi[..., :3])
    V = so3.hat(xi[..., 3:])
    Z = jnp.zeros_like(W)
    top = jnp.concatenate([W, Z], axis=-1)
    bot = jnp.concatenate([V, W], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def coad(xi):
    """Coadjoint ad(xi)^T.  Ref: traopt_utilis.py:90."""
    return jnp.swapaxes(ad(xi), -1, -2)


def exp(xi):
    """Exponential map (..., 6) -> (..., 4, 4).

    Translation column uses V(w) = Jl_so3(w) (the closed form the reference's
    baselines hand-roll at `baseline_SE3_nlpsol_embedded.py:56-80`).
    """
    w = xi[..., :3]
    v = xi[..., 3:]
    R = so3.exp(w)
    p = (so3.left_jacobian(w) @ v[..., :, None])[..., 0]
    return from_rotation_translation(R, p)


def log(T):
    """Logarithm map (..., 4, 4) -> (..., 6), robust near 0 and pi rotations.

    Replaces the reference's `scipy.linalg.logm` calls
    (`traopt_controller.py:4606`, `traopt_cost.py:1634`) with a closed form.
    """
    R = T[..., :3, :3]
    p = T[..., :3, 3]
    w = so3.log(R)
    v = (so3.left_jacobian_inv(w) @ p[..., :, None])[..., 0]
    return jnp.concatenate([w, v], axis=-1)


def from_rotation_translation(R, p):
    top = jnp.concatenate([R, p[..., :, None]], axis=-1)
    bot_row = jnp.concatenate(
        [jnp.zeros_like(p), jnp.ones_like(p[..., :1])], axis=-1
    )
    return jnp.concatenate([top, bot_row[..., None, :]], axis=-2)


def rotation(T):
    return T[..., :3, :3]


def translation(T):
    return T[..., :3, 3]


def inverse(T):
    """Fast SE(3) inverse [[R^T, -R^T p], [0, 1]]."""
    R = rotation(T)
    p = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return from_rotation_translation(Rt, -(Rt @ p[..., :, None])[..., 0])


def compose(T1, T2):
    return T1 @ T2


def Ad(T):
    """Group adjoint in [w, v] order: [[R, 0], [hat(p) R, R]]."""
    R = rotation(T)
    P = so3.hat(translation(T))
    Z = jnp.zeros_like(R)
    top = jnp.concatenate([R, Z], axis=-1)
    bot = jnp.concatenate([P @ R, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _Q_matrix(w, v):
    """Barfoot's Q(w, v) block of the SE(3) left Jacobian (Taylor-guarded)."""
    th_sq = jnp.sum(w * w, axis=-1)
    small = th_sq < _EPS
    th_sq_safe = jnp.where(small, 1.0, th_sq)
    th = jnp.sqrt(th_sq_safe)
    sin_t = jnp.sin(th)
    cos_t = jnp.cos(th)

    # Barfoot, "State Estimation for Robotics", eq. (7.86):
    # c1 = (th - sin)/th^3                 -> 1/6   - th^2/120
    # c2 = (th^2 + 2 cos - 2)/(2 th^4)     -> 1/24  - th^2/720
    # c3 = (2 th - 3 sin + th cos)/(2 th^5)-> 1/120 - th^2/2520
    c1 = jnp.where(small, 1.0 / 6.0 - th_sq / 120.0, (th - sin_t) / (th_sq_safe * th))
    c2 = jnp.where(
        small,
        1.0 / 24.0 - th_sq / 720.0,
        (th_sq_safe + 2.0 * cos_t - 2.0) / (2.0 * th_sq_safe * th_sq_safe),
    )
    c3 = jnp.where(
        small,
        1.0 / 120.0 - th_sq / 2520.0,
        (2.0 * th - 3.0 * sin_t + th * cos_t)
        / (2.0 * th_sq_safe * th_sq_safe * th),
    )

    W = so3.hat(w)
    V = so3.hat(v)
    WV = W @ V
    VW = V @ W
    WVW = WV @ W
    c1e = c1[..., None, None]
    c2e = c2[..., None, None]
    c3e = c3[..., None, None]
    Q = (
        0.5 * V
        + c1e * (WV + VW + WVW)
        + c2e * (W @ WV + VW @ W - 3.0 * WVW)
        + c3e * (WVW @ W + W @ WVW)
    )
    return Q


def left_jacobian(xi):
    """SE(3) left Jacobian in [w, v] order: [[Jl, 0], [Q, Jl]]."""
    w = xi[..., :3]
    v = xi[..., 3:]
    Jw = so3.left_jacobian(w)
    Q = _Q_matrix(w, v)
    Z = jnp.zeros_like(Jw)
    top = jnp.concatenate([Jw, Z], axis=-1)
    bot = jnp.concatenate([Q, Jw], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def right_jacobian(xi):
    """SE(3) right Jacobian Jr(xi) = Jl(-xi)."""
    return left_jacobian(-xi)


def left_jacobian_inv(xi):
    """Inverse SE(3) left Jacobian [[Jl^-1, 0], [-Jl^-1 Q Jl^-1, Jl^-1]]."""
    w = xi[..., :3]
    v = xi[..., 3:]
    Jw_inv = so3.left_jacobian_inv(w)
    Q = _Q_matrix(w, v)
    JQJ = -(Jw_inv @ Q @ Jw_inv)
    Z = jnp.zeros_like(Jw_inv)
    top = jnp.concatenate([Jw_inv, Z], axis=-1)
    bot = jnp.concatenate([JQJ, Jw_inv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def right_jacobian_inv(xi):
    """Inverse SE(3) right Jacobian Jr^-1(xi) = Jl^-1(-xi)."""
    return left_jacobian_inv(-xi)


def rplus(T, xi):
    """T o Exp(xi) (manif `rplus`; ref traopt_dynamics.py:783)."""
    return T @ exp(xi)


def rminus(X, Y):
    """Log(Y^-1 X): manif `-` operator (defects, ref traopt_controller.py:2683)."""
    return log(inverse(Y) @ X)


def lminus(X, Y):
    """Log(X Y^-1): left difference used by the GN costs (traopt_cost.py:695)."""
    return log(X @ inverse(Y))


def quatpos_from_matrix(T):
    """(..., 4, 4) -> (..., 7) [qw, qx, qy, qz, px, py, pz].

    Matches the reference's `SE32quatpos` artifact format (traopt_utilis.py:299).
    """
    return jnp.concatenate([so3.quat_from_matrix(rotation(T)), translation(T)], axis=-1)


def matrix_from_quatpos(x7):
    """(..., 7) [qw, qx, qy, qz, p] -> (..., 4, 4).  Ref: traopt_utilis.py:252."""
    return from_rotation_translation(so3.matrix_from_quat(x7[..., :4]), x7[..., 4:])


def normalize(T):
    """Re-orthonormalize the rotation block (quaternion round-trip)."""
    return from_rotation_translation(so3.normalize(rotation(T)), translation(T))
