"""Batched closed-form SO(3) kernels.

First-party replacement for the `manifpy.SO3` binding used throughout the
reference (`traoptlibrary/traopt_dynamics.py:11`, `traopt_cost.py:11`):
exp/log, left/right Jacobians and their inverses, all as pure jnp functions
that broadcast over arbitrary leading batch dimensions and run under
jit/vmap/pjit on any backend.

Numerical policy: every trigonometric coefficient has a Taylor-guarded
small-angle branch (the `V_so3` pattern of the reference's
`baseline_SE3_nlpsol_embedded.py:56-96`, done with `jnp.where` on a safe
argument so both branches are finite under autodiff).  `log` goes through a
branchless Shepperd quaternion extraction so it is stable for rotations
arbitrarily close to pi, where the naive `(R - R^T)` formula loses all
precision.
"""

import jax.numpy as jnp

# Small-angle switch point: below this squared angle the Taylor expansions are
# more accurate than the closed forms in either f32 or f64.
_EPS = 1e-8


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix.  Ref: traopt_utilis.py:13."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(w0)
    return jnp.stack(
        [
            jnp.stack([z, -w2, w1], axis=-1),
            jnp.stack([w2, z, -w0], axis=-1),
            jnp.stack([-w1, w0, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W):
    """(..., 3, 3) -> (..., 3).  Ref: traopt_utilis.py:26."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _theta_sq(w):
    return jnp.sum(w * w, axis=-1)


def _sinc_coeffs(th_sq):
    """Return (sin(t)/t, (1-cos t)/t^2, (t-sin t)/t^3) with Taylor guards."""
    small = th_sq < _EPS
    th_sq_safe = jnp.where(small, 1.0, th_sq)
    th = jnp.sqrt(th_sq_safe)
    a = jnp.where(small, 1.0 - th_sq / 6.0, jnp.sin(th) / th)
    b = jnp.where(small, 0.5 - th_sq / 24.0, (1.0 - jnp.cos(th)) / th_sq_safe)
    c = jnp.where(small, 1.0 / 6.0 - th_sq / 120.0, (th - jnp.sin(th)) / (th_sq_safe * th))
    return a, b, c


def exp(w):
    """Exponential map (..., 3) -> (..., 3, 3) (Rodrigues)."""
    th_sq = _theta_sq(w)
    a, b, _ = _sinc_coeffs(th_sq)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def quat_from_matrix(R):
    """(..., 3, 3) -> (..., 4) unit quaternion [qw, qx, qy, qz], branchless Shepperd.

    Computes all four candidate extractions and selects the best-conditioned
    one with `where`, so it vectorizes and is accurate for any angle.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate 4*q_i vectors, each scaled by its own sqrt argument.
    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-30))

    s_w = safe_sqrt(1.0 + tr)  # = 2*qw
    q_w = jnp.stack([s_w * s_w, m21 - m12, m02 - m20, m10 - m01], axis=-1)

    s_x = safe_sqrt(1.0 + m00 - m11 - m22)  # = 2*qx
    q_x = jnp.stack([m21 - m12, s_x * s_x, m01 + m10, m02 + m20], axis=-1)

    s_y = safe_sqrt(1.0 - m00 + m11 - m22)
    q_y = jnp.stack([m02 - m20, m01 + m10, s_y * s_y, m12 + m21], axis=-1)

    s_z = safe_sqrt(1.0 - m00 - m11 + m22)
    q_z = jnp.stack([m10 - m01, m02 + m20, m12 + m21, s_z * s_z], axis=-1)

    # Pick the candidate with the largest pivot (best conditioned).
    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    idx = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([q_w, q_x, q_y, q_z], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(cands, idx[..., None, None].astype(jnp.int32), axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonical sign: qw >= 0 keeps log in (-pi, pi].
    return q * jnp.where(q[..., :1] < 0.0, -1.0, 1.0)


def log(R):
    """Logarithm map (..., 3, 3) -> (..., 3), robust near 0 and pi.

    Differentiable at the identity: the vector-norm is computed through a
    guarded sqrt so forward/reverse-mode tangents stay finite (the naive
    ``norm(qv)`` has a NaN gradient at qv = 0).
    """
    q = quat_from_matrix(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    nv_sq = jnp.sum(qv * qv, axis=-1)
    small = nv_sq < 1e-14
    nv = jnp.sqrt(jnp.where(small, 1.0, nv_sq))
    # angle = 2*atan2(|qv|, qw); w = angle * qv/|qv|.  Near the identity use
    # the series of 2*atan2(nv, qw)/nv in nv^2 (smooth in qv).
    big = 2.0 * jnp.arctan2(nv, qw) / nv
    taylor = 2.0 / qw - 2.0 * nv_sq / (3.0 * qw**3)
    scale = jnp.where(small, taylor, big)
    return scale[..., None] * qv


def left_jacobian(w):
    """SO(3) left Jacobian Jl(w): (..., 3) -> (..., 3, 3)."""
    th_sq = _theta_sq(w)
    _, b, c = _sinc_coeffs(th_sq)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def right_jacobian(w):
    """SO(3) right Jacobian Jr(w) = Jl(-w)."""
    return left_jacobian(-w)


def left_jacobian_inv(w):
    """Inverse SO(3) left Jacobian."""
    th_sq = _theta_sq(w)
    small = th_sq < _EPS
    th_sq_safe = jnp.where(small, 1.0, th_sq)
    th = jnp.sqrt(th_sq_safe)
    half = th / 2.0
    # k = 1/th^2 - cos(th/2)/(2*th*sin(th/2)) ;  Taylor: 1/12 + th^2/720
    k = jnp.where(
        small,
        1.0 / 12.0 + th_sq / 720.0,
        1.0 / th_sq_safe - jnp.cos(half) / (2.0 * th * jnp.sin(half)),
    )
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + k[..., None, None] * W2


def right_jacobian_inv(w):
    """Inverse SO(3) right Jacobian Jr^-1(w) = Jl^-1(-w)."""
    return left_jacobian_inv(-w)


# ---------------------------------------------------------------------------
# Group operations (SO(3) elements are (..., 3, 3) rotation matrices).
# ---------------------------------------------------------------------------

def inverse(R):
    return jnp.swapaxes(R, -1, -2)


def compose(R1, R2):
    return R1 @ R2


def Ad(R):
    """Adjoint of SO(3) is the rotation itself."""
    return R


def ad(w):
    """Small adjoint of so(3): ad(w) = hat(w).  manif `smallAdj` equivalent."""
    return hat(w)


def rplus(R, w):
    """R o Exp(w) (manif `rplus`, ref traopt_dynamics.py:375)."""
    return R @ exp(w)


def rminus(X, Y):
    """Log(Y^-1 X): tangent of X seen from Y (manif `-` operator)."""
    return log(inverse(Y) @ X)


def lminus(X, Y):
    """Log(X Y^-1): left (global-frame) difference (ref traopt_cost.py:400)."""
    return log(X @ inverse(Y))


def matrix_from_quat(q):
    """(..., 4) unit quaternion [qw, qx, qy, qz] -> (..., 3, 3) rotation."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (qy * qy + qz * qz)
    r01 = 2.0 * (qx * qy - qw * qz)
    r02 = 2.0 * (qx * qz + qw * qy)
    r10 = 2.0 * (qx * qy + qw * qz)
    r11 = 1.0 - 2.0 * (qx * qx + qz * qz)
    r12 = 2.0 * (qy * qz - qw * qx)
    r20 = 2.0 * (qx * qz - qw * qy)
    r21 = 2.0 * (qy * qz + qw * qx)
    r22 = 1.0 - 2.0 * (qx * qx + qy * qy)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def normalize(R):
    """Project a near-rotation matrix back onto SO(3) via quaternion round-trip."""
    return matrix_from_quat(quat_from_matrix(R))
