"""Lane-layout SO(3)/SE(3) primitives for the pipeline's stage math.

A batch of B problems rides the trailing (lane) axis: a rotation is a
(3, 3, B) array whose entries are (B,)-lane vectors, a translation is
(3, B), a twist (6, B).  Every function here is built only from
elementwise ops, broadcasts, slices, concatenations and selects — no
gathers, scatters, or linalg calls — so the generated stage kernels
(`ops/lanewise.py`) can compile it entry by entry.

These mirror `ops/so3.py` / `ops/se3.py` exactly (same Taylor guards, same
branchless Shepperd quaternion extraction, realized with nested `where`
instead of argmax/take) so lane-layout numerics match the generic ops at
f32.

Every function is additionally polymorphic over `ops/dfx.DF` operands (the
double-f32 compensated representation): arithmetic dispatches through DF's
operator overloads, structural ops through the `dfx.*` mirrors, and the
trig-based rotation-angle coefficients switch to dfx's exact-rational
Taylor series (branchless, no cancellation — the f32 guard pattern's
`(1-cos th)/th^2`-style expressions are exactly where double-f32 would lose
its extra bits).  The f32 path is bit-identical to before: the dispatchers
reduce to the same jnp calls in the same operand order.
"""

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops import dfx

_EPS = 1e-8


# -- small helpers -----------------------------------------------------------

def matmul3(A, B):
    """(3,3,B) @ (3,3,B)."""
    return sum(A[:, k:k + 1, :] * B[k:k + 1, :, :] for k in range(3))


def matvec3(A, v):
    """(3,3,B) @ (3,B)."""
    return sum(A[:, k, :] * v[k:k + 1, :] for k in range(3))


def transpose(A):
    return dfx.swapaxes(A, 0, 1)


def _mat3(rows):
    """Build a (3,3,B) from a 3x3 nest of (B,) lane vectors."""
    if any(dfx.is_df(rows[i][j]) for i in range(3) for j in range(3)):
        # assembly is pure placement — build the hi and lo planes with
        # plain f32 one-hot accumulation (no DF arithmetic: the one-hot
        # masks are disjoint, so hi/lo components never interact)
        prom = [[dfx.promote(rows[i][j]) for j in range(3)] for i in range(3)]
        return dfx.DF(_mat3([[prom[i][j].hi for j in range(3)]
                             for i in range(3)]),
                      _mat3([[prom[i][j].lo for j in range(3)]
                             for i in range(3)]))
    # stack via broadcast-add with iota one-hots
    bshape = rows[0][0].shape  # trailing batch dims
    dt = rows[0][0].dtype
    ri = jax.lax.broadcasted_iota(jnp.int32, (3, 3) + (1,) * len(bshape), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (3, 3) + (1,) * len(bshape), 1)
    out = jnp.zeros((3, 3) + bshape, dt)
    for i in range(3):
        for j in range(3):
            out = out + jnp.where((ri == i) & (ci == j), 1.0, 0.0).astype(dt) \
                * rows[i][j][None, None]
    return out


def _vec(entries):
    """Build an (n,B) from a list of (B,) lane vectors."""
    if any(dfx.is_df(e) for e in entries):
        prom = [dfx.promote(e) for e in entries]
        return dfx.DF(_vec([p.hi for p in prom]), _vec([p.lo for p in prom]))
    n = len(entries)
    bshape = entries[0].shape
    dt = entries[0].dtype
    ri = jax.lax.broadcasted_iota(jnp.int32, (n,) + (1,) * len(bshape), 0)
    out = jnp.zeros((n,) + bshape, dt)
    for i in range(n):
        out = out + jnp.where(ri == i, 1.0, 0.0).astype(dt) * entries[i][None]
    return out


def hat(w):
    """(3,B) -> (3,3,B)."""
    z = dfx.zeros_like(w[0])
    return _mat3([[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]])


# -- SO(3) -------------------------------------------------------------------

def so3_exp(w, terms=None):
    """(3,B) -> (3,3,B) Rodrigues with Taylor guards.  ``terms`` truncates
    the DF series for provably-small angles (dfx.poly docstring)."""
    th_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    if dfx.is_df(w):
        # branchless full-range series in x = th^2 (no cancellation)
        a = dfx.poly(th_sq, dfx.SINC, terms=terms)
        b = dfx.poly(th_sq, dfx.COSC, terms=terms)
    else:
        small = th_sq < _EPS
        th = jnp.sqrt(jnp.where(small, 1.0, th_sq))
        a = jnp.where(small, 1.0 - th_sq / 6.0, jnp.sin(th) / th)
        b = jnp.where(small, 0.5 - th_sq / 24.0, (1.0 - jnp.cos(th)) / jnp.where(small, 1.0, th_sq))
    W = hat(w)
    W2 = matmul3(W, W)
    eye = _eye3(w.dtype, w.shape[1:])
    if dfx.is_df(w):
        eye = dfx.opaque(eye)  # constant-folded identity breaks DF EFTs
    return eye + a[None, None, :] * W + b[None, None, :] * W2


def _eye3(dt, B):
    """``B``: trailing batch shape — an int (lane layout (3,3,B)) or a
    tuple of trailing batch dims."""
    bshape = (B,) if isinstance(B, int) else tuple(B)
    ri = jax.lax.broadcasted_iota(jnp.int32, (3, 3) + (1,) * len(bshape), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (3, 3) + (1,) * len(bshape), 1)
    return jnp.where(ri == ci, 1.0, 0.0).astype(dt) * \
        jnp.ones((1, 1) + bshape, dt)


def quat_from_matrix(R):
    """(3,3,B) -> 4 lane vectors (qw, qx, qy, qz), branchless Shepperd."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def ssq(x):
        return dfx.sqrt(dfx.maximum(x, 1e-30))

    # candidates (unnormalized), one per pivot
    s_w = ssq(1.0 + tr)
    cw = (s_w * s_w, m21 - m12, m02 - m20, m10 - m01)
    s_x = ssq(1.0 + m00 - m11 - m22)
    cx = (m21 - m12, s_x * s_x, m01 + m10, m02 + m20)
    s_y = ssq(1.0 - m00 + m11 - m22)
    cy = (m02 - m20, m01 + m10, s_y * s_y, m12 + m21)
    s_z = ssq(1.0 - m00 - m11 + m22)
    cz = (m10 - m01, m02 + m20, m12 + m21, s_z * s_z)

    pw = 1.0 + tr
    px = 1.0 + m00 - m11 - m22
    py = 1.0 - m00 + m11 - m22
    pz = 1.0 - m00 - m11 + m22
    # select the best-pivot candidate with nested wheres
    use_x = (px >= pw) & (px >= py) & (px >= pz)
    use_y = jnp.logical_not(use_x) & (py >= pw) & (py >= px) & (py >= pz)
    use_z = jnp.logical_not(use_x) & jnp.logical_not(use_y) & \
        (pz >= pw) & (pz >= px) & (pz >= py)

    q = []
    for i in range(4):
        v = dfx.where(use_x, cx[i], dfx.where(use_y, cy[i],
                      dfx.where(use_z, cz[i], cw[i])))
        q.append(v)
    norm = dfx.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    sign = jnp.where(q[0] < 0.0, -1.0, 1.0)
    return tuple(sign * qq / norm for qq in q)


def matrix_from_quat(q):
    qw, qx, qy, qz = q
    return _mat3([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ])


def _atan_poly(t):
    """Cephes atanf core polynomial, |t| <= 0.4142 (f32-grade, ~1e-7)."""
    z = t * t
    return (((8.05374449538e-2 * z - 1.38776856032e-1) * z
             + 1.99777106478e-1) * z - 3.33329491539e-1) * z * t + t


def _atan_01(t):
    """atan(t) for t in [0, 1] with the pi/4 range reduction."""
    hi = t > 0.4142135623730950
    tr = (t - 1.0) / (t + 1.0)
    return jnp.where(hi, 0.7853981633974483 + _atan_poly(tr), _atan_poly(t))


def atan2_pos(y, x):
    """atan2 for y, x >= 0 (first quadrant) from elementwise primitives.

    The Cephes polynomial with range reduction (~1e-7 absolute —
    f32-grade), kept so that iterates match the recorded ones.  DF operands take
    the f32 estimate + one compensated Newton step on
    g(a) = sin(a) x - cos(a) y (quadratic convergence: ~1e-14 absolute),
    assuming x^2 + y^2 = O(1) as in the unit-quaternion caller."""
    if dfx.is_df(y) or dfx.is_df(x):
        y, x = dfx.promote(y), dfx.promote(x)
        a = dfx.promote(atan2_pos(y.hi, x.hi))
        s, c = dfx.sincos(a)
        return a - (s * x - c * y) / (c * x + s * y)
    swap = y > x
    num = jnp.where(swap, x, y)
    den = jnp.where(swap, y, x)
    t = num / jnp.maximum(den, 1e-30)
    a = _atan_01(t)
    return jnp.where(swap, 1.5707963267948966 - a, a)


def so3_log(R):
    """(3,3,B) -> (3,B), robust near 0 and pi (quaternion path)."""
    qw, qx, qy, qz = quat_from_matrix(R)
    nv_sq = qx * qx + qy * qy + qz * qz
    small = nv_sq < 1e-14
    nv = dfx.sqrt(dfx.where(small, 1.0, nv_sq))
    big = 2.0 * atan2_pos(nv, qw) / nv
    taylor = 2.0 / qw - 2.0 * nv_sq / (3.0 * qw**3)
    s = dfx.where(small, taylor, big)
    return _vec([s * qx, s * qy, s * qz])


def so3_normalize(R):
    return matrix_from_quat(quat_from_matrix(R))


def so3_normalize_newton(R):
    """One Newton step toward the polar factor: R (3I - R^T R)/2.

    For R within delta of orthogonal, the result is within O(delta^2) —
    the right renormalizer for the polish phase, whose rotations are
    already orthogonal to the previous iteration's DF grade (the full
    quaternion round-trip costs ~8x more DF ops; used by the polish
    rollout).  DF-polymorphic."""
    RtR = matmul3(transpose(R), R)
    eye = _eye3(R.dtype, R.shape[2:])
    if dfx.is_df(R):
        eye = dfx.opaque(eye)
    return 0.5 * matmul3(R, 3.0 * eye - RtR)


def so3_log_small(R, terms=10):
    """(3,3,B) -> (3,B) for NEAR-IDENTITY rotations: |theta| <= ~0.36 at
    DF grade (series `dfx.ASINC` radius; graceful degradation beyond).

    w = vee((R - R^T)/2) * (asin(s)/s)(s^2),  s = sin(theta) —
    quaternion-free and atan2-free, so the DF body is ~3x smaller than
    `so3_log`.  The polish-phase defect/deviation rotations are <= ~1e-2
    rad (tests/test_df_mixed.py gates end accuracy), far inside the
    envelope; do NOT use for cost-error logs (full range)."""
    a = _vec([0.5 * (R[2, 1] - R[1, 2]),
              0.5 * (R[0, 2] - R[2, 0]),
              0.5 * (R[1, 0] - R[0, 1])])
    s2 = a[0] * a[0] + a[1] * a[1] + a[2] * a[2]
    if dfx.is_df(R):
        f = dfx.poly(s2, dfx.ASINC, terms=terms)
    else:
        small = s2 < _EPS
        s2s = jnp.where(small, 0.0, s2)
        s = jnp.sqrt(s2s)
        th = jnp.arcsin(jnp.minimum(s, 1.0))
        f = jnp.where(small, 1.0 + s2 / 6.0, th / jnp.where(small, 1.0, s))
    return _vec([f * a[0], f * a[1], f * a[2]])


def se3_log_small(R, p, terms=10):
    """Small-angle `se3_log` twin (see `so3_log_small`)."""
    w = so3_log_small(R, terms=terms)
    v = matvec3(so3_left_jacobian_inv(w, terms=terms), p)
    return dfx.concatenate([w, v], axis=0)


def _jl_coeffs(th_sq, terms=None):
    if dfx.is_df(th_sq):
        return (dfx.poly(th_sq, dfx.COSC, terms=terms),
                dfx.poly(th_sq, dfx.SINC3, terms=terms))
    small = th_sq < _EPS
    th_sq_safe = jnp.where(small, 1.0, th_sq)
    th = jnp.sqrt(th_sq_safe)
    b = jnp.where(small, 0.5 - th_sq / 24.0, (1.0 - jnp.cos(th)) / th_sq_safe)
    c = jnp.where(small, 1.0 / 6.0 - th_sq / 120.0,
                  (th - jnp.sin(th)) / (th_sq_safe * th))
    return b, c


def so3_left_jacobian(w, terms=None):
    th_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    b, c = _jl_coeffs(th_sq, terms=terms)
    W = hat(w)
    W2 = matmul3(W, W)
    eye = _eye3(w.dtype, w.shape[1:])
    if dfx.is_df(w):
        eye = dfx.opaque(eye)  # constant-folded identity breaks DF EFTs
    return eye + b[None, None, :] * W + c[None, None, :] * W2


def so3_left_jacobian_inv(w, terms=None):
    th_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    if dfx.is_df(w):
        # Bernoulli series of 1/th^2 - cos(th/2)/(2 th sin(th/2)) in th^2
        # (terms: 6 suffice for |theta| <= ~0.4 — radius (2 pi)^2)
        k = dfx.poly(th_sq, dfx.JINVK, terms=terms)
    else:
        small = th_sq < _EPS
        th_sq_safe = jnp.where(small, 1.0, th_sq)
        th = jnp.sqrt(th_sq_safe)
        half = th / 2.0
        k = jnp.where(small, 1.0 / 12.0 + th_sq / 720.0,
                      1.0 / th_sq_safe - jnp.cos(half) / (2.0 * th * jnp.sin(half)))
    W = hat(w)
    W2 = matmul3(W, W)
    eye = _eye3(w.dtype, w.shape[1:])
    if dfx.is_df(w):
        eye = dfx.opaque(eye)  # constant-folded identity breaks DF EFTs
    return eye - 0.5 * W + k[None, None, :] * W2


# -- SE(3) (R (3,3,B), p (3,B)) ---------------------------------------------

def se3_exp(xi, terms=None):
    """(6,B) twist [w, v] -> (R, p)."""
    w = xi[:3]
    v = xi[3:]
    R = so3_exp(w, terms=terms)
    p = matvec3(so3_left_jacobian(w, terms=terms), v)
    return R, p


def se3_log(R, p):
    """(R, p) -> (6,B)."""
    w = so3_log(R)
    v = matvec3(so3_left_jacobian_inv(w), p)
    return dfx.concatenate([w, v], axis=0)


def se3_compose(R1, p1, R2, p2):
    return matmul3(R1, R2), matvec3(R1, p2) + p1


def se3_inverse(R, p):
    Rt = transpose(R)
    return Rt, -matvec3(Rt, p)


def matmul(A, B, m):
    """(n,m,B) @ (m,p,B) generic lane matmul."""
    return sum(A[:, k:k + 1, :] * B[k:k + 1, :, :] for k in range(m))


def matvec(A, v, m):
    """(n,m,B) @ (m,B)."""
    return sum(A[:, k, :] * v[k:k + 1, :] for k in range(m))


def blk(A, Bm, C, D):
    """[[A, Bm], [C, D]] from (r,c,B) quadrants via concatenations."""
    top = dfx.concatenate([A, Bm], axis=1)
    bot = dfx.concatenate([C, D], axis=1)
    return dfx.concatenate([top, bot], axis=0)


def _zeros3(like):
    return dfx.zeros_like(like)


def _q_coeffs(th_sq):
    """Barfoot Q-matrix coefficients with Taylor guards (lane vectors)."""
    if dfx.is_df(th_sq):
        return (dfx.poly(th_sq, dfx.SINC3), dfx.poly(th_sq, dfx.COSC4),
                dfx.poly(th_sq, dfx.C3SER))
    small = th_sq < _EPS
    th_sq_safe = jnp.where(small, 1.0, th_sq)
    th = jnp.sqrt(th_sq_safe)
    s, c = jnp.sin(th), jnp.cos(th)
    c1 = jnp.where(small, 1.0 / 6.0 - th_sq / 120.0, (th - s) / (th_sq_safe * th))
    c2 = jnp.where(small, 1.0 / 24.0 - th_sq / 720.0,
                   (th_sq_safe + 2.0 * c - 2.0) / (2.0 * th_sq_safe * th_sq_safe))
    c3 = jnp.where(small, 1.0 / 120.0 - th_sq / 2520.0,
                   (2.0 * th - 3.0 * s + th * c) / (2.0 * th_sq_safe * th_sq_safe * th))
    return c1, c2, c3


def _q_matrix(w, v):
    th_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    c1, c2, c3 = _q_coeffs(th_sq)
    W = hat(w)
    V = hat(v)
    WV = matmul3(W, V)
    VW = matmul3(V, W)
    WVW = matmul3(WV, W)
    e = lambda x: x[None, None, :]
    return (0.5 * V + e(c1) * (WV + VW + WVW)
            + e(c2) * (matmul3(W, WV) + matmul3(VW, W) - 3.0 * WVW)
            + e(c3) * (matmul3(WVW, W) + matmul3(W, WVW)))


def se3_right_jacobian(xi):
    """(6,B) -> (6,6,B), Jr(xi) = Jl(-xi)."""
    w = -xi[:3]
    v = -xi[3:]
    Jw = so3_left_jacobian(w)
    Q = _q_matrix(w, v)
    Z = dfx.zeros_like(Jw)
    return blk(Jw, Z, Q, Jw)


def se3_right_jacobian_inv(xi):
    """(6,B) -> (6,6,B), Jr^-1(xi) = Jl^-1(-xi)."""
    w = -xi[:3]
    v = -xi[3:]
    Jwi = so3_left_jacobian_inv(w)
    Q = _q_matrix(w, v)
    Z = dfx.zeros_like(Jwi)
    return blk(Jwi, Z, -matmul3(matmul3(Jwi, Q), Jwi), Jwi)


def se3_Ad(R, p):
    """Group adjoint [[R, 0], [hat(p) R, R]] as (6,6,B)."""
    Z = dfx.zeros_like(R)
    return blk(R, Z, matmul3(hat(p), R), R)
