"""Double-f32 ("double-single") arithmetic on lane-layout values.

The BASELINE control-fidelity gate (max|us - golden| <= 1e-4) needs
better-than-f32 arithmetic in the solve's final iterations: f32 rounding
noise (~6e-8 relative) injected at every stage is amplified ~5e4x through
the near-flat directions of the trajectory Hessian (sigma_min(Quu) ~ 2R =
2e-5).  This module implements the classic compensated two-float
representation — a value is an unevaluated sum ``hi + lo`` of two f32 with
|lo| <= ulp(hi)/2, giving ~49 mantissa bits — with enough of the jnp API
mirrored that the lane-layout Lie stage math in `ops/lie_lane.py` runs
unchanged on `DF` operands (operator overloading + the dispatching helpers
below).  It is one of the two ways to that gate; the other is native f64
(`solvers/polish.HighPrecisionSolver`), and which is faster on the GPU is
an open measurement (ROADMAP 1.5).

Algorithms are the standard error-free transformations (Knuth two-sum,
Dekker split / two-product with the 12-bit split) as in DSFUN90/QD.
Correctness relies on IEEE f32 add/mul semantics without unsafe
reassociation; XLA preserves these on the CPU and the GPU (tests/
test_dfx.py; chip_smoke.py checks add/mul against numpy f64 on the card).

Transcendentals: rotation-angle coefficient functions (sin th/th,
(1-cos th)/th^2, the SO(3)/SE(3) Jacobian and Barfoot-Q coefficients) are
evaluated as single Taylor series in x = th^2 with exactly-split rational
coefficients (computed with `fractions.Fraction` at import) — branchless,
no cancellation, valid on the full |th| <= pi (+ margin) range the Lie ops
produce.  This replaces the f32 path's trig-with-Taylor-guard pattern whose
guarded branches are exactly the places where f32 cancellation lives
(e.g. (th^2 + 2 cos th - 2)/(2 th^4)).

Role in the framework: `solvers/df_pipeline.py` and `solvers/df_mixed.py`
run the MS-iLQR stage math on DF operands as the high-precision polish
phase (the reference's float64-end-to-end policy,
main_SE3ddp_tracking_exact_ms.py:36).
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

__all__ = [
    "DF", "is_df", "promote", "const", "split_f64", "join_f64",
    "where", "sqrt", "maximum", "minimum", "concatenate", "swapaxes",
    "zeros", "zeros_like", "sincos", "poly", "opaque",
    "SINC", "COSSER", "COSC", "SINC3", "COSC4", "C3SER", "JINVK",
    "ASINC",
]

_SPLIT = np.float32(4097.0)  # 2^12 + 1: Dekker split constant for f32


# -- error-free transformations (f32 arrays) ---------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    h = t - (t - a)
    return h, a - h


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_(xh, xl, yh, yl):
    """Accurate double-single add (IEEE-style, Dekker/Knuth)."""
    sh, sl = _two_sum(xh, yh)
    th, tl = _two_sum(xl, yl)
    sl = sl + th
    sh, sl = _quick_two_sum(sh, sl)
    sl = sl + tl
    return _quick_two_sum(sh, sl)


def _mul_(xh, xl, yh, yl):
    p, e = _two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return _quick_two_sum(p, e)


def _div_(xh, xl, yh, yl):
    q1 = xh / yh
    p, e = _two_prod(q1, yh)
    sh, sl = _two_sum(xh, -p)
    r = sh + (sl - e + xl - q1 * yl)
    q2 = r / yh
    return _quick_two_sum(q1, q2)


# -- the DF value type --------------------------------------------------------

class DF:
    """An unevaluated f32 sum hi + lo.  Components may be jnp arrays,
    tracers, or numpy scalars (constants)."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo=None):
        self.hi = hi
        self.lo = jnp.zeros_like(hi) if lo is None else lo

    # structure ------------------------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.hi)

    @property
    def ndim(self):
        return jnp.ndim(self.hi)

    @property
    def dtype(self):
        return jnp.asarray(self.hi).dtype if not hasattr(self.hi, "dtype") \
            else self.hi.dtype

    def __getitem__(self, idx):
        return DF(self.hi[idx], self.lo[idx])

    def astype(self, dt):
        return DF(self.hi.astype(dt), self.lo.astype(dt))

    # arithmetic -----------------------------------------------------------
    def __neg__(self):
        return DF(-self.hi, -self.lo)

    def __add__(self, o):
        a, o = _rt_operands(self, promote(o))
        return DF(*_add_(a.hi, a.lo, o.hi, o.lo))

    __radd__ = __add__

    def __sub__(self, o):
        a, o = _rt_operands(self, promote(o))
        return DF(*_add_(a.hi, a.lo, -o.hi, -o.lo))

    def __rsub__(self, o):
        return promote(o).__sub__(self)

    def __mul__(self, o):
        a, o = _rt_operands(self, promote(o))
        return DF(*_mul_(a.hi, a.lo, o.hi, o.lo))

    __rmul__ = __mul__

    def __truediv__(self, o):
        a, o = _rt_operands(self, promote(o))
        return DF(*_div_(a.hi, a.lo, o.hi, o.lo))

    def __rtruediv__(self, o):
        return promote(o).__truediv__(self)

    def __pow__(self, n):
        if not isinstance(n, int) or n < 1:
            raise NotImplementedError("DF ** requires a positive int")
        out = self
        for _ in range(n - 1):
            out = out * self
        return out

    # comparisons (guard thresholds: the hi part decides) --------------------
    def __lt__(self, o):
        return self.hi < (o.hi if is_df(o) else o)

    def __le__(self, o):
        return self.hi <= (o.hi if is_df(o) else o)

    def __gt__(self, o):
        return self.hi > (o.hi if is_df(o) else o)

    def __ge__(self, o):
        return self.hi >= (o.hi if is_df(o) else o)


def is_df(x):
    return isinstance(x, DF)


def _opaque_const(c, ref_hi):
    """Make a host-scalar DF constant opaque to XLA's simplifier.

    Inside a jit graph, XLA's algebraic simplifier reassociates float
    expressions whose operands are LITERAL constants ((a + c) - a -> c,
    and the matching product forms), which silently deletes the
    two_sum/two_prod error terms wherever a constant participates and
    collapses that DF chain to f32 accuracy (measured: quaternion
    extraction / so3_log / series coefficients all land ~1e-8 under jit
    vs ~1e-14 eager).  Routing the constant's
    (hi, lo) through `lax.optimization_barrier` turns it into a runtime
    value the constant-only rewrite rules cannot touch; EFTs between
    runtime arrays are preserved by XLA (tests/test_dfx.py).  Only called
    when the partner operand is a jax array, so module-level coefficient
    construction (pure numpy) never touches the jax backend."""
    from jax import lax as _lax

    dt = getattr(ref_hi, "dtype", jnp.float32)
    h, l = _lax.optimization_barrier(
        (jnp.asarray(c.hi, dt), jnp.asarray(c.lo, dt)))
    return DF(h, l)


def opaque(x):
    """`optimization_barrier` for constant-VALUED jnp arrays (identity
    masks, one-hots) entering DF arithmetic: they are jax-typed, so
    `_rt_operands` cannot detect them, but trace-time constant folding
    re-literalizes them and exposes the EFTs to the simplifier's
    constant reassociation (see `_opaque_const`)."""
    from jax import lax as _lax

    return _lax.optimization_barrier(x)


def _rt_operands(a, b):
    """Opacify whichever side of a DF binary op is a host-scalar constant
    when the other side is jax data (see `_opaque_const`)."""
    a_jax = isinstance(a.hi, jnp.ndarray)
    b_jax = isinstance(b.hi, jnp.ndarray)
    if not a_jax and b_jax:
        a = _opaque_const(a, b.hi)
    elif not b_jax and a_jax:
        b = _opaque_const(b, a.hi)
    return a, b


def const(v):
    """Split a python float / f64 scalar into an exact-as-possible DF
    constant (numpy f32 scalars; broadcast in jnp ops)."""
    hi = np.float32(v)
    return DF(hi, np.float32(float(v) - float(hi)))


def promote(x):
    if is_df(x):
        return x
    if isinstance(x, (int, float, np.floating)):
        return const(float(x))
    return DF(x, jnp.zeros_like(x))


def split_f64(x):
    """f64 array -> DF of two f32 arrays (call with x64 enabled)."""
    x = jnp.asarray(x, jnp.float64)
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(jnp.float64)).astype(jnp.float32)
    return DF(hi, lo)


def join_f64(d):
    """DF -> f64 array (call with x64 enabled)."""
    return d.hi.astype(jnp.float64) + d.lo.astype(jnp.float64)


# -- jnp-API mirrors that dispatch on DF --------------------------------------

def where(c, a, b):
    if is_df(a) or is_df(b):
        a, b = promote(a), promote(b)
        return DF(jnp.where(c, a.hi, b.hi), jnp.where(c, a.lo, b.lo))
    return jnp.where(c, a, b)


def maximum(a, b):
    if is_df(a) or is_df(b):
        a, b = promote(a), promote(b)
        c = a.hi >= (b.hi if hasattr(b.hi, "shape") else b.hi)
        return DF(jnp.where(c, a.hi, b.hi), jnp.where(c, a.lo, b.lo))
    return jnp.maximum(a, b)


def minimum(a, b):
    if is_df(a) or is_df(b):
        a, b = promote(a), promote(b)
        c = a.hi <= b.hi
        return DF(jnp.where(c, a.hi, b.hi), jnp.where(c, a.lo, b.lo))
    return jnp.minimum(a, b)


def concatenate(seq, axis=0):
    seq = list(seq)
    if any(is_df(s) for s in seq):
        seq = [s if is_df(s) else DF(s, jnp.zeros_like(s)) for s in seq]
        return DF(jnp.concatenate([s.hi for s in seq], axis=axis),
                  jnp.concatenate([s.lo for s in seq], axis=axis))
    return jnp.concatenate(seq, axis=axis)


def swapaxes(x, a, b):
    if is_df(x):
        return DF(jnp.swapaxes(x.hi, a, b), jnp.swapaxes(x.lo, a, b))
    return jnp.swapaxes(x, a, b)


def zeros(shape, dtype, like=None):
    z = jnp.zeros(shape, dtype)
    return DF(z, jnp.zeros(shape, dtype)) if is_df(like) else z


def zeros_like(x):
    if is_df(x):
        return DF(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))
    return jnp.zeros_like(x)


def sqrt(x):
    """DF sqrt: f32 seed + one compensated Newton step (x >= 0)."""
    if not is_df(x):
        return jnp.sqrt(x)
    h = jnp.sqrt(x.hi)
    safe = jnp.where(h > 0, h, 1.0)
    p, e = _two_prod(safe, safe)
    dh, dl = _add_(x.hi, x.lo, -p, -e)
    corr = (dh + dl) / (2.0 * safe)
    rh, rl = _quick_two_sum(safe, corr)
    zero = h <= 0
    return DF(jnp.where(zero, h, rh), jnp.where(zero, jnp.zeros_like(rl), rl))


# -- Taylor-series coefficient functions of x = theta^2 -----------------------
#
# Exact rational coefficients split into DF constants at import time.  All
# series are entire (except JINVK, radius (2 pi)^2) so a single truncation
# covers the full rotation-angle range |theta| <= pi with df-grade accuracy.

def _fact(n):
    out = 1
    for i in range(2, n + 1):
        out *= i
    return out


def _bernoulli(m):
    """B_0..B_m by the defining recurrence, exact."""
    B = [Fraction(1)]
    for n in range(1, m + 1):
        s = Fraction(0)
        for j in range(n):
            s += Fraction(_fact(n + 1), _fact(j) * _fact(n + 1 - j)) * B[j]
        B.append(-s / (n + 1))
    return B


def _df_coeffs(fracs):
    return tuple(const(float(Fraction(f))) for f in fracs)


_NT = 20  # terms for the entire series: remainder < 1e-16 for |theta| <= 4

# sin th / th               = sum (-x)^k / (2k+1)!
SINC = _df_coeffs([Fraction((-1) ** k, _fact(2 * k + 1)) for k in range(_NT)])
# cos th                    = sum (-x)^k / (2k)!
COSSER = _df_coeffs([Fraction((-1) ** k, _fact(2 * k)) for k in range(_NT)])
# (1 - cos th) / th^2       = sum (-x)^k / (2k+2)!
COSC = _df_coeffs([Fraction((-1) ** k, _fact(2 * k + 2)) for k in range(_NT)])
# (th - sin th) / th^3      = sum (-x)^k / (2k+3)!
SINC3 = _df_coeffs([Fraction((-1) ** k, _fact(2 * k + 3)) for k in range(_NT)])
# (th^2 + 2 cos th - 2) / (2 th^4) = sum (-x)^k / (2k+4)!
COSC4 = _df_coeffs([Fraction((-1) ** k, _fact(2 * k + 4)) for k in range(_NT)])
# (2 th - 3 sin th + th cos th) / (2 th^5)
C3SER = _df_coeffs([
    Fraction((-1) ** k) * (Fraction(1, _fact(2 * k + 4))
                           - Fraction(3, _fact(2 * k + 5))) / 2
    for k in range(_NT)])
# 1/th^2 - cos(th/2)/(2 th sin(th/2)) = sum_j (-1)^j B_{2j+2} x^j / (2j+2)!
# (radius (2 pi)^2; 32 terms give ~(pi^2/4pi^2)^32 ~ 5e-20 at theta = pi)
_NB = 32
_B = _bernoulli(2 * _NB + 2)
JINVK = _df_coeffs([
    Fraction((-1) ** j) * _B[2 * j + 2] / _fact(2 * j + 2)
    for j in range(_NB)])
# asin(s)/s = sum_k (2k)! / (4^k (k!)^2 (2k+1)) s^{2k}   (radius s^2 = 1);
# used by the small-angle so3_log (lie_lane.so3_log_small): theta/sin
# theta recovered from s = |vee((R - R^T)/2)| without quaternions/atan2.
# 12 terms: truncation < 1e-15 for s^2 <= 0.12 (|theta| <= ~0.36)
ASINC = _df_coeffs([
    Fraction(_fact(2 * k), (4 ** k) * _fact(k) ** 2 * (2 * k + 1))
    for k in range(12)])


def poly(x, coeffs, terms=None):
    """Estrin evaluation of a DF-coefficient series at DF x.

    ``terms``: evaluate only the first ``terms`` coefficients — for
    callers whose argument range is PROVABLY small (e.g. the polish
    rollout's per-step rotations, |theta| <= ~0.35), where the full-range
    truncation length only wastes ops.  The caller owns the envelope.

    Horner's rule chains terms serially (depth ~ n ops); both at run time
    (no instruction-level parallelism across a serial chain) and in XLA's
    compile-time passes (superlinear in dependency-chain depth) that depth
    is the dominant cost.  Estrin's scheme pairs
    coefficients and squares the argument recursively: depth O(log n),
    same op count."""
    x = promote(x)
    b = jnp.zeros_like(x.hi)
    # Broadcast scalar coefficients against x once — through an
    # optimization_barrier: XLA's algebraic simplifier reassociates
    # float expressions whose operands are LITERAL constants
    # ((a + c) - a -> c), which silently destroys the two_sum/two_prod
    # error terms exactly where a coefficient participates and collapses
    # the series to f32 accuracy (measured: SINC 3.8e-15 eager ->
    # 3.1e-8 under jit).  The barrier makes the
    # coefficients opaque runtime values, which the simplifier's
    # constant-only reassociation rules cannot touch; EFTs between two
    # runtime arrays are preserved by XLA (verified in test_dfx).
    from jax import lax as _lax

    if terms is not None:
        coeffs = coeffs[:terms]
    terms = []
    for c in coeffs:
        cp = promote(c)
        ch = jnp.asarray(cp.hi, x.hi.dtype)
        cl = jnp.asarray(cp.lo, x.hi.dtype)
        ch, cl = _lax.optimization_barrier((ch, cl))
        terms.append(DF(b + ch, b + cl))
    p = x
    while len(terms) > 1:
        terms = [terms[i] + p * terms[i + 1] if i + 1 < len(terms)
                 else terms[i] for i in range(0, len(terms), 2)]
        if len(terms) > 1:
            p = p * p
    return terms[0]


def sincos(theta):
    """(sin theta, cos theta); DF path: full-range Taylor (|theta| <= ~4)."""
    if not is_df(theta):
        return jnp.sin(theta), jnp.cos(theta)
    x = theta * theta
    return theta * poly(x, SINC), poly(x, COSSER)


def sin(theta):
    return sincos(theta)[0] if is_df(theta) else jnp.sin(theta)


def cos(theta):
    return sincos(theta)[1] if is_df(theta) else jnp.cos(theta)
