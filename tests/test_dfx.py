"""Double-f32 arithmetic (ops/dfx.py): accuracy vs float64 ground truth.

Also probes that XLA preserves the IEEE semantics the error-free
transformations rely on (no unsafe reassociation of (a+b)-a-b).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trajectory_optimization_matrix_lie_groups.ops import dfx

RNG = np.random.default_rng(7)


def _rand(n, lo=-100.0, hi=100.0):
    return RNG.uniform(lo, hi, n)


def _df(x):
    return dfx.split_f64(jnp.asarray(x, jnp.float64))


def _err(d, ref):
    got = np.asarray(dfx.join_f64(d))
    ref = np.asarray(ref)
    return np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30))


def test_two_sum_not_optimized_away():
    # (a + b) - a - b must NOT fold to zero under jit: the compensated
    # arithmetic depends on strict FP semantics.
    f = jax.jit(lambda a, b: dfx._two_sum(a, b)[1])
    e = f(jnp.float32(1.0), jnp.float32(1e-8))
    assert float(e) != 0.0
    # and two_sum is exact: hi+lo == a+b in f64
    a, b = jnp.float32(0.1), jnp.float32(1e-7)
    s, e = jax.jit(dfx._two_sum)(a, b)
    assert float(s) + float(e) == float(a) + float(b)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_arith_accuracy(op):
    a = _rand(4096)
    b = _rand(4096)
    if op == "div":
        b = np.where(np.abs(b) < 1e-3, 1.0, b)
    da, db = _df(a), _df(b)
    # ground truth on the df-ROUNDED inputs (the inputs themselves carry
    # ~2^-49 representation error; the ops must not add to it)
    aa, bb = np.asarray(dfx.join_f64(da)), np.asarray(dfx.join_f64(db))
    fn = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
          "mul": lambda x, y: x * y, "div": lambda x, y: x / y}[op]
    got = np.asarray(dfx.join_f64(fn(da, db)))
    ref = fn(aa, bb)
    scale = np.maximum(np.abs(aa), np.abs(bb)) if op in ("add", "sub") \
        else np.abs(ref)
    assert np.max(np.abs(got - ref) / np.maximum(scale, 1e-30)) < 2e-14


def test_arith_cancellation():
    # massive cancellation: accurate add keeps the residual (only the f32
    # representation rounding of the 3e-13 residual itself remains)
    a = np.float64(np.float32(1.0))
    b = -a + 3e-13
    d = _df(a) + _df(b)
    # 3e-13 itself is perturbed by ~ulp(1)/2 when b is formed in f64
    assert abs(float(dfx.join_f64(d)) - 3e-13) < 3e-16


def test_sqrt():
    a = np.abs(_rand(4096, 0, 1e4)) + 1e-6
    assert _err(dfx.sqrt(_df(a)), np.sqrt(a)) < 2e-14
    z = dfx.sqrt(_df(np.zeros(8)))
    assert np.all(np.asarray(dfx.join_f64(z)) == 0.0)


def test_scalar_promotion_keeps_f64_constants():
    # 0.004 is not an f32 value; DF promotion must not round it
    x = _df(np.ones(16))
    assert _err(x * 0.004, np.full(16, 0.004)) < 1e-14
    assert _err(1.0 / _df(np.full(16, 3.0)), np.full(16, 1.0 / 3.0)) < 1e-14


def test_pow_getitem_neg():
    a = _rand(32, 0.1, 2.0)
    d = _df(a)
    assert _err(d ** 3, a ** 3) < 1e-13
    assert _err((-d)[3:7], -a[3:7]) < 1e-14


def test_where_maximum_concat():
    a, b = _rand(64), _rand(64)
    da, db = _df(a), _df(b)
    a, b = np.asarray(dfx.join_f64(da)), np.asarray(dfx.join_f64(db))
    c = a > b
    assert _err(dfx.where(c, da, db), np.where(c, a, b)) == 0.0
    assert _err(dfx.maximum(da, db), np.maximum(a, b)) == 0.0
    assert _err(dfx.concatenate([da, db]), np.concatenate([a, b])) == 0.0
    w = dfx.where(c, da, 1.0)
    assert _err(w, np.where(c, a, 1.0)) == 0.0


# avoid small theta in the closed-form reference region: the f64 closed
# forms themselves lose digits to cancellation there (exactly what the
# series avoid) — e.g. (x + 2cos - 2)/(2x^2) is only ~1e-10-accurate in f64
# at theta = 0.05.  Small theta is covered by the f64-Horner cross-check
# (same exact rational coefficients, independent arithmetic) + tiny-Taylor.
THETAS = np.linspace(0.5, np.pi + 0.05, 173)
THETAS_ALL = np.linspace(1e-3, np.pi + 0.05, 223)
THETAS_TINY = np.array([0.0, 1e-9, 1e-7, 1e-5, 1e-4])


def _series_ref():
    th = THETAS
    x = th * th
    return {
        "SINC": np.sin(th) / th,
        "COSSER": np.cos(th),
        "COSC": (1 - np.cos(th)) / x,
        "SINC3": (th - np.sin(th)) / (x * th),
        "COSC4": (x + 2 * np.cos(th) - 2) / (2 * x * x),
        "C3SER": (2 * th - 3 * np.sin(th) + th * np.cos(th)) / (2 * x * x * th),
        "JINVK": 1 / x - np.cos(th / 2) / (2 * th * np.sin(th / 2)),
    }


@pytest.mark.parametrize("name", ["SINC", "COSSER", "COSC", "SINC3",
                                  "COSC4", "C3SER", "JINVK"])
def test_series(name):
    coeffs = getattr(dfx, name)
    ref = _series_ref()[name]
    x = _df(THETAS.astype(np.float64) ** 2)
    got = np.asarray(dfx.join_f64(dfx.poly(x, coeffs)))
    # absolute comparison at the function's O(1e-2..1) natural scale; the
    # f64 closed form itself carries ~1e-13 cancellation noise at small th
    err = np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0))
    assert err < 1e-12, f"{name}: {err:.3e}"
    # full range incl. small theta: f64 Horner with the same exact rational
    # coefficients (independent arithmetic path, no cancellation)
    cs = [float(dfx.join_f64(dfx.DF(cc.hi, cc.lo))) for cc in coeffs]
    xs = THETAS_ALL ** 2
    ref64 = np.full_like(xs, cs[-1])
    for c in reversed(cs[:-1]):
        ref64 = ref64 * xs + c
    got_all = np.asarray(dfx.join_f64(dfx.poly(_df(xs), coeffs)))
    err2 = np.max(np.abs(got_all - ref64) / np.maximum(np.abs(ref64), 1e-2))
    # (abs ~4e-15 near sinc's zero at pi: df + f64 Horner noise, harmless)
    assert err2 < 1e-12, f"{name} vs f64 Horner: {err2:.3e}"
    # tiny theta: 3-term Taylor is exact to <<1e-16 there
    xt = _df(THETAS_TINY.astype(np.float64) ** 2)
    got_t = np.asarray(dfx.join_f64(dfx.poly(xt, coeffs)))
    taylor = cs[0] + cs[1] * THETAS_TINY ** 2 + cs[2] * THETAS_TINY ** 4
    assert np.max(np.abs(got_t - taylor)) < 1e-14 * max(abs(cs[0]), 1e-2)


def test_sincos_tiny():
    th = _df(THETAS_TINY)
    s, c = dfx.sincos(th)
    sref = THETAS_TINY - THETAS_TINY ** 3 / 6
    cref = 1 - THETAS_TINY ** 2 / 2 + THETAS_TINY ** 4 / 24
    assert np.max(np.abs(np.asarray(dfx.join_f64(s)) - sref)) < 1e-18
    assert np.max(np.abs(np.asarray(dfx.join_f64(c)) - cref)) < 1e-15


def test_sincos():
    th = _df(THETAS)
    s, c = dfx.sincos(th)
    assert np.max(np.abs(np.asarray(dfx.join_f64(s)) - np.sin(THETAS))) < 1e-13
    assert np.max(np.abs(np.asarray(dfx.join_f64(c)) - np.cos(THETAS))) < 1e-13


def test_split_join_roundtrip():
    a = _rand(256) * 1e3
    assert np.max(np.abs(np.asarray(dfx.join_f64(_df(a))) - a)
                  / np.abs(a)) < 1e-14
