"""Stage recursions over a lane batch: one generated CUDA kernel, or one scan.

The pipeline's stage math (`solvers/pipeline.py`, `ops/lie_lane.py`) is
written on lane-layout arrays: every value carries the batch of problems on
its TRAILING axis — a rotation is (3, 3, B), a Jacobian (12, 12, B).  A
sequential recursion over stages (the Riccati backward pass, the
gap-closing rollout) is then

    carry, aux = init(consts)
    for t in stages:   carry, y[t] = step(consts, carry, x[t])

`lane_scan` runs that recursion in one of two ways over the SAME `init` /
`step` functions:

  - ``kernel=False``: a `lax.scan` over the stage axis on (..., B) arrays,
    compiled by XLA — the plain reference;
  - ``kernel=True``: one kernel with one thread per problem.  The thread
    keeps the carry in registers through a loop over stages, and reads
    each stage's inputs and writes its outputs exactly once, coalesced
    (lane-last layout: neighbouring threads touch neighbouring words).

The kernel is generated, not hand-written: `init` and `step` are traced
once to jaxprs and compiled to straight-line C++ ENTRY BY ENTRY
(`_Codegen`) — every value is held as a numpy object array over its leading
(non-lane) axes whose entries are scalar C variables, or numpy scalars
where the value does not depend on the inputs (identity blocks, zero
blocks, one-hot masks).  Structural primitives (slice, concatenate,
transpose, broadcast, reshape, iota) only rearrange entries; elementwise
primitives emit one C statement per entry.  Constant entries fold (x*1 ->
x, x+0 -> x, 0*x -> 0, select on a constant predicate), so the placement
arithmetic of the lane-layout code costs nothing in the kernel, and the
per-entry operation order is the jaxpr's: the kernel computes the same
sums in the same order as the scan, up to the compilers' FMA contraction.
The folds assume finite values: where the scan computes 0*NaN = NaN in an
entry multiplied by a structural zero, the kernel stores 0.  So on a lane
gone non-finite single entries differ from the scan's, but the same lanes
are non-finite in both (tests/test_pipeline.py checks this on a NaN lane).

The source is compiled once per distinct recursion and cached under
``<repo>/.build/lanewise/``: with nvcc for the GPU (``sm_90a``, called
through XLA's foreign function interface on XLA's CUDA stream), and with
the host C++ compiler on the CPU (the same code as a loop over lanes — what
the CPU tests run, as CUDA has no interpret mode).
"""

import ctypes
import hashlib
import operator
import os
import re
import shutil
import subprocess
import tempfile

import jax
import numpy as np
from jax import lax
from jax.extend import core as jex_core

from trajectory_optimization_matrix_lie_groups.utils.platform import (
    REPO_ROOT,
    kernel_platform,
)

__all__ = ["lane_scan", "kernel_source", "BLOCK"]

BLOCK = 128          # threads (= problems) per CUDA block
BUILD_DIR = os.path.join(REPO_ROOT, ".build", "lanewise")

_CTYPE = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
          np.dtype(np.bool_): "bool", np.dtype(np.int32): "int",
          np.dtype(np.int64): "long long"}

# elementwise primitives -> C spellings (f32; `_f` spells doubles)
_BINOP = {lax.add_p: "+", lax.sub_p: "-", lax.mul_p: "*", lax.div_p: "/",
          lax.eq_p: "==", lax.ne_p: "!=", lax.lt_p: "<", lax.le_p: "<=",
          lax.gt_p: ">", lax.ge_p: ">="}
_UNFN = {lax.sqrt_p: "sqrtf", lax.sin_p: "sinf", lax.cos_p: "cosf",
         lax.tan_p: "tanf", lax.atan_p: "atanf", lax.asin_p: "asinf",
         lax.acos_p: "acosf", lax.exp_p: "expf", lax.log_p: "logf",
         lax.abs_p: "fabsf", lax.floor_p: "floorf", lax.ceil_p: "ceilf",
         lax.tanh_p: "tanhf", lax.exp2_p: "exp2f", lax.log1p_p: "log1pf",
         lax.expm1_p: "expm1f"}
_BINFN = {lax.max_p: "jmax", lax.min_p: "jmin", lax.atan2_p: "atan2f",
          lax.pow_p: "powf"}
_ELEMENTWISE = (set(_BINOP) | set(_UNFN) | set(_BINFN) | {
    lax.neg_p, lax.rsqrt_p, lax.integer_pow_p, lax.square_p, lax.sign_p,
    lax.select_n_p, lax.and_p, lax.or_p, lax.not_p, lax.xor_p,
    lax.convert_element_type_p, lax.clamp_p, lax.is_finite_p})

# numpy folds for constant entries (IEEE single ops are correctly rounded
# in numpy as on the devices, so folding does not move any value)
_NP_FOLD = {
    lax.add_p: operator.add, lax.sub_p: operator.sub,
    lax.mul_p: operator.mul, lax.div_p: operator.truediv,
    lax.neg_p: operator.neg, lax.max_p: np.maximum, lax.min_p: np.minimum,
    lax.sqrt_p: np.sqrt, lax.abs_p: np.abs,
    lax.eq_p: operator.eq, lax.ne_p: operator.ne, lax.lt_p: operator.lt,
    lax.le_p: operator.le, lax.gt_p: operator.gt, lax.ge_p: operator.ge,
    lax.and_p: np.logical_and, lax.or_p: np.logical_or,
    lax.not_p: np.logical_not,
}

_CALLS = ("jaxpr", "call_jaxpr", "fun_jaxpr")

_PRELUDE = r"""
#include <cmath>
#include <cstddef>
#include <cstdint>
#include "xla/ffi/api/ffi.h"
#ifdef __CUDACC__
#define LW_FN __host__ __device__ __forceinline__
#else
#define LW_FN inline
#endif
template <class T> LW_FN T jmax(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b)); }
template <class T> LW_FN T jmin(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b)); }
template <class T> LW_FN T jsign(T a) {
  return a > T(0) ? T(1) : (a < T(0) ? T(-1) : a); }
namespace ffi = xla::ffi;
"""


def _const(x):
    """Entry is a trace-time constant (numpy scalar), not a variable."""
    return isinstance(x, (np.generic, int, float, bool))


def _as_np(x, dtype):
    return np.asarray(x, dtype)[()]


def _is(x, v):
    return _const(x) and x == v


def _lit(v, dtype):
    """C literal of a constant entry in ``dtype``."""
    dtype = np.dtype(dtype)
    v = _as_np(v, dtype)
    if dtype == np.bool_:
        return "true" if v else "false"
    if dtype.kind in "iu":
        return f"({_CTYPE[dtype]}){int(v)}"
    ct = _CTYPE[dtype]
    if np.isnan(v):
        return f"({ct})NAN"
    if np.isinf(v):
        return f"({ct})({'-' if v < 0 else ''}INFINITY)"
    return float(v).hex() + ("f" if dtype == np.float32 else "")


def _f(name, dtype):
    """Math function spelled for ``dtype`` (sinf -> sin for doubles)."""
    if np.dtype(dtype) == np.float64 and name.endswith("f") and \
            name not in ("jmax", "jmin"):
        return name[:-1]
    return name


class _Codegen:
    """Evaluates jaxprs on values held entry by entry, emitting one C
    statement per elementwise entry (module docstring).

    ``lane``: the lane width the jaxprs were traced at; every rank >= 1
    value's trailing axis must have that size or 1."""

    def __init__(self, lane):
        self.lane = lane
        self.n = 0
        self.section()

    def section(self):
        """Start a new straight-line section; returns the previous one's
        statements.  Within a section, a load is emitted just before its
        first use (unused loads never are) and a store just after its
        value is defined, so values stay live no longer than needed."""
        out = []
        after = {}
        for p, st in getattr(self, "stores", ()):
            after.setdefault(p, []).append(st)
        out += after.get(-1, [])
        for i, ln in enumerate(getattr(self, "lines", ())):
            out.append(ln)
            out += after.get(i, [])
        self.lines, self.pending, self.pos, self.stores = [], {}, {}, []
        return out

    def _use(self, expr):
        for tok in re.findall(r"\bv\d+\b", expr):
            if tok in self.pending:
                self.pos[tok] = len(self.lines)
                self.lines.append(self.pending.pop(tok))

    def stmt(self, text):
        self._use(text)
        self.lines.append(text)

    def var(self, dtype, expr, load=False):
        name = f"v{self.n}"
        self.n += 1
        text = f"const {_CTYPE[np.dtype(dtype)]} {name} = {expr};"
        if load:
            self.pending[name] = text
        else:
            self._use(expr)
            self.pos[name] = len(self.lines)
            self.lines.append(text)
        return name

    def store(self, target, value):
        """``target = value;`` placed right after ``value`` is defined."""
        self._use(value)
        self.stores.append((self.pos.get(value, -1), f"{target} = {value};"))

    # values -------------------------------------------------------------
    def lift_const(self, x):
        """A concrete array captured by the jaxpr -> entry object array."""
        x = np.asarray(x)
        if x.ndim == 0:
            return np.full((), x[()], dtype=object)
        if x.shape[-1] not in (1, self.lane) or not np.all(x == x[..., :1]):
            raise NotImplementedError(
                f"captured constant of shape {x.shape} varies along the lanes")
        out = np.empty(x.shape[:-1], dtype=object)
        for idx in np.ndindex(out.shape):
            out[idx] = x[idx + (0,)]
        return out

    def _check(self, aval):
        if aval.ndim and aval.shape[-1] not in (1, self.lane):
            raise NotImplementedError(
                f"value of shape {aval.shape}: the trailing axis must be the "
                f"lane axis (size {self.lane} or 1)")

    # elementwise ---------------------------------------------------------
    def _elementwise(self, prim, params, dt, in_dts, e):
        if all(_const(x) for x in e):
            if prim is lax.select_n_p:
                return e[1 + int(e[0])]
            if prim is lax.convert_element_type_p:
                return _as_np(e[0], dt)
            if prim is lax.integer_pow_p:
                return _as_np(e[0] ** params["y"], dt)
            if prim in _NP_FOLD:
                with np.errstate(all="ignore"):
                    return _as_np(_NP_FOLD[prim](*e), dt)
        folded = self._fold(prim, dt, in_dts, e)
        if folded is not None:
            return folded
        return self._emit(prim, params, dt, in_dts, e)

    def _fold(self, prim, dt, in_dts, e):
        """Identities that hold for finite values."""
        if prim is lax.add_p:
            if _is(e[0], 0):
                return e[1]
            if _is(e[1], 0):
                return e[0]
        elif prim is lax.sub_p:
            if _is(e[1], 0):
                return e[0]
            if _is(e[0], 0):
                return self._emit(lax.neg_p, {}, dt, in_dts[1:], e[1:])
        elif prim is lax.mul_p:
            if _is(e[0], 0) or _is(e[1], 0):
                return _as_np(0, dt)
            if _is(e[0], 1):
                return e[1]
            if _is(e[1], 1):
                return e[0]
        elif prim is lax.div_p:
            if _is(e[1], 1):
                return e[0]
        elif prim is lax.select_n_p:
            if _const(e[0]):
                return e[1 + int(e[0])]
            if all(_const(c) for c in e[1:]) and all(
                    c == e[1] for c in e[2:]):
                return e[1]
        elif prim is lax.convert_element_type_p:
            if not _const(e[0]) and in_dts[0] == np.dtype(dt):
                return e[0]
        elif prim in (lax.and_p, lax.or_p) and np.dtype(dt) == np.bool_:
            absorb = prim is lax.or_p
            for a, b in ((e[0], e[1]), (e[1], e[0])):
                if _const(a):
                    return np.bool_(absorb) if bool(a) == absorb else b
        return None

    def _emit(self, prim, params, dt, in_dts, e):
        a = [_lit(x, d) if _const(x) else x for x, d in zip(e, in_dts)]
        if prim in _BINOP:
            return self.var(dt, f"{a[0]} {_BINOP[prim]} {a[1]}")
        if prim in _UNFN:
            return self.var(dt, f"{_f(_UNFN[prim], dt)}({a[0]})")
        if prim in _BINFN:
            return self.var(dt, f"{_f(_BINFN[prim], dt)}({a[0]}, {a[1]})")
        if prim is lax.neg_p:
            return self.var(dt, f"-{a[0]}")
        if prim is lax.square_p:
            return self.var(dt, f"{a[0]} * {a[0]}")
        if prim is lax.rsqrt_p:
            return self.var(dt, f"{_lit(1, dt)} / {_f('sqrtf', dt)}({a[0]})")
        if prim is lax.sign_p:
            return self.var(dt, f"jsign({a[0]})")
        if prim is lax.is_finite_p:
            return self.var(dt, f"isfinite({a[0]})")
        if prim is lax.convert_element_type_p:
            return self.var(dt, f"({_CTYPE[np.dtype(dt)]}){a[0]}")
        if prim is lax.clamp_p:
            return self.var(dt, f"jmin(jmax({a[1]}, {a[0]}), {a[2]})")
        if prim is lax.integer_pow_p:
            # binary powering, as JAX lowers integer_pow
            y, x, acc = params["y"], a[0], None
            recip = y < 0
            y = abs(y)
            while y > 0:
                if y & 1:
                    acc = x if acc is None else self.var(dt, f"{acc} * {x}")
                y >>= 1
                if y > 0:
                    x = self.var(dt, f"{x} * {x}")
            if acc is None:
                return _as_np(1, dt)
            return self.var(dt, f"{_lit(1, dt)} / {acc}") if recip else acc
        if prim is lax.select_n_p:
            if len(a) != 3:
                raise NotImplementedError("select_n with more than 2 cases")
            return self.var(dt, f"{a[0]} ? {a[2]} : {a[1]}")
        logical = np.dtype(dt) == np.bool_
        if prim is lax.not_p:
            return self.var(dt, f"{'!' if logical else '~'}{a[0]}")
        op = {lax.and_p: "&&" if logical else "&",
              lax.or_p: "||" if logical else "|", lax.xor_p: "^"}[prim]
        return self.var(dt, f"{a[0]} {op} {a[1]}")

    # structural ----------------------------------------------------------
    def _structural(self, eqn, ins):
        prim, p = eqn.primitive, eqn.params
        in_avals = [v.aval for v in eqn.invars]
        out_aval = eqn.outvars[0].aval
        if prim is lax.broadcast_in_dim_p:
            x, = ins
            lead = out_aval.shape[:-1]
            if in_avals[0].ndim == 0:
                return np.broadcast_to(x, lead)
            bd = p["broadcast_dimensions"]
            if bd[-1] != out_aval.ndim - 1:
                raise NotImplementedError("broadcast moves the lane axis")
            shape = [1] * len(lead)
            for d_in, d_out in enumerate(bd[:-1]):
                shape[d_out] = in_avals[0].shape[d_in]
            return np.broadcast_to(x.reshape(shape), lead)
        if prim is lax.reshape_p:
            x, = ins
            if in_avals[0].ndim == 0:
                return np.broadcast_to(x, out_aval.shape[:-1])
            if in_avals[0].shape[-1] != out_aval.shape[-1]:
                raise NotImplementedError("reshape across the lane axis")
            return x.reshape(out_aval.shape[:-1])
        if prim is lax.squeeze_p:
            x, = ins
            if in_avals[0].ndim - 1 in p["dimensions"]:
                raise NotImplementedError("squeeze of the lane axis")
            return x.reshape(out_aval.shape[:-1])
        if prim is lax.slice_p:
            x, = ins
            st = p["strides"] or (1,) * in_avals[0].ndim
            if (p["start_indices"][-1], p["limit_indices"][-1], st[-1]) != (
                    0, in_avals[0].shape[-1], 1):
                raise NotImplementedError("slice of the lane axis")
            return x[tuple(slice(a, b, s) for a, b, s in zip(
                p["start_indices"][:-1], p["limit_indices"][:-1], st[:-1]))]
        if prim is lax.concatenate_p:
            if p["dimension"] == out_aval.ndim - 1:
                raise NotImplementedError("concatenate along the lane axis")
            return np.concatenate(ins, axis=p["dimension"])
        if prim is lax.transpose_p:
            x, = ins
            perm = p["permutation"]
            if perm[-1] != len(perm) - 1:
                raise NotImplementedError("transpose moves the lane axis")
            return np.transpose(x, perm[:-1])
        if prim is lax.iota_p:
            if p["dimension"] == out_aval.ndim - 1:
                raise NotImplementedError("iota along the lane axis")
            out = np.empty(out_aval.shape[:-1], dtype=object)
            for idx in np.ndindex(out.shape):
                out[idx] = _as_np(idx[p["dimension"]], p["dtype"])
            return out
        if prim in (lax.reduce_sum_p, lax.reduce_max_p, lax.reduce_min_p):
            x, = ins
            axes = tuple(p["axes"])
            if in_avals[0].ndim - 1 in axes:
                raise NotImplementedError("reduction over the lane axis")
            op = {lax.reduce_sum_p: lax.add_p, lax.reduce_max_p: lax.max_p,
                  lax.reduce_min_p: lax.min_p}[prim]
            keep = [a for a in range(x.ndim) if a not in axes]
            xt = np.transpose(x, keep + list(axes))
            xt = xt.reshape(xt.shape[:len(keep)] + (-1,))
            dt = np.dtype(out_aval.dtype)
            out = np.empty(xt.shape[:-1], dtype=object)
            for idx in np.ndindex(out.shape):
                acc = xt[idx + (0,)]
                for e in xt[idx][1:]:
                    acc = self._elementwise(op, {}, dt, (dt, dt), [acc, e])
                out[idx] = acc
            return out
        if prim.name in ("copy", "copy_p", "optimization_barrier"):
            return ins if len(ins) > 1 else ins[0]
        raise NotImplementedError(f"no entry-wise rule for {prim}")

    # driver --------------------------------------------------------------
    def eval(self, closed, *args):
        env = {}

        def read(v):
            if isinstance(v, jex_core.Literal):
                return np.full((), _as_np(v.val, v.aval.dtype), dtype=object)
            return env[v]

        for v, c in zip(closed.jaxpr.constvars, closed.consts):
            env[v] = self.lift_const(c)
        for v, a in zip(closed.jaxpr.invars, args):
            env[v] = a
        for eqn in closed.jaxpr.eqns:
            ins = [read(v) for v in eqn.invars]
            for v in eqn.outvars:
                self._check(v.aval)
            sub = next((eqn.params[k] for k in _CALLS if k in eqn.params),
                       None)
            if eqn.primitive in _ELEMENTWISE:
                out_aval = eqn.outvars[0].aval
                in_dts = [np.dtype(v.aval.dtype) for v in eqn.invars]
                lead = out_aval.shape[:-1] if out_aval.ndim else ()
                bins = [np.broadcast_to(x, lead) for x in ins]
                out = np.empty(lead, dtype=object)
                for idx in np.ndindex(lead):
                    out[idx] = self._elementwise(
                        eqn.primitive, eqn.params, np.dtype(out_aval.dtype),
                        in_dts, [b[idx] for b in bins])
                outs = [out]
            elif sub is not None:
                if not isinstance(sub, jex_core.ClosedJaxpr):
                    sub = jex_core.ClosedJaxpr(sub, ())
                outs = self.eval(sub, *ins)
            else:
                outs = self._structural(eqn, ins)
                outs = list(outs) if eqn.primitive.multiple_results \
                    else [outs]
            for v, o in zip(eqn.outvars, outs):
                env[v] = o
        return [read(v) for v in closed.jaxpr.outvars]


# -- source generation --------------------------------------------------------

def _trace(step, init, consts, xs, lane):
    """Jaxprs of ``init`` and ``step`` at lane width ``lane``."""
    c_leaves, c_tree = jax.tree.flatten(consts)
    x_leaves, x_tree = jax.tree.flatten(xs)
    c_av = [jax.ShapeDtypeStruct(x.shape[:-1] + (lane,), x.dtype)
            for x in c_leaves]
    x_av = [jax.ShapeDtypeStruct(x.shape[1:-1] + (lane,), x.dtype)
            for x in x_leaves]

    def init_flat(*c):
        return init(jax.tree.unflatten(c_tree, c))

    init_jaxpr, (carry_sh, aux_sh) = jax.make_jaxpr(
        init_flat, return_shape=True)(*c_av)
    carry_av, carry_tree = jax.tree.flatten(carry_sh)
    nc, ncar = len(c_av), len(carry_av)

    def step_flat(*a):
        c = jax.tree.unflatten(c_tree, a[:nc])
        car = jax.tree.unflatten(carry_tree, a[nc:nc + ncar])
        x = jax.tree.unflatten(x_tree, a[nc + ncar:])
        return step(c, car, x)

    step_jaxpr, (carry_sh2, y_sh) = jax.make_jaxpr(
        step_flat, return_shape=True)(*c_av, *carry_av, *x_av)
    if jax.tree.structure(carry_sh2) != carry_tree:
        raise ValueError("step changes the carry's structure")
    return init_jaxpr, step_jaxpr, c_av, x_av, carry_av, aux_sh, y_sh


def kernel_source(name, step, init, consts, xs, *, reverse=False):
    """C++/CUDA source of the recursion kernel (module docstring).
    Returns (source, y_avals, aux_avals, (y_tree, aux_tree)); the avals
    have lane width 1 in place of B."""
    lane = 128  # any width other than 1 marks the lane axis when tracing
    init_jaxpr, step_jaxpr, c_av, x_av, carry_av, aux_sh, y_sh = _trace(
        step, init, consts, xs, lane)
    aux_av, aux_tree = jax.tree.flatten(aux_sh)
    y_av, y_tree = jax.tree.flatten(y_sh)
    nc, ncar = len(c_av), len(carry_av)
    cg = _Codegen(lane)
    ct = lambda a: _CTYPE[np.dtype(a.dtype)]

    def index(R, r, stage):
        return (f"((size_t)t * {R} + {r}) * B + b" if stage
                else f"(size_t){r} * B + b")

    def load(k, aval, stage):
        out = np.empty(aval.shape[:-1], dtype=object)
        R = int(np.prod(out.shape, dtype=np.int64))
        for r, idx in enumerate(np.ndindex(out.shape)):
            out[idx] = cg.var(aval.dtype, f"{k}[{index(R, r, stage)}]",
                              load=True)
        return out

    def store(k, aval, vals, stage):
        R = int(np.prod(vals.shape, dtype=np.int64))
        for r, idx in enumerate(np.ndindex(vals.shape)):
            v = vals[idx]
            v = f"({ct(aval)}){_lit(v, aval.dtype)}" if _const(v) else v
            cg.store(f"{k}[{index(R, r, stage)}]", v)

    # init: consts -> carry registers and aux outputs
    outs = cg.eval(init_jaxpr,
                   *[load(f"c{i}", a, False) for i, a in enumerate(c_av)])
    for i, (a, o) in enumerate(zip(aux_av, outs[ncar:])):
        store(f"a{i}", a, np.asarray(o, dtype=object), False)
    carry_names = []
    for i, (a, o) in enumerate(zip(carry_av, outs[:ncar])):
        names = np.empty(o.shape, dtype=object)
        for j, idx in enumerate(np.ndindex(o.shape)):
            v = o[idx]
            names[idx] = f"s{i}_{j}"
            cg.stmt(f"{ct(a)} {names[idx]} = "
                    f"{_lit(v, a.dtype) if _const(v) else v};")
        carry_names.append(names)
    head = cg.section()
    # one stage (constants are re-read from cache, not held across stages)
    outs = cg.eval(step_jaxpr,
                   *[load(f"c{i}", a, False) for i, a in enumerate(c_av)],
                   *carry_names,
                   *[load(f"x{i}", a, True) for i, a in enumerate(x_av)])
    for i, (a, o) in enumerate(zip(y_av, outs[ncar:])):
        store(f"y{i}", a, o, True)
    new = []
    for names, a, o in zip(carry_names, carry_av, outs[:ncar]):
        for idx in np.ndindex(o.shape):
            v = o[idx]
            new.append((names[idx], _lit(v, a.dtype) if _const(v) else v))
    # two phases, so a carry entry feeding another is read before written
    for j, (_, v) in enumerate(new):
        cg.stmt(f"const auto n{j} = {v};")
    for j, (nm, _) in enumerate(new):
        cg.stmt(f"{nm} = n{j};")
    body = cg.section()

    def ptr(k, a, const):
        return f"{'const ' if const else ''}{ct(a)}* __restrict__ {k}"

    ins = [(f"c{i}", a) for i, a in enumerate(c_av)] + \
        [(f"x{i}", a) for i, a in enumerate(x_av)]
    outs_ = [(f"y{i}", a) for i, a in enumerate(y_av)] + \
        [(f"a{i}", a) for i, a in enumerate(aux_av)]
    params = ", ".join([ptr(k, a, True) for k, a in ins]
                       + [ptr(k, a, False) for k, a in outs_])
    args = ", ".join(k for k, _ in ins + outs_)
    bufs = ", ".join(
        [f"static_cast<const {ct(a)}*>(in{i}.untyped_data())"
         for i, (_, a) in enumerate(ins)]
        + [f"static_cast<{ct(a)}*>(out{i}->untyped_data())"
           for i, (_, a) in enumerate(outs_)])
    handler_args = ", ".join(
        [f"ffi::AnyBuffer in{i}" for i in range(len(ins))]
        + [f"ffi::Result<ffi::AnyBuffer> out{i}" for i in range(len(outs_))])
    src = [
        _PRELUDE,
        f"LW_FN void {name}_lane(long long b, long long B, long long N, "
        f"{params}) {{",
        *("  " + ln for ln in head),
        "  for (long long i = 0; i < N; ++i) {",
        f"    const long long t = {'N - 1 - i' if reverse else 'i'};",
        *("    " + ln for ln in body),
        "  }",
        "}",
        "#ifdef __CUDACC__",
        f"__global__ void __launch_bounds__({BLOCK}) {name}_kernel("
        f"long long B, long long N, {params}) {{",
        "  const long long b = (long long)blockIdx.x * blockDim.x"
        " + threadIdx.x;",
        f"  if (b < B) {name}_lane(b, B, N, {args});",
        "}",
        "#endif",
        f"static ffi::Error {name}_impl(",
        "#ifdef __CUDACC__",
        "    cudaStream_t stream,",
        "#endif",
        f"    int64_t B, int64_t N, {handler_args}) {{",
        "#ifdef __CUDACC__",
        f"  {name}_kernel<<<(unsigned)((B + {BLOCK - 1}) / {BLOCK}), "
        f"{BLOCK}, 0, stream>>>(B, N, {bufs});",
        "  cudaError_t err = cudaGetLastError();",
        "  if (err != cudaSuccess)",
        "    return ffi::Error::Internal(cudaGetErrorString(err));",
        "#else",
        f"  for (long long b = 0; b < B; ++b) {name}_lane(b, B, N, {bufs});",
        "#endif",
        "  return ffi::Error::Success();",
        "}",
        f"XLA_FFI_DEFINE_HANDLER_SYMBOL({name}, {name}_impl,",
        "  ffi::Ffi::Bind()",
        "#ifdef __CUDACC__",
        "    .Ctx<ffi::PlatformStream<cudaStream_t>>()",
        "#endif",
        '    .Attr<int64_t>("lanes").Attr<int64_t>("stages")',
        *(["    .Arg<ffi::AnyBuffer>()"] * len(ins)),
        *(["    .Ret<ffi::AnyBuffer>()"] * len(outs_)),
        ");",
        ""]
    return "\n".join(src), y_av, aux_av, (y_tree, aux_tree)


# -- build, register, call ----------------------------------------------------

_REGISTERED = {}


def _compile_cmd(platform, src, out):
    inc = jax.ffi.include_dir()
    if platform == "cuda":
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-I", inc, "-o", out, src]
    return [os.environ.get("CXX", "g++"), "-std=c++17", "-O2",
            "-ffp-contract=off", "-shared", "-fPIC", "-I", inc, "-o", out,
            src]


def build(name, src, platform):
    """Compile ``src`` into a shared library (cached by content hash under
    BUILD_DIR) and register its FFI handler; returns the target name."""
    target = f"{name}_{hashlib.sha256((platform + src).encode()).hexdigest()[:16]}"
    if target in _REGISTERED:
        return target
    src = src.replace(f" {name}_", f" {target}_").replace(
        f"({name},", f"({target},")
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"{target}.so")
    if not os.path.exists(lib):
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            path = os.path.join(tmp, target + (".cu" if platform == "cuda"
                                               else ".cc"))
            with open(path, "w") as f:
                f.write(src)
            out = os.path.join(tmp, target + ".so")
            res = subprocess.run(_compile_cmd(platform, path, out),
                                 capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"building {target} failed:\n"
                                   + res.stderr[-4000:])
            os.replace(path, os.path.join(BUILD_DIR, os.path.basename(path)))
            os.replace(out, lib)   # atomic: concurrent builders agree
    handle = ctypes.cdll.LoadLibrary(lib)
    jax.ffi.register_ffi_target(
        target, jax.ffi.pycapsule(getattr(handle, target)),
        platform="CUDA" if platform == "cuda" else "cpu")
    _REGISTERED[target] = handle
    return target


def lane_scan(step, init, consts, xs, *, reverse=False, kernel=False):
    """Run a lane-batched stage recursion (module docstring).

    ``consts``: pytree of (..., B) arrays, the same at every stage;
    ``xs``: pytree of (N, ..., B) per-stage inputs;
    ``init(consts) -> (carry, aux)`` and
    ``step(consts, carry, x_t) -> (carry, y_t)`` on lane-layout values.
    Returns ``(ys, aux)``: ys stacked (N, ..., B), aux as ``init`` made it.

    ``kernel``: run the recursion as one generated kernel (CUDA on the
    GPU, a host build on the CPU) instead of a `lax.scan`; the kernel is
    named after the step function."""
    c_leaves = jax.tree.leaves(consts)
    x_leaves = jax.tree.leaves(xs)
    B = (c_leaves or x_leaves)[0].shape[-1]
    for x in c_leaves + x_leaves:
        if x.shape[-1] != B:
            raise ValueError(f"lane axis {x.shape[-1]} != batch {B}")
    if not kernel:
        carry, aux = init(consts)
        _, ys = lax.scan(lambda c, x: step(consts, c, x), carry, xs,
                         reverse=reverse)
        return ys, aux
    N = x_leaves[0].shape[0]
    name = getattr(getattr(step, "func", step), "__name__", "scan")
    src, y_av, aux_av, (y_tree, aux_tree) = kernel_source(
        name, step, init, consts, xs, reverse=reverse)
    target = build(name, src, kernel_platform())
    out_types = ([jax.ShapeDtypeStruct((N,) + a.shape[:-1] + (B,), a.dtype)
                  for a in y_av]
                 + [jax.ShapeDtypeStruct(a.shape[:-1] + (B,), a.dtype)
                    for a in aux_av])
    outs = jax.ffi.ffi_call(target, out_types)(
        *c_leaves, *x_leaves, lanes=np.int64(B), stages=np.int64(N))
    ny = len(y_av)
    return (jax.tree.unflatten(y_tree, outs[:ny]),
            jax.tree.unflatten(aux_tree, outs[ny:]))
