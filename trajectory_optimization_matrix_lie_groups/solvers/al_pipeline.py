"""Input-box constrained solves on the lane-layout pipeline.

`ALFastSolver` runs the augmented-Lagrangian outer loop around the generic
`FastBatchSolver`; this module runs the same outer loop around
`PipelineSolver` — constrained MPC at the headline pipeline
throughput.  The AL terms enter the pipeline cheaply: the u-gradient
additions ride the `lu` XLA glue already computed between the two stage
recursions, and the penalty's diagonal Quu addition is one extra per-stage
input of the Riccati recursion (`solvers/pipeline.py::backward_step`).

Iterate-for-iterate identical to `ALFastSolver` with the same inner budget
(tests/test_al_pipeline.py): multipliers are per problem, inner solves
restart from the caller's ``us0`` each outer iteration (ref
traopt_controller.py:3237), and the update is the reference's first-order
ascent + active-set penalty rebuild (traopt_controller.py:3270-3290) with a
diagonal-Imu representation.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from trajectory_optimization_matrix_lie_groups.models.costs import (
    al_update_diag,
)
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    PipelineSolver,
)


class ALPipelineResult(NamedTuple):
    qs: jnp.ndarray           # (B, N+1, 4, 4)
    xis: jnp.ndarray          # (B, N+1, 6)
    us: jnp.ndarray           # (B, N, nu)
    J_opt: jnp.ndarray        # (B,) augmented cost at last linearization
    lmbd: jnp.ndarray         # (B, N+1, 2nu) final multipliers
    max_violation: jnp.ndarray  # (B,)
    outer_iterations: int
    constr_converged: bool
    imu: jnp.ndarray = None   # (B, N+1, 2nu) final active-set penalties —
    #   with lmbd, the fixed-multiplier state a DF polish needs
    #   (MixedDFPipelineSolver.solve(..., al=(lb, ub, lmbd, imu)))


class ALPipelineSolver:
    """AL outer loop around a PipelineSolver (input box lb <= u <= ub)."""

    def __init__(self, pipe: PipelineSolver, lb, ub,
                 mu0=1e-2, mu_scale=10.0, mu_max=1e8, tol_constr=1e-2):
        self.pipe = pipe
        # scalar or (nu,); broadcast at solve time when nu is known
        self.lb = np.asarray(lb, np.float64)
        self.ub = np.asarray(ub, np.float64)
        self.mu0 = mu0
        self.mu_scale = mu_scale
        self.mu_max = mu_max
        self.tol_constr = tol_constr

    def _violation(self, us):
        lb = np.broadcast_to(self.lb, (us.shape[-1],))
        ub = np.broadcast_to(self.ub, (us.shape[-1],))
        glo = lb[None, None] - us
        ghi = us - ub[None, None]
        g = jnp.concatenate([glo, ghi], axis=-1)  # (B, N, 2nu)
        # terminal g = 0 (models/constraints.py:38) -> max is >= 0
        return jnp.maximum(jnp.max(g, axis=(1, 2)), 0.0), g

    def _warm_pipe(self, warm_iters):
        """A clone of the inner pipeline with a shorter iteration budget
        for warm-started outers (compiled separately; persistent-cached)."""
        if getattr(self, "_warm", None) is None or \
                self._warm.iterations != warm_iters:
            p = self.pipe
            self._warm = PipelineSolver(
                N=p.N, iterations=warm_iters, dt=p.dt, gravity=p.gravity,
                exact_gravity_jacobian=p.exact_grav, kernels=p.kernels)
        return self._warm

    def solve(self, dyn, cost, q0s, xi0s, us0, n_al_iters=10,
              warm_start=False, warm_iters=4):
        """``warm_start``: opt-in perf mode — outer iterations after the
        first start the inner solve from the previous outer's solution
        with a ``warm_iters`` inner budget, instead of the reference's
        restart-from-``us0`` full budget (traopt_controller.py:3237):
        fewer inner iterations per outer.  Caveat: under
        near-flat input directions (R ~ 1e-5 with a wide box) the
        constrained problem is degenerate, and the warm path settles on a
        DIFFERENT near-optimal control sequence than the cold path
        (augmented cost within ~2%); use the default cold mode when
        reference-trajectory reproducibility matters."""
        if n_al_iters < 1:
            raise ValueError("n_al_iters must be >= 1")
        B, N = us0.shape[0], us0.shape[1]
        nu = us0.shape[-1]
        C = 2 * nu
        lb = jnp.broadcast_to(jnp.asarray(self.lb), (nu,))
        ub = jnp.broadcast_to(jnp.asarray(self.ub), (nu,))
        lmbd = jnp.zeros((B, N + 1, C))
        imu = jnp.full((B, N + 1, C), self.mu0)
        mu = jnp.full((B,), self.mu0)
        st = None
        maxv = None
        converged = False
        outer = 0
        us_in = us0
        for outer in range(n_al_iters):
            pipe = self.pipe if (outer == 0 or not warm_start) \
                else self._warm_pipe(warm_iters)
            st = pipe.solve(dyn, cost, q0s, xi0s, us_in,
                            al=(lb, ub, lmbd, imu))
            if warm_start:
                us_in = st.us
            maxv, g_stage = self._violation(st.us)
            converged = bool(np.max(np.asarray(maxv)) < self.tol_constr)
            if converged:
                break
            # first-order ascent + active-set rebuild with per-problem
            # freeze; terminal g = 0 appended (costs.al_update_diag)
            g = jnp.concatenate(
                [g_stage, jnp.zeros((B, 1, C), g_stage.dtype)], axis=1)
            lmbd, imu, mu = al_update_diag(
                lmbd, imu, mu, g, self.mu_scale, self.mu_max,
                freeze=maxv < self.tol_constr)
        return ALPipelineResult(
            qs=st.qs, xis=st.xis, us=st.us, J_opt=st.J_opt, lmbd=lmbd,
            max_violation=maxv, outer_iterations=outer + 1,
            constr_converged=converged, imu=imu,
        )


def al_polish(mx, params64, lb, ub, res, q0s, xi0s, n_outers=2,
              mu_scale=10.0, mu_max=1e8, timings=None):
    """Double-f32 refinement of a constrained (input-box) solve.

    ``mx`` is a `MixedDFPipelineSolver` — give it the FULL f32 iteration
    budget of the f32 AL inner (the polish rebuilds its trajectory from
    the reference tail, so its f32 phase must re-close the multiple-
    shooting defects on its own; a short budget stalls the inner at
    grad ~4e-3, measured).  ``params64`` is the float64 host params;
    ``res`` an `ALPipelineResult` (or anything with .us/.lmbd/.imu)
    from the f32 AL outer loop.  Each outer runs the mixed-precision
    polish on the AUGMENTED Lagrangian at fixed (lmbd, imu) — measured to
    land on the f64 inner optimum to ~4e-10 (tests/test_al_pipeline.py) —
    then first-order dual ascent in float64 on the host
    (`costs.al_update_diag` semantics).  The f32 loop converges
    FEASIBILITY (violation < tol) but leaves the duals only
    ascent-accurate, which caps the primal at ~1e-3 of the true
    constrained optimum; a couple of DF outers close that dual gap.

    Per-lane feasibility fallback: a lane whose f32 duals are NOT
    ascent-converged can make the augmented problem unbounded-ish in box
    directions (with R ~ 0 and near-zero imu rows the polish may leave
    the box entirely — observed |u| 10x the bound on hard perturbed
    lanes); any lane whose polished max violation exceeds the f32
    solution's (beyond float slack) keeps the f32 controls instead.

    Returns (us_f64 (B, N, nu), out: DFState, lmbd, imu) — the polished
    controls in float64 (fallback applied) and the final polish
    state/multipliers.

    ``timings``: optional dict — filled with per-phase walls:
    ``solve_s`` (list, device mx.solve per outer), ``readback_s`` (list,
    full us hi+lo host materialization per outer), ``host_s`` (list,
    float64 dual ascent + re-upload prep per outer).
    """
    import time as _time
    if n_outers < 1:
        raise ValueError("n_outers must be >= 1")
    if res.imu is None:
        raise ValueError(
            "res.imu is None: al_polish needs the active-set penalties from "
            "an ALPipelineSolver.solve result (imu field); results built "
            "without it cannot seed the fixed-multiplier DF inner")
    nu = np.shape(res.us)[-1]
    lbv = np.broadcast_to(np.asarray(lb, np.float64), (nu,))
    ubv = np.broadcast_to(np.asarray(ub, np.float64), (nu,))
    lam = np.asarray(res.lmbd, np.float64)        # (B, N+1, 2nu)
    imu = np.asarray(res.imu, np.float64)
    mu = np.full(lam.shape[0], float(np.max(imu)))
    us_warm = jnp.asarray(np.asarray(res.us), jnp.float32)
    out = None
    if timings is not None:
        timings.update(solve_s=[], readback_s=[], host_s=[])
    for _ in range(n_outers):
        t0 = _time.perf_counter()
        out = mx.solve(params64, q0s, xi0s, us_warm,
                       al=(lbv, ubv, lam.astype(np.float32),
                           imu.astype(np.float32)))
        if timings is not None:
            # barrier on a small slice (CLAUDE.md: block_until_ready can
            # resolve early; the full copy masks compute time)
            _ = np.asarray(out.us_hi[:, 0, :])
            timings["solve_s"].append(_time.perf_counter() - t0)
            t0 = _time.perf_counter()
        us64 = (np.asarray(out.us_hi, np.float64)
                + np.asarray(out.us_lo, np.float64))
        if timings is not None:
            timings["readback_s"].append(_time.perf_counter() - t0)
            t0 = _time.perf_counter()
        glo = lbv[None, None] - us64
        ghi = us64 - ubv[None, None]
        g = np.concatenate([glo, ghi], axis=-1)   # (B, N, 2nu)
        g = np.concatenate([g, np.zeros_like(g[:, :1])], axis=1)
        # pure-numpy float64 dual update (al_update_diag semantics; numpy
        # so a process without x64 cannot silently degrade it to f32)
        lam = np.clip(lam + imu * g, 0.0, None)
        mu = np.minimum(mu * mu_scale, mu_max)
        imu = np.where((g < 0.0) & (lam == 0.0), 0.0,
                       mu[:, None, None])
        us_warm = jnp.asarray(us64, jnp.float32)
        if timings is not None:
            timings["host_s"].append(_time.perf_counter() - t0)

    viol = lambda u: np.maximum(
        np.maximum(lbv[None, None] - u, u - ubv[None, None]).max(
            axis=(1, 2)), 0.0)
    us_f32_64 = np.asarray(res.us, np.float64)
    bad = viol(us64) > viol(us_f32_64) + 1e-5
    us64 = np.where(bad[:, None, None], us_f32_64, us64)
    return us64, out, lam, imu


def al_polish_device(mx, params64, lb, ub, res, q0s, xi0s, n_outers=2,
                     mu_scale=10.0, mu_max=1e8):
    """`al_polish` with the dual ascent ON DEVICE — no per-outer host
    readback.

    The host variant pays a full-us readback and a host numpy dual ascent
    per outer.  Here the multipliers stay f32 on device and the ascent runs jitted between the polish solves:

      - box residuals from the DF iterate as exact f32 compensated sums —
        near a rail `us_hi - ub` is exact (Sterbenz) and `+ us_lo` carries
        the DF tail, so g is f32-rounding-accurate however tiny;
      - lam = clip(lam + imu g, 0): f32 with ~6e-8 relative error — the
        same grade the polish solves already assume (`MixedDFPipelineSolver`
        treats multipliers as exact-at-f32 parameters);
      - the per-lane feasibility fallback (al_polish docstring) also runs
        on device.

    Returns (out: DFState with the fallback applied to us_hi/us_lo,
    lam (B, N+1, 2nu) f32 device, imu f32 device).  Join
    `out.us_hi/us_lo` on the host only when full controls are needed —
    that readback is the host variant's dominant cost.
    """
    if n_outers < 1:
        raise ValueError("n_outers must be >= 1")
    if res.imu is None:
        raise ValueError("res.imu is None: al_polish_device needs the "
                         "active-set penalties (see al_polish)")
    nu = np.shape(res.us)[-1]
    lbv = jnp.asarray(np.broadcast_to(np.asarray(lb, np.float32), (nu,)))
    ubv = jnp.asarray(np.broadcast_to(np.asarray(ub, np.float32), (nu,)))
    lam = jnp.asarray(res.lmbd, jnp.float32)      # (B, N+1, 2nu)
    imu = jnp.asarray(res.imu, jnp.float32)
    mu0 = jnp.max(imu)                            # scalar, stays on device
    us_warm = jnp.asarray(res.us, jnp.float32)

    mu = mu0
    out = None
    for _ in range(n_outers):
        out = mx.solve(params64, q0s, xi0s, us_warm,
                       al=(lbv, ubv, lam, imu))
        lam, imu, mu = _dual_update(out.us_hi, out.us_lo, lam, imu, mu,
                                    lbv, ubv, float(mu_scale),
                                    float(mu_max))
        us_warm = out.us_hi
    us_hi, us_lo = _dual_fallback(out.us_hi, out.us_lo,
                                  jnp.asarray(res.us, jnp.float32),
                                  lbv, ubv)
    return out._replace(us_hi=us_hi, us_lo=us_lo), lam, imu


# module-level jits so repeated al_polish_device calls reuse the compiled
# dual-ascent/fallback programs (a closure-captured @jax.jit would retrace
# on every call)
@functools.partial(jax.jit, static_argnums=(7, 8))
def _dual_update(us_hi, us_lo, lam, imu, mu, lbv, ubv, mu_scale, mu_max):
    glo = (lbv[None, None] - us_hi) - us_lo
    ghi = (us_hi - ubv[None, None]) + us_lo
    g = jnp.concatenate([glo, ghi], axis=-1)          # (B, N, 2nu)
    g = jnp.concatenate([g, jnp.zeros_like(g[:, :1])], axis=1)
    lam_n = jnp.clip(lam + imu * g, 0.0, None)
    mu_n = jnp.minimum(mu * jnp.float32(mu_scale), jnp.float32(mu_max))
    imu_n = jnp.where((g < 0.0) & (lam_n == 0.0), 0.0, mu_n)
    return lam_n, imu_n, mu_n


@jax.jit
def _dual_fallback(us_hi, us_lo, us_f32, lbv, ubv):
    vio = lambda u: jnp.maximum(jnp.max(jnp.maximum(
        lbv[None, None] - u, u - ubv[None, None]), axis=(1, 2)), 0.0)
    bad = vio(us_hi + us_lo) > vio(us_f32) + jnp.float32(1e-5)
    m = bad[:, None, None]
    return (jnp.where(m, us_f32, us_hi),
            jnp.where(m, jnp.zeros_like(us_lo), us_lo))
