"""Double-f32 MS-iLQR polish phase: lane-layout XLA on DF operands.

The f32 lane-layout pipeline (`solvers/pipeline.py`) converges to a ~1e-3
neighbourhood of the f64 fixed point: f32 rounding noise is amplified
~5e4x through the near-flat directions of the trajectory Hessian
(sigma_min(Quu) ~ 2R = 2e-5).  `solvers/polish.HighPrecisionSolver` reruns
two iterations in native f64 through the solver-layout XLA path.

This module runs the polish iterations in `ops/dfx.DF` double-f32
arithmetic (~49 mantissa bits) using the SAME lane-layout stage math as
the pipeline (`riccati_stage`, `rollout_stage`, `stage_*` from
ops/stage_linearize.py — all DF-polymorphic), expressed as plain XLA:

  - stage-parallel work (linearization + GN quadratization) folds the
    stage axis into the lane axis and evaluates ONE elementwise graph
    over (…, N*B) lanes;
  - the sequential recursions (Riccati backward, gap-closing rollout) are
    `lax.scan`s over stages whose bodies are the shared lane-layout stage
    functions on (…, B) lanes.

The DF stage bodies trace to 25k-60k primitives (every multiply is an
error-free transformation); lane-layout XLA fuses the elementwise chains
and needs no layout transposes.

Accuracy: iLQR is locally contractive, so 2-4 DF iterations re-converge
into the flat valley of the true optimum; the residual vs the f64 golden is
the genuine flat-direction indeterminacy (~5e-5 < the 1e-4 BASELINE gate).
The reference solver stack is float64 end-to-end
(main_SE3ddp_tracking_exact_ms.py:36); this reaches that precision policy
(SURVEY.md §7 hard part 5) at batch scale in f32 arithmetic.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from trajectory_optimization_matrix_lie_groups.ops import dfx
from trajectory_optimization_matrix_lie_groups.ops import lie_lane as ll
from trajectory_optimization_matrix_lie_groups.ops.stage_linearize import (
    stage_cost_quad,
    stage_dynamics_eval,
    stage_jacobian,
)
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    PipelineSolver,
    riccati_stage,
    rollout_stage,
)

__all__ = ["DFPipelineSolver", "DFState", "split_pytree", "join_us"]


# -- DF <-> pair helpers ------------------------------------------------------

def _pair(d):
    return (d.hi, d.lo)


def _df(p):
    return dfx.DF(p[0], p[1])


def _map_df(fn, d):
    return dfx.DF(fn(d.hi), fn(d.lo))


# -- host-side split helpers --------------------------------------------------

def _split_np(x):
    """f64 host array -> stacked (2, ...) f32 [hi, lo]."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return np.stack([hi, lo], axis=0)


def split_pytree(tree):
    """Split every float leaf of a host pytree into (2, ...) hi/lo stacks."""
    def leaf(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return _split_np(x)
        return x
    return jax.tree.map(leaf, tree)


def join_us(state):
    """Combine a DFState's packed controls into host float64 (B, N, nu)."""
    return (np.asarray(state.us_hi, np.float64)
            + np.asarray(state.us_lo, np.float64))


class DFState(NamedTuple):
    qs: jnp.ndarray      # (B, N+1, 4, 4) f32 (hi parts)
    xis: jnp.ndarray     # (B, N+1, 6)    f32 (hi parts)
    us_hi: jnp.ndarray   # (B, N, nu) f32
    us_lo: jnp.ndarray   # (B, N, nu) f32 compensation terms
    J_opt: jnp.ndarray   # (B,)
    grad_norm: jnp.ndarray  # (B,)


class DFPipelineSolver:
    """f32 pipeline + double-f32 lane-layout XLA polish.

    Parameters
    ----------
    N, dt : horizon and step (match the f32 pipeline).
    f32_iterations : ordinary fused-pipeline iterations (phase 1).
    df_iterations : double-f32 polish iterations warm-started from phase 1;
        2-4 suffice (module docstring).
    gravity, exact_gravity_jacobian : forwarded to the f32
        `PipelineSolver` phase.
    """

    def __init__(self, N: int, dt: float, f32_iterations: int = 12,
                 df_iterations: int = 3, gravity: bool = False,
                 exact_gravity_jacobian: bool = False, **pipeline_kw):
        """``pipeline_kw``: forwarded to the f32 `PipelineSolver`
        phase (``kernels``)."""
        self.N = N
        self.dt = float(dt)
        self.f32_iterations = f32_iterations
        self.df_iterations = df_iterations
        self.gravity = gravity
        self.exact_grav = exact_gravity_jacobian
        self.base = PipelineSolver(
            N=N, iterations=f32_iterations, dt=dt, gravity=gravity,
            exact_gravity_jacobian=exact_gravity_jacobian, **pipeline_kw)
        # two separate jits: XLA compile cost is superlinear in module size
        # for these graphs (the DF phase alone is ~100k primitives), so one
        # combined module compiles far slower than the sum of its phases
        self._f32_jit = jax.jit(self._solve_f32)
        self._df_jit = jax.jit(self._solve_df)

    # -- DF phase pieces (plain XLA, lane layout) --------------------------

    def _linearize_df(self, qR, qp, xi, us, refs, consts):
        """All-stage linearization: stage axis folded into the lanes.

        qR (N+1,3,3,B), qp (N+1,3,B), xi (N+1,6,B), us (N,nu,B) as DF;
        refs/consts as DF lane tensors.  Returns dict of DF (N, ..., B).
        """
        N = self.N
        B = us.hi.shape[-1]

        def fold(d, drop_last=0):
            # (N[+1], ..., B) -> (..., N*B); optionally drop the last stage
            def f(x):
                x = x[:N] if drop_last else x
                x = jnp.moveaxis(x, 0, -2)
                return x.reshape(x.shape[:-2] + (N * B,))
            return _map_df(f, d)

        def tile(d):
            # (..., B) const -> (..., N*B)
            def f(x):
                x = jnp.broadcast_to(x[..., None, :], x.shape[:-1] + (N, B))
                return x.reshape(x.shape[:-2] + (N * B,))
            return _map_df(f, d)

        def unfold(d):
            def f(x):
                x = x.reshape(x.shape[:-1] + (N, B))
                return jnp.moveaxis(x, -2, 0)
            return _map_df(f, d)

        R = fold(_map_df(lambda x: x[:-1], qR))
        p = fold(_map_df(lambda x: x[:-1], qp))
        Rn = fold(_map_df(lambda x: x[1:], qR))
        pn = fold(_map_df(lambda x: x[1:], qp))
        xis = fold(_map_df(lambda x: x[:-1], xi))
        xin = fold(_map_df(lambda x: x[1:], xi))
        u = fold(us)
        Jl, Jil = tile(consts["Jl"]), tile(consts["Jil"])
        W1, W2 = tile(consts["W1"]), tile(consts["W2"])
        Pu, mg = tile(consts["Pu"]), tile(consts["mg"])

        fqR, fqp, fxi = stage_dynamics_eval(
            R, p, xis, u, Jl, Jil, Pu, mg, dt=self.dt, gravity=self.gravity)
        Rni, pni = ll.se3_inverse(Rn, pn)
        Rd, pd = ll.se3_compose(Rni, pni, fqR, fqp)
        d = dfx.concatenate([ll.se3_log(Rd, pd), fxi - xin], axis=0)
        Fx = stage_jacobian(R, xis, Jl, Jil, mg, dt=self.dt,
                            gravity=self.gravity, exact_grav=self.exact_grav)
        lx, lxx, l_val = stage_cost_quad(
            R, p, xis, fold(refs["RbiR"]), fold(refs["Rbip"]),
            fold(refs["Adb"]), fold(refs["xib"]), W1, W2)

        out = dict(fqR=fqR, fqp=fqp, fxi=fxi, d=d, Fx=Fx, lx=lx, lxx=lxx,
                   l=_map_df(lambda x: x[None], l_val))
        return {k: unfold(v) for k, v in out.items()}

    def _backward_df(self, lin, lu, term, consts):
        """Reverse scan over stages; body = shared `riccati_stage`."""
        qRN, qpN, xiN, RbiRN, RbipN, AdbN, xibN, W1N, W2N = term
        lxN, lxxN, lN = stage_cost_quad(
            qRN, qpN, xiN, RbiRN, RbipN, AdbN, xibN, W1N, W2N)
        Fu = consts["Fu"]
        fu2 = Fu[6:]
        fu2T = ll.transpose(fu2)
        Luu = consts["Luu"]
        nu = lu.hi.shape[-2]

        def step(carry, inp):
            Vx, Vxx = _df(carry[0]), _df(carry[1])
            fx, dd, lx_t, lu_t, lxx_t = (_df(x) for x in inp)
            k, K, Qu, Vx_n, Vxx_n = riccati_stage(
                fx, dd, lx_t, lu_t, lxx_t, fu2, fu2T, Luu, Vx, Vxx,
                nu=nu, glow=self.gravity)
            return ((_pair(Vx_n), _pair(Vxx_n)),
                    (_pair(k), _pair(K), _pair(Qu)))

        xs = (_pair(lin["Fx"]), _pair(lin["d"]), _pair(lin["lx"]),
              _pair(lu), _pair(lin["lxx"]))
        (_, _), (k, K, gvec) = lax.scan(
            step, (_pair(lxN), _pair(lxxN)), xs, reverse=True)
        return _df(k), _df(K), _df(gvec), lN

    def _rollout_df(self, qR, qp, xi, us, k, K, lin, consts):
        """Forward scan: shared gap-closing `rollout_stage` per step."""
        Jl, Jil = consts["Jl"], consts["Jil"]
        Pu, mg = consts["Pu"], consts["mg"]

        def step(carry, inp):
            R_new, p_new, xi_new = (_df(c) for c in carry)
            (qR_t, qp_t, qRn_t, qpn_t, xi_t, xin_t, u_t, k_t, K_t, d_t,
             fqR_t, fqp_t, fxi_t) = (_df(x) for x in inp)
            R_nn, p_nn, xi_nn, u_new, _, _, _ = rollout_stage(
                R_new, p_new, xi_new, qR_t, qp_t, qRn_t, qpn_t, xi_t,
                xin_t, u_t, k_t, K_t, d_t, fqR_t, fqp_t, fxi_t,
                Jl, Jil, Pu, mg, dt=self.dt, gravity=self.gravity)
            return ((_pair(R_nn), _pair(p_nn), _pair(xi_nn)),
                    (_pair(R_nn), _pair(p_nn), _pair(xi_nn), _pair(u_new)))

        sl = lambda d, s: _map_df(lambda x: x[s], d)
        xs = (_pair(sl(qR, slice(None, -1))), _pair(sl(qp, slice(None, -1))),
              _pair(sl(qR, slice(1, None))), _pair(sl(qp, slice(1, None))),
              _pair(sl(xi, slice(None, -1))), _pair(sl(xi, slice(1, None))),
              _pair(us), _pair(k), _pair(K), _pair(lin["d"]),
              _pair(lin["fqR"]), _pair(lin["fqp"]), _pair(lin["fxi"]))
        init = (_pair(sl(qR, 0)), _pair(sl(qp, 0)), _pair(sl(xi, 0)))
        _, (oR, op, oxi, ou) = lax.scan(step, init, xs)
        first = lambda d: _map_df(lambda x: x[:1], d)
        app = lambda a, b: dfx.DF(
            jnp.concatenate([a.hi, b.hi], axis=0),
            jnp.concatenate([a.lo, b.lo], axis=0))
        qR_new = app(first(qR), _df(oR))
        qp_new = app(first(qp), _df(op))
        xi_new = app(first(xi), _df(oxi))
        return qR_new, qp_new, xi_new, _df(ou)

    # -- driver ------------------------------------------------------------

    def _solve_f32(self, sp, q0s, xi0s, us0, al=None):
        """Phase 1: the plain-f32 pipeline on the hi parts of the split
        params.  Returns the lane-layout state (qR, qp, xi, us).
        ``al``: optional input-box AL state (lb (nu,), ub (nu,),
        lmbd (B, N+1, 2nu), imu (B, N+1, 2nu)) — same contract as
        `pipeline.PipelineSolver._solve`."""
        hi = lambda t: jax.tree.map(
            lambda x: x[0] if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
        dyn, cost = hi(sp["dyn"]), hi(sp["cost"])
        qR, qp, xi, us, _, _ = self.base._iterate(dyn, cost, q0s, xi0s, us0,
                                                  al)
        return qR, qp, xi, us

    def _df_setup(self, sp, B):
        """Lane-layout DF constants/references shared by the full-DF and
        mixed-precision (solvers/df_mixed.py) polish drivers.  Returns
        (consts_df, refs_df, term_tail, Rdf, R32)."""
        dtp = jnp.float32
        dyn, cost = sp["dyn"], sp["cost"]
        hi = lambda x: x[0]
        lanes = lambda M: jnp.broadcast_to(M[..., None], M.shape + (B,))
        ref32 = lambda x: jnp.moveaxis(jnp.broadcast_to(
            x[:, None], (x.shape[0], B) + x.shape[1:]), 1, -1)
        Pu2 = dyn.Pu if hasattr(dyn, "Pu") else _split_np(np.eye(6))
        Pu2 = jnp.asarray(Pu2, dtp)
        if self.gravity:
            mg_df = dfx.DF(dyn.m[0], dyn.m[1]) * dfx.DF(dyn.g[0], dyn.g[1])
            mg2 = jnp.stack([mg_df.hi, mg_df.lo])
        else:
            mg2 = jnp.zeros((2,), dtp)
        R32 = hi(cost.R)
        dfc = lambda s2: dfx.DF(lanes(s2[0]), lanes(s2[1]))   # const
        dfr = lambda s2: dfx.DF(ref32(s2[0]), ref32(s2[1]))   # per-stage ref

        Fu2 = _fu_df(dyn.Jinv, Pu2, dyn.dt)                   # (2, 12, nu)
        consts_df = dict(
            Jl=dfc(dyn.J), Jil=dfc(dyn.Jinv), W1=dfc(cost.Q1),
            W2=dfc(cost.Q2), Fu=dfc(Fu2),
            # 2x scaling is exact in f32: scaling both components is a
            # valid DF multiply by 2
            Luu=dfc(2.0 * cost.R),
            Pu=dfc(Pu2), mg=dfc(mg2[:, None]),
        )
        qri = cost.q_ref_inv  # (2, N+1, 4, 4)
        refs_df = dict(
            RbiR=dfr(qri[:, :-1, :3, :3]),
            Rbip=dfr(qri[:, :-1, :3, 3]),
            Adb=dfr(cost.Ad_ref[:, :-1]),
            xib=dfr(cost.xi_ref[:, :-1]),
        )
        one = lambda d: _map_df(lambda x: x[0], d)
        term_tail = (one(dfr(qri[:, -1:, :3, :3])),
                     one(dfr(qri[:, -1:, :3, 3])),
                     one(dfr(cost.Ad_ref[:, -1:])),
                     one(dfr(cost.xi_ref[:, -1:])),
                     dfc(cost.P1), dfc(cost.P2))
        Rdf = dfx.DF(cost.R[0], cost.R[1])  # (nu, nu)
        return consts_df, refs_df, term_tail, Rdf, R32

    def _solve_df(self, sp, qR, qp, xi, us, al=None):
        """Phase 2: double-f32 polish (plain XLA, lane layout) from the
        phase-1 lane state."""
        if al is not None:
            raise NotImplementedError(
                "AL terms in the polish phase are implemented by "
                "MixedDFPipelineSolver; the full-DF driver ignores them")
        B = qR.shape[-1]
        N = self.N
        dtp = jnp.float32
        nu = us.shape[-2]
        prom = lambda x: dfx.DF(x, jnp.zeros_like(x))
        consts_df, refs_df, term_tail, Rdf, R32 = self._df_setup(sp, B)

        qRd, qpd, xid, usd = prom(qR), prom(qp), prom(xi), prom(us)

        def lu_glue(usd):
            rows = []
            for i in range(nu):
                acc = dfx.promote(jnp.zeros_like(usd.hi[:, 0]))
                for j in range(nu):
                    acc = acc + dfx.DF(Rdf.hi[i, j], Rdf.lo[i, j]) * usd[:, j]
                rows.append((acc * 2.0)[:, None])
            return dfx.concatenate(rows, axis=1)  # (N, nu, B) DF

        last = lambda d: _map_df(lambda x: x[-1], d)

        def df_body(_, carry):
            qRd, qpd, xid, usd, lin = (
                _df(carry[0]), _df(carry[1]), _df(carry[2]), _df(carry[3]),
                {k: _df(v) for k, v in carry[4].items()})
            lu = lu_glue(usd)
            term = (last(qRd), last(qpd), last(xid)) + term_tail
            k, K, gvec, lN = self._backward_df(lin, lu, term, consts_df)
            qRd, qpd, xid, usd = self._rollout_df(
                qRd, qpd, xid, usd, k, K, lin, consts_df)
            lin = self._linearize_df(qRd, qpd, xid, usd, refs_df, consts_df)
            return (_pair(qRd), _pair(qpd), _pair(xid), _pair(usd),
                    {k2: _pair(v) for k2, v in lin.items()})

        lin_d = self._linearize_df(qRd, qpd, xid, usd, refs_df, consts_df)
        carry = (_pair(qRd), _pair(qpd), _pair(xid), _pair(usd),
                 {k: _pair(v) for k, v in lin_d.items()})
        carry = lax.fori_loop(0, self.df_iterations, df_body, carry)
        qRd, qpd, xid, usd = (_df(carry[0]), _df(carry[1]), _df(carry[2]),
                              _df(carry[3]))
        lin_d = {k: _df(v) for k, v in carry[4].items()}

        # final metrics: one more backward at the final iterate
        lu = lu_glue(usd)
        term = (last(qRd), last(qpd), last(xid)) + term_tail
        _, _, gvec, lN = self._backward_df(lin_d, lu, term, consts_df)
        gsum = gvec.hi + gvec.lo
        g = jnp.mean(jnp.sqrt(jnp.sum(gsum * gsum, axis=1)), axis=0)
        us_j = usd.hi + usd.lo
        J = (jnp.sum(lin_d["l"].hi[:, 0] + lin_d["l"].lo[:, 0], axis=0)
             + jnp.einsum("nib,ij,njb->b", us_j, R32, us_j)
             + lN.hi + lN.lo)

        # back to solver layout (hi parts for poses; us keeps hi+lo)
        bk = lambda x: jnp.moveaxis(x, -1, 0)
        qs = jnp.zeros((B, N + 1, 4, 4), dtp)
        qs = qs.at[:, :, :3, :3].set(bk(qRd.hi))
        qs = qs.at[:, :, :3, 3].set(bk(qpd.hi))
        qs = qs.at[:, :, 3, 3].set(1.0)
        return DFState(qs=qs, xis=bk(xid.hi), us_hi=bk(usd.hi),
                       us_lo=bk(usd.lo), J_opt=J, grad_norm=g)

    def solve(self, params, q0s, xi0s, us0, al=None):
        """params: {'dyn': SE3Params/RigidBodyParams, 'cost':
        TrackingCostParams} as float64 HOST (numpy) values — split on the
        host so full precision survives without x64 on device.

        ``al``: optional input-box AL state (lb (nu,), ub (nu,),
        lmbd (B, N+1, 2nu), imu (B, N+1, 2nu)) at FIXED multipliers —
        both phases then minimize the augmented Lagrangian, so the polish
        refines a constrained (active-set) solve; supported by the mixed
        driver (`MixedDFPipelineSolver`), not the full-DF one.

        The whole program is f32 (hi/lo pairs), so it is traced and run
        with x64 OFF regardless of the caller's setting: tracing the large
        DF graphs under x64 is >25x slower (type canonicalization).

        Problem inputs (q0s/xi0s/us0) that are ALREADY f32 device arrays
        are passed through untouched (pre-stage them with
        `jax.device_put` to keep their transfer out of a timed solve);
        anything else is converted host-side."""
        sp = split_pytree(params)

        def stage(x):
            if isinstance(x, jnp.ndarray) and x.dtype == jnp.float32:
                return x
            return np.asarray(x, np.float32)

        q0f = stage(q0s)
        xif = stage(xi0s)
        usf = stage(us0)
        if al is not None:
            lb_a, ub_a, lmbd_a, imu_a = al
            nu = np.shape(us0)[-1]
            al = (np.broadcast_to(np.asarray(lb_a, np.float32), (nu,)),
                  np.broadcast_to(np.asarray(ub_a, np.float32), (nu,)),
                  stage(lmbd_a), stage(imu_a))
        prev = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", False)
        try:
            lane_state = self._f32_jit(sp, q0f, xif, usf, al)
            out = self._df_jit(sp, *lane_state, al)
            jax.block_until_ready(out)
        finally:
            jax.config.update("jax_enable_x64", prev)
        return out


def _fu_df(Jinv2, Pu2, dt2):
    """DF-accurate Fu = [0; Jinv Pu] dt from split operands, as a
    (2, 12, nu) hi/lo stack (computed in DF arithmetic, trace-time XLA)."""
    Ji = dfx.DF(Jinv2[0], Jinv2[1])
    Pu = dfx.DF(Pu2[0], Pu2[1])
    dt = dfx.DF(dt2[0], dt2[1])
    nu = Pu2.shape[-1]
    rows = []
    for i in range(6):
        cols = []
        for j in range(nu):
            acc = dfx.const(0.0)
            for kk in range(6):
                acc = acc + Ji[i, kk] * Pu[kk, j]
            cols.append((acc * dt)[None])
        rows.append(dfx.concatenate(cols, axis=0)[None])
    bt6 = dfx.concatenate(rows, axis=0)  # (6, nu) DF
    z = dfx.zeros_like(bt6)
    full = dfx.concatenate([z, bt6], axis=0)  # (12, nu) DF
    return jnp.stack([full.hi, full.lo], axis=0)
