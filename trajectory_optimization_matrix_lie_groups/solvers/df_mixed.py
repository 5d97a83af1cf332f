"""Mixed-precision double-f32 polish: DF residuals, f32 preconditioner.

The full-DF polish (`solvers/df_pipeline.py`) runs EVERY operation of the
MS-iLQR iteration in double-f32, which costs many times an f32 iteration.
But the accuracy of the *converged* iterate is set only by the
accuracy of the residuals the iteration drives to zero, not by the
preconditioner applied to them (classic mixed-precision iterative
refinement: solve in low precision, evaluate residuals in high precision —
Wilkinson; Higham, "Accuracy and Stability of Numerical Algorithms" ch.12).

For MS-iLQR the fixed point is (defects d = 0, per-stage gradient Qu = 0),
so the double-f32 path must carry exactly:

  - the trajectory state (pose/twist carry through the gap-closing
    rollout) and controls — they define the point where residuals are
    evaluated, and the pose differences (defects, feedback deviation
    xs_err) are catastrophic cancellations of near-equal group elements;
  - the defect d, cost gradients lx / lu, dynamics Jacobian Fx, and the
    adjoint (V_x) recursion through Fx^T — these form the computed Qu,
    whose ABSOLUTE error lands on the controls amplified by
    1/sigma_min(Quu) ~ 5e4.

Everything else only preconditions the step and may carry f32 error,
because its error enters the update MULTIPLIED by the residual (k, Qu, d,
xs_err -> 0 at the fixed point), so it vanishes where it matters:

  - the value-Hessian recursion V_xx, Q_xx, Q_ux, Q_uu, its Cholesky
    factors and the gains K;
  - the GN cost Hessian lxx (and the cost value l, a diagnostic);
  - the feedback products K @ xs_err and the vanishing V_x correction
    terms K^T(Q_uu k + Q_u) + Q_ux^T k;
  - the step k itself: k = -Q_uu^{-1} Q_u computed from the f32 rounding
    of the DF Q_u has RELATIVE error only, so the iteration still
    contracts to the DF-accurate root of Q_u.

Cost: the dominant double-f32 work of the full-DF backward — the
(12,12)x(12,12) Hessian propagation, ~5k DF multiplies/stage — drops to
f32, leaving ~250 DF ops/stage on the gradient chain; the linearizer
drops the GN Hessian products; the rollout drops the feedback matvec.

The iteration additionally fuses the rollout with the next linearization
(as the f32 pipeline does, solvers/pipeline.py): the rollout's
dynamics evaluations are re-used as the linearizer's, so each polish
iteration evaluates the DF dynamics once, not twice.

Reference precision policy being matched: float64 end-to-end
(main_SE3ddp_tracking_exact_ms.py:36); accuracy vs the f64 golden is
gated by tests/test_df_mixed.py at the same <=1e-4 bar as the full-DF
path (measured: the two agree to the flat-direction indeterminacy).
"""

import jax
import jax.numpy as jnp
from jax import lax

from trajectory_optimization_matrix_lie_groups.ops import dfx
from trajectory_optimization_matrix_lie_groups.ops import lie_lane as ll
from trajectory_optimization_matrix_lie_groups.ops.stage_linearize import (
    stage_dynamics_eval,
    stage_jacobian,
)
from trajectory_optimization_matrix_lie_groups.solvers.df_pipeline import (
    DFPipelineSolver,
    DFState,
    _df,
    _map_df,
    _pair,
)
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    NX,
    chol_factor_lane,
    chol_solve_lane,
)

__all__ = ["MixedDFPipelineSolver", "riccati_stage_mx", "stage_cost_quad_mx"]


def matvec_f32_df(A32, v, m):
    """Compensated (n,m,B) f32-matrix x DF-vector product -> DF (n,B).

    Each elementary product A_ik v_k is an error-free transformation of
    the f32 entry with the DF value's hi part (Dekker two_prod) plus the
    exactly-representable A_ik * lo cross term; terms accumulate with the
    full DF add.  Error ~ eps_f32^2 * |A||v| per term — the same grade as
    a DF-matrix product when A itself is EXACT at f32 (which is the use
    case: an f32-computed Jacobian whose value IS the operand, see
    `MixedDFPipelineSolver(fx_mode='f32')`)."""
    acc = None
    for k in range(m):
        a = A32[:, k, :]
        p, e = dfx._two_prod(a, v.hi[k:k + 1, :])
        e = e + a * v.lo[k:k + 1, :]
        term = dfx.DF(*dfx._quick_two_sum(p, e))
        acc = term if acc is None else acc + term
    return acc


def stage_cost_quad_mx(R, p, xi, RbiR, Rbip, Adb, xib, W1_df, W2_df, W1_32):
    """Mixed GN tracking quadratization (models/costs.py:103): the gradient
    lx (residual path) in DF, the GN Hessian lxx (preconditioner) and the
    cost value l (diagnostic) in f32 from the hi parts.
    Returns (lx DF (12,B), lxx32 f32 (12,12,B), l32 f32 (B,))."""
    Reb, peb = ll.se3_compose(R, p, RbiR, Rbip)
    e = ll.se3_log(Reb, peb)
    ev = xi - xib
    Jex = ll.matmul(ll.se3_right_jacobian_inv(e), Adb, 6)
    JT2 = 2.0 * ll.transpose(Jex)
    W1e = ll.matvec(W1_df, e, 6)
    W2ev = ll.matvec(W2_df, ev, 6)
    lx = dfx.concatenate([ll.matvec(JT2, W1e, 6), 2.0 * W2ev], axis=0)
    # f32 preconditioner parts
    bs = Jex.hi.shape[2:]  # trailing batch dims
    dtp = Jex.hi.dtype
    JT2_32 = 2.0 * ll.transpose(Jex.hi)
    H_e = ll.matmul(ll.matmul(JT2_32, W1_32, 6), Jex.hi, 6)
    Z = jnp.zeros((6, 6) + bs, dtp)
    lxx32 = ll.blk(H_e, Z, Z, 2.0 * W2_df.hi)
    l32 = (sum(e.hi[i] * W1e.hi[i] for i in range(6))
           + sum(ev.hi[i] * W2ev.hi[i] for i in range(6)))
    return lx, lxx32, l32


def riccati_stage_mx(fx, dd, lx_t, lu_t, lxx32, fu2_df, fu2T_df, fu2_32,
                     fu2T_32, Luu32, Vx, Vxx32, *, nu, glow, half=6,
                     luual_t=None):
    """One mixed-precision defect-aware Riccati step on lane-layout values.

    Same math/block structure as `solvers.pipeline.riccati_stage`
    (traopt_controller.py:1741-1748): Fu = [0; fu2], Lux = 0,
    Fx = [[A, Bb], [C, D]] with C = 0 unless ``glow``.  The value-Hessian
    chain runs in f32 on the hi parts; the adjoint/gradient chain
    (Vmod, Qx, Qu, Vx) runs in DF.  Returns
    (k32 f32, K32 f32, Qu DF, Vx_new DF, Vxx_new32 f32).

    ``fx`` may be a DF value (the DF-computed Jacobian) or a plain f32
    array (``fx_mode='f32'``): then the adjoint matvecs run as compensated
    f32xDF products (`matvec_f32_df`) — the Jacobian VALUE carries f32
    rounding, but the products against the DF adjoint stay error-free."""
    h = half
    nx = 2 * h
    fx_is_df = dfx.is_df(fx)
    # ---- f32 preconditioner chain (hi parts) -----------------------------
    fx32 = fx.hi if fx_is_df else fx
    A32, Bb32, D32 = fx32[:h, :h], fx32[:h, h:], fx32[h:, h:]
    A32T = ll.transpose(A32)
    Bb32T = ll.transpose(Bb32)
    D32T = ll.transpose(D32)
    vxd32 = ll.matvec(Vxx32, dd.hi, nx)          # V_xx d (reused in DF)
    VF_l = ll.matmul(Vxx32[:, :h], A32, h)
    VF_r = ll.matmul(Vxx32[:, :h], Bb32, h) + ll.matmul(Vxx32[:, h:],
                                                          D32, h)
    if glow:
        C32 = fx32[h:, :h]
        C32T = ll.transpose(C32)
        VF_l = VF_l + ll.matmul(Vxx32[:, h:], C32, h)
    VF = jnp.concatenate([VF_l, VF_r], axis=1)
    Qxx_top = ll.matmul(A32T, VF[:h], h)
    if glow:
        Qxx_top = Qxx_top + ll.matmul(C32T, VF[h:], h)
    Qxx_bot = ll.matmul(Bb32T, VF[:h], h) + ll.matmul(D32T, VF[h:], h)
    Qxx = lxx32 + jnp.concatenate([Qxx_top, Qxx_bot], axis=0)
    Qux = ll.matmul(fu2T_32, VF[h:], h)                     # Lux = 0
    Quu = Luu32 + ll.matmul(fu2T_32,
                             ll.matmul(Vxx32[h:, h:], fu2_32, h), h)
    if luual_t is not None:
        # diagonal AL penalty add via a one-hot mask; f32
        # preconditioner-grade like the rest of Quu
        nb1 = (1,) * (len(Quu.shape) - 2)
        r_i = jax.lax.broadcasted_iota(jnp.int32, (nu, nu) + nb1, 0)
        c_i = jax.lax.broadcasted_iota(jnp.int32, (nu, nu) + nb1, 1)
        eye = (r_i == c_i).astype(Quu.dtype)
        Quu = Quu + eye * luual_t[:, None]
    L = chol_factor_lane(Quu, nu)
    K = -chol_solve_lane(L, Qux, nu)

    # ---- DF gradient (adjoint) chain -------------------------------------
    # V_xx d enters the residual multiplied by d -> 0, so the f32 product
    # promoted to DF keeps the fixed point exact
    Vmod = Vx + dfx.promote(vxd32)
    if fx_is_df:
        AT = ll.transpose(fx[:h, :h])
        BbT = ll.transpose(fx[:h, h:])
        DT = ll.transpose(fx[h:, h:])
        Qx_top = ll.matvec(AT, Vmod[:h], h)
        Qx_bot = ll.matvec(BbT, Vmod[:h], h) + ll.matvec(DT, Vmod[h:], h)
        if glow:
            CT = ll.transpose(fx[h:, :h])
            Qx_top = Qx_top + ll.matvec(CT, Vmod[h:], h)
    else:
        Qx_top = matvec_f32_df(A32T, Vmod[:h], h)
        Qx_bot = (matvec_f32_df(Bb32T, Vmod[:h], h)
                  + matvec_f32_df(D32T, Vmod[h:], h))
        if glow:
            Qx_top = Qx_top + matvec_f32_df(C32T, Vmod[h:], h)
    Qx = lx_t + dfx.concatenate([Qx_top, Qx_bot], axis=0)
    Qu = lu_t + ll.matvec(fu2T_df, Vmod[h:], h)

    # k from the f32 Cholesky of the DF gradient's correct f32 rounding:
    # relative error only -> the iteration still converges to Qu_DF = 0
    k = -chol_solve_lane(L, Qu.hi[:, None, :], nu)[:, 0, :]

    # vanishing V_x correction terms (all ∝ k / Qu) in f32
    KT = ll.transpose(K)
    QuxT = ll.transpose(Qux)
    KTQuu = ll.matmul(KT, Quu, nu)
    corr32 = (ll.matvec(KTQuu, k, nu) + ll.matvec(KT, Qu.hi, nu)
              + ll.matvec(QuxT, k, nu))
    Vx_new = Qx + dfx.promote(corr32)

    M = ll.matmul(KT, Qux, nu)
    S = Qxx + ll.matmul(KTQuu, K, nu)
    Vxx_new = 0.5 * (S + ll.transpose(S)) + M + ll.transpose(M)
    return k, K, Qu, Vx_new, Vxx_new


def rollout_stage_mx(R_new, p_new, xi_new, qR_t, qp_t, qRn_t, qpn_t, xi_t,
                     xin_t, u_t, k32_t, K32_t, d_t, fqR_t, fqp_t, fxi_t,
                     Jl, Jil, Pu, mg, *, dt, gravity):
    """One gap-closing rollout step, mixed precision: the state carry, the
    tangent deviation xs_err, the control accumulation, and the dynamics
    evaluation in DF; the feedback product K @ xs_err in f32 (its error is
    multiplied by xs_err -> 0).  Math per solvers.pipeline.rollout_stage /
    the reference MS forward pass (traopt_controller.py:2697-2726).

    Polish-phase specializations (all DF-grade inside their envelopes,
    which the phase guarantees — the f32 phase has already converged the
    trajectory to ~1e-3): the deviation/defect rotations are near-identity
    so xs_err uses the quaternion-free small-angle log and Exp(d) a
    short series; renormalization is one polar-Newton step (the carry is
    already orthogonal to the previous step's DF grade); the dynamics
    exp series truncates at 12 terms (full |theta| <= pi accuracy
    regardless — factorial decay).  These cuts shrink the DF step body
    (26.5k primitives without them).
    Returns (R_nn, p_nn, xi_nn, u_new, fqR_n, fqp_n, fxi_new) — all DF."""
    Ri_inv, pi_inv = ll.se3_inverse(qR_t, qp_t)
    Re, pe = ll.se3_compose(Ri_inv, pi_inv, R_new, p_new)
    xs_err = dfx.concatenate(
        [ll.se3_log_small(Re, pe) if dfx.is_df(Re)
         else ll.se3_log(Re, pe), xi_new - xi_t], axis=0)

    fb32 = k32_t + sum(K32_t[:, j, :] * xs_err.hi[j:j + 1, :]
                       for j in range(NX))
    u_new = u_t + dfx.promote(fb32)

    fqR_n, fqp_n, fxi_new = stage_dynamics_eval(
        R_new, p_new, xi_new, u_new, Jl, Jil, Pu, mg,
        dt=dt, gravity=gravity, terms=12,
        renorm=ll.so3_normalize_newton if dfx.is_df(R_new) else None)

    edR, edp = ll.se3_exp(d_t[:6], terms=8)
    fiR, fip = ll.se3_inverse(fqR_t, fqp_t)
    R_a, p_a = ll.se3_compose(qRn_t, qpn_t, edR, edp)
    R_b, p_b = ll.se3_compose(R_a, p_a, fiR, fip)
    R_nn, p_nn = ll.se3_compose(R_b, p_b, fqR_n, fqp_n)
    R_nn = (ll.so3_normalize_newton(R_nn) if dfx.is_df(R_nn)
            else ll.so3_normalize(R_nn))
    xi_nn = xin_t + fxi_new - fxi_t + d_t[6:]
    return R_nn, p_nn, xi_nn, u_new, fqR_n, fqp_n, fxi_new


class MixedDFPipelineSolver(DFPipelineSolver):
    """f32 pipeline + mixed-precision DF polish (module docstring).

    Drop-in replacement for `DFPipelineSolver`: same constructor, same
    `solve` contract, same `DFState` output; `df_iterations` polish
    iterations run the mixed backward/rollout/linearize instead of the
    full-DF ones (cheaper, same <=1e-4 accuracy).

    ``fx_mode``: 'df' (default) computes the stage Jacobian in DF; 'f32'
    computes it in f32 from the hi-part state and runs the adjoint-chain
    products as compensated f32xDF (`matvec_f32_df`).  'f32' is cheaper,
    but the Jacobian's f32 rounding is a PERSISTENT gradient bias: the
    polish converges to a point ~2x further from the f64 optimum (H=30 on
    the CPU: 6.1e-5), outside the 1e-4 gate at N=200.  Use 'f32' only
    where ~4e-4 control fidelity suffices.  'hybrid' runs the f32
    Jacobian on every polish iteration except the LAST (unrolled
    schedule): the f32 bias is erased by the closing DF-Jacobian
    iteration, and accuracy matches 'df'.  It helps on the plain-XLA path, where the DF
    Jacobian is the largest lane-folded product chain."""

    def __init__(self, *args, fx_mode: str = "df", **kwargs):
        if fx_mode not in ("df", "f32", "hybrid"):
            raise ValueError(
                f"fx_mode must be 'df', 'f32' or 'hybrid', got {fx_mode}")
        self.fx_mode = fx_mode
        super().__init__(*args, **kwargs)

    # -- lane folding helpers: the stage axis merges into the lane axis,
    # (N, ..., B) <-> (..., N*B) --------------------------------------------

    def _fold(self, d):
        def f(x):
            x = jnp.moveaxis(x, 0, -2)
            return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
        return _map_df(f, d) if dfx.is_df(d) else f(d)

    def _tile(self, d, B):
        """Constant (..., batch) -> folded-layout const (stage axis
        materialized: folded values meet consts inside concatenates, which
        do not broadcast)."""
        N = self.N

        def f(x):
            x = jnp.broadcast_to(x[..., None, :], x.shape[:-1] + (N, B))
            return x.reshape(x.shape[:-2] + (N * B,))
        return _map_df(f, d) if dfx.is_df(d) else f(d)

    def _unfold(self, d, B):
        def f(x):
            x = x.reshape(x.shape[:-1] + (self.N, B))
            return jnp.moveaxis(x, -2, 0)
        return _map_df(f, d) if dfx.is_df(d) else f(d)

    # -- mixed linearization ------------------------------------------------

    def _linearize_tail_mx(self, qR, qp, xi, evals, refs, consts_df,
                           consts32, fx_df=None):
        """Stage linearization of the trajectory (qR, qp, xi) REUSING the
        rollout's dynamics evaluations ``evals`` = (fqR, fqp, fxi) DF
        (N, ..., B) — the DF twin of the f32 pipeline's fused
        rollout+linearize recursion.  Defect d and gradient lx in DF, the GN
        Hessian lxx in f32.  ``fx_df`` overrides the Jacobian precision
        for this call (None: follow fx_mode — used by the hybrid schedule,
        which runs f32 Jacobians on all but the last polish iteration).
        Returns the lin dict of (N, ..., B) values."""
        if fx_df is None:
            fx_df = self.fx_mode != "f32"
        B = qR.hi.shape[-1]
        fold, tile, unfold = self._fold, (lambda d: self._tile(d, B)), \
            (lambda d: self._unfold(d, B))

        R = fold(_map_df(lambda x: x[:-1], qR))
        p = fold(_map_df(lambda x: x[:-1], qp))
        Rn = fold(_map_df(lambda x: x[1:], qR))
        pn = fold(_map_df(lambda x: x[1:], qp))
        xis = fold(_map_df(lambda x: x[:-1], xi))
        xin = fold(_map_df(lambda x: x[1:], xi))
        fqR, fqp, fxi = (fold(e) for e in evals)
        Jl, Jil = tile(consts_df["Jl"]), tile(consts_df["Jil"])
        W1, W2 = tile(consts_df["W1"]), tile(consts_df["W2"])
        W1_32 = tile(consts32["W1"])
        mg = tile(consts_df["mg"])

        # defect vs the (already gap-closed) next state
        Rni, pni = ll.se3_inverse(Rn, pn)
        Rd, pd = ll.se3_compose(Rni, pni, fqR, fqp)
        d = dfx.concatenate([ll.se3_log(Rd, pd), fxi - xin], axis=0)
        if not fx_df:
            Fx = stage_jacobian(
                R.hi, xis.hi, tile(consts32["Jl"]), tile(consts32["Jil"]),
                tile(consts32["mg"]), dt=self.dt, gravity=self.gravity,
                exact_grav=self.exact_grav)
        else:
            Fx = stage_jacobian(R, xis, Jl, Jil, mg, dt=self.dt,
                                gravity=self.gravity,
                                exact_grav=self.exact_grav)
        lx, lxx32, l32 = stage_cost_quad_mx(
            R, p, xis, fold(refs["RbiR"]), fold(refs["Rbip"]),
            fold(refs["Adb"]), fold(refs["xib"]), W1, W2, W1_32)

        out = dict(fqR=fqR, fqp=fqp, fxi=fxi, d=d, Fx=Fx, lx=lx)
        out = {k: unfold(v) for k, v in out.items()}
        out["lxx32"] = self._unfold(lxx32, B)
        out["l32"] = self._unfold(l32[None], B)[:, 0]
        return out

    def _dyn_evals_mx(self, qR, qp, xi, us, consts_df):
        """Lane-folded DF dynamics evaluations of a trajectory — the only
        piece of a full linearization the rotated polish loop needs at
        entry (every later iteration reuses the rollout's evals)."""
        B = us.hi.shape[-1]
        fold, tile = self._fold, (lambda d: self._tile(d, B))
        R = fold(_map_df(lambda x: x[:-1], qR))
        p = fold(_map_df(lambda x: x[:-1], qp))
        xis = fold(_map_df(lambda x: x[:-1], xi))
        u = fold(us)
        fqR, fqp, fxi = stage_dynamics_eval(
            R, p, xis, u, tile(consts_df["Jl"]), tile(consts_df["Jil"]),
            tile(consts_df["Pu"]), tile(consts_df["mg"]),
            dt=self.dt, gravity=self.gravity)
        return tuple(self._unfold(e, B) for e in (fqR, fqp, fxi))

    def _linearize_mx(self, qR, qp, xi, us, refs, consts_df, consts32):
        """Initial mixed linearization (no saved rollout evals): one
        lane-folded DF dynamics evaluation + the fused tail."""
        evals = self._dyn_evals_mx(qR, qp, xi, us, consts_df)
        return self._linearize_tail_mx(qR, qp, xi, evals, refs, consts_df,
                                       consts32)

    def _cost_value32(self, qR, qp, xi, us, refs, term_tail, R32, consts32):
        """f32 cost of a lane-layout DF iterate: GN tracking stage values
        + control quad + terminal, from the hi parts (J is a diagnostic;
        the polish's accuracy gate is on the controls).  ~0.5% of an
        iteration's FLOPs — replaces the trailing metrics backward
        (round-4 loop rotation, see _solve_df)."""
        B = us.hi.shape[-1]
        N = self.N
        fold = self._fold
        hi_cut = lambda d, s: fold(_map_df(lambda x: x[s], d)).hi
        R = hi_cut(qR, slice(None, -1))
        p = hi_cut(qp, slice(None, -1))
        xis = hi_cut(xi, slice(None, -1))
        tile32 = lambda M: self._tile(M, B)
        Reb, peb = ll.se3_compose(R, p, fold(refs["RbiR"].hi),
                                   fold(refs["Rbip"].hi))
        e = ll.se3_log(Reb, peb)
        ev = xis - fold(refs["xib"].hi)
        W1e = ll.matvec(tile32(consts32["W1"]), e, 6)
        W2ev = ll.matvec(tile32(consts32["W2"]), ev, 6)
        l = (sum(e[i] * W1e[i] for i in range(6))
             + sum(ev[i] * W2ev[i] for i in range(6)))
        # folded l: (N*B,) lane layout, (N, S, L) packed — sum the stages
        lsum = jnp.sum(l.reshape(N, B), axis=0)
        # terminal
        lasth = lambda d: _map_df(lambda x: x[-1], d).hi
        RbiRN, RbipN, AdbN, xibN, P1d, P2d = term_tail
        ReN, peN = ll.se3_compose(lasth(qR), lasth(qp), RbiRN.hi, RbipN.hi)
        eN = ll.se3_log(ReN, peN)
        evN = lasth(xi) - xibN.hi
        P1eN = ll.matvec(P1d.hi, eN, 6)
        P2evN = ll.matvec(P2d.hi, evN, 6)
        lN = (sum(eN[i] * P1eN[i] for i in range(6))
              + sum(evN[i] * P2evN[i] for i in range(6)))
        us_j = us.hi + us.lo
        return (lsum + jnp.einsum("ni...,ij,nj...->...", us_j, R32, us_j)
                + lN)

    # -- mixed backward -----------------------------------------------------

    def _backward_mx(self, lin, lu, term, consts_df, consts32,
                     luu_al=None):
        """Reverse scan; body = `riccati_stage_mx`.  ``term`` carries the
        DF terminal state/refs + DF P1/P2 + f32 P1 lanes.  ``luu_al``:
        optional (N, nu, B) f32 per-stage diagonal Quu additions (the
        input-box AL penalty, same contract as the f32 pipeline's
        `_backward_lane`).  Returns (k32 (N,nu,B), K32 (N,nu,12,B),
        gvec DF, lN32 (B,))."""
        (qRN, qpN, xiN, RbiRN, RbipN, AdbN, xibN, P1_df, P2_df,
         P1_32) = term
        lxN, lxxN32, lN32 = stage_cost_quad_mx(
            qRN, qpN, xiN, RbiRN, RbipN, AdbN, xibN, P1_df, P2_df, P1_32)
        fu2_df = consts_df["Fu"][6:]
        fu2T_df = ll.transpose(fu2_df)
        fu2_32 = consts32["Fu"][6:]
        fu2T_32 = ll.transpose(fu2_32)
        Luu32 = consts32["Luu"]
        nu = lu.hi.shape[-2]

        def step(carry, inp):
            Vx, Vxx32 = _df(carry[0]), carry[1]
            fx_p, dd_p, lx_p, lu_p, lxx32_t, lual_t = inp
            fx_t = _df(fx_p) if isinstance(fx_p, tuple) else fx_p
            k32, K32, Qu, Vx_n, Vxx_n32 = riccati_stage_mx(
                fx_t, _df(dd_p), _df(lx_p), _df(lu_p), lxx32_t,
                fu2_df, fu2T_df, fu2_32, fu2T_32, Luu32, Vx, Vxx32,
                nu=nu, glow=self.gravity, luual_t=lual_t)
            return ((_pair(Vx_n), Vxx_n32), (k32, K32, _pair(Qu)))

        fx_xs = (_pair(lin["Fx"]) if dfx.is_df(lin["Fx"]) else lin["Fx"])
        # None is an empty pytree: scan threads it through untouched
        xs = (fx_xs, _pair(lin["d"]), _pair(lin["lx"]),
              _pair(lu), lin["lxx32"], luu_al)
        (_, _), (k32, K32, gvec_p) = lax.scan(
            step, (_pair(lxN), lxxN32), xs, reverse=True)
        return k32, K32, _df(gvec_p), lN32

    # -- mixed rollout (emits the dynamics evals for the fused linearize) ---

    def _rollout_mx(self, qR, qp, xi, us, k32, K32, lin, consts_df):
        Jl, Jil = consts_df["Jl"], consts_df["Jil"]
        Pu, mg = consts_df["Pu"], consts_df["mg"]

        def step(carry, inp):
            R_new, p_new, xi_new = (_df(c) for c in carry)
            (qR_p, qp_p, qRn_p, qpn_p, xi_p, xin_p, u_p, d_p, fqR_p,
             fqp_p, fxi_p, k_t, K_t) = inp
            R_nn, p_nn, xi_nn, u_new, fqR_n, fqp_n, fxi_n = rollout_stage_mx(
                R_new, p_new, xi_new, _df(qR_p), _df(qp_p), _df(qRn_p),
                _df(qpn_p), _df(xi_p), _df(xin_p), _df(u_p), k_t, K_t,
                _df(d_p), _df(fqR_p), _df(fqp_p), _df(fxi_p),
                Jl, Jil, Pu, mg, dt=self.dt, gravity=self.gravity)
            return ((_pair(R_nn), _pair(p_nn), _pair(xi_nn)),
                    (_pair(R_nn), _pair(p_nn), _pair(xi_nn), _pair(u_new),
                     _pair(fqR_n), _pair(fqp_n), _pair(fxi_n)))

        sl = lambda d, s: _map_df(lambda x: x[s], d)
        xs = (_pair(sl(qR, slice(None, -1))), _pair(sl(qp, slice(None, -1))),
              _pair(sl(qR, slice(1, None))), _pair(sl(qp, slice(1, None))),
              _pair(sl(xi, slice(None, -1))), _pair(sl(xi, slice(1, None))),
              _pair(us), _pair(lin["d"]), _pair(lin["fqR"]),
              _pair(lin["fqp"]), _pair(lin["fxi"]), k32, K32)
        init = (_pair(sl(qR, 0)), _pair(sl(qp, 0)), _pair(sl(xi, 0)))
        _, (oR, op, oxi, ou, efqR, efqp, efxi) = lax.scan(step, init, xs)
        first = lambda d: _map_df(lambda x: x[:1], d)
        app = lambda a, b: dfx.DF(
            jnp.concatenate([a.hi, b.hi], axis=0),
            jnp.concatenate([a.lo, b.lo], axis=0))
        qR_new = app(first(qR), _df(oR))
        qp_new = app(first(qp), _df(op))
        xi_new = app(first(xi), _df(oxi))
        evals = (_df(efqR), _df(efqp), _df(efxi))
        return qR_new, qp_new, xi_new, _df(ou), evals

    # -- driver -------------------------------------------------------------

    def _solve_df(self, sp, qR, qp, xi, us, al=None):
        """Phase 2 (mixed): overrides the full-DF polish driver; same
        contract.  The loop is ROTATED — each iteration linearizes at its
        own iterate (reusing the previous rollout's dynamics evals, or a
        bare dynamics pass for the handoff trajectory), then backward,
        then rollout — so there is no trailing linearization or metrics
        backward (those would cost most of an extra iteration).  J_opt is an f32 cost pass at the
        RETURNED iterate; grad_norm is the gradient at the final
        backward's evaluation point — the iterate the last update stepped
        from, one polish step stale (the reference's on_iteration grad
        report has the same before-the-update semantics,
        traopt_controller.py on_iteration).

        ``al``: optional input-box AL state at FIXED (lmbd, imu) — the
        polish then minimizes the augmented Lagrangian: its u-gradient
        additions ride the DF ``lu`` (multipliers are exact-at-f32
        parameters; the residual products run full DF), the penalty's
        diagonal Quu addition is the f32 preconditioner-grade ``luu_al``
        input of the backward.  With the multipliers a converged AL outer
        loop produced, the augmented fixed point IS the constrained
        optimum to multiplier accuracy — the active-set refinement of the
        unconstrained polish (see `al_pipeline.al_polish`)."""
        B = qR.shape[-1]
        N = self.N
        dtp = jnp.float32
        nu = us.shape[-2]
        prom = lambda x: dfx.DF(x, jnp.zeros_like(x))
        consts_df, refs_df, term_tail, Rdf, R32 = self._df_setup(sp, B)
        cost = sp["cost"]
        lanes = lambda M: jnp.broadcast_to(M[..., None], M.shape + (B,))
        dyn = sp["dyn"]
        mg32 = (jnp.broadcast_to(dyn.m[0] * dyn.g[0], (1, B))
                if self.gravity else jnp.zeros((1, B), dtp))
        consts32 = dict(
            W1=lanes(cost.Q1[0]), Fu=consts_df["Fu"].hi,
            Luu=lanes(2.0 * R32), P1=lanes(cost.P1[0]),
            Jl=lanes(dyn.J[0]), Jil=lanes(dyn.Jinv[0]), mg=mg32,
            W2=lanes(cost.Q2[0]),
        )
        term_mx = term_tail + (consts32["P1"],)

        qRd, qpd, xid, usd = prom(qR), prom(qp), prom(xi), prom(us)

        if al is not None:
            lb_a, ub_a, lmbd_a, imu_a = al
            lam_l = jnp.moveaxis(lmbd_a, 0, -1).astype(dtp)
            imu_l = jnp.moveaxis(imu_a, 0, -1).astype(dtp)
            lam_lo32, lam_hi32 = lam_l[:-1, :nu], lam_l[:-1, nu:]
            im_lo32, im_hi32 = imu_l[:-1, :nu], imu_l[:-1, nu:]
            lb32 = jnp.broadcast_to(
                jnp.asarray(lb_a, dtp).reshape((1, nu, 1)), (N, nu, B))
            ub32 = jnp.broadcast_to(
                jnp.asarray(ub_a, dtp).reshape((1, nu, 1)), (N, nu, B))
            luu_al32 = im_lo32 + im_hi32                   # (N, nu, batch)
        else:
            luu_al32 = None

        def lu_glue(usd):
            rows = []
            for i in range(nu):
                acc = dfx.promote(jnp.zeros_like(usd.hi[:, 0]))
                for j in range(nu):
                    acc = acc + dfx.DF(Rdf.hi[i, j], Rdf.lo[i, j]) * usd[:, j]
                rows.append((acc * 2.0)[:, None])
            lu = dfx.concatenate(rows, axis=1)  # (N, nu, B) DF
            if al is not None:
                # AL u-gradient in DF: multipliers/penalties are exact-at-
                # f32 parameters, the box residuals g carry the DF iterate
                glo = dfx.promote(lb32) - usd
                ghi = usd - dfx.promote(ub32)
                lu = (lu
                      - (dfx.promote(lam_lo32) + dfx.promote(im_lo32) * glo)
                      + (dfx.promote(lam_hi32) + dfx.promote(im_hi32) * ghi))
            return lu

        last = lambda d: _map_df(lambda x: x[-1], d)

        if self.df_iterations == 0:
            # no polish: metrics at the promoted handoff iterate
            lin = self._linearize_mx(qRd, qpd, xid, usd, refs_df, consts_df,
                                     consts32)
            lu = lu_glue(usd)
            term = (last(qRd), last(qpd), last(xid)) + term_mx
            _, _, gvec, _ = self._backward_mx(lin, lu, term, consts_df,
                                              consts32, luu_al=luu_al32)
        else:
            def df_iter(qRd, qpd, xid, usd, evals, fx_df):
                lin = self._linearize_tail_mx(qRd, qpd, xid, evals, refs_df,
                                              consts_df, consts32,
                                              fx_df=fx_df)
                lu = lu_glue(usd)
                term = (last(qRd), last(qpd), last(xid)) + term_mx
                k32, K32, gvec, _ = self._backward_mx(lin, lu, term,
                                                      consts_df, consts32,
                                                      luu_al=luu_al32)
                qRd, qpd, xid, usd, evals = self._rollout_mx(
                    qRd, qpd, xid, usd, k32, K32, lin, consts_df)
                return qRd, qpd, xid, usd, evals, gvec

            evals0 = self._dyn_evals_mx(qRd, qpd, xid, usd, consts_df)
            if self.fx_mode == "hybrid":
                # unrolled schedule: f32 Jacobian on every iteration except
                # the last (its bias would persist only if a DF-Jacobian
                # iteration did not follow: fx_mode='f32' converges
                # outside the gate)
                evals = evals0
                for i in range(self.df_iterations):
                    qRd, qpd, xid, usd, evals, gvec = df_iter(
                        qRd, qpd, xid, usd, evals,
                        fx_df=(i == self.df_iterations - 1))
            else:
                def df_body(_, carry):
                    qRd, qpd, xid, usd = (_df(c) for c in carry[:4])
                    evals = tuple(_df(e) for e in carry[4])
                    out = df_iter(qRd, qpd, xid, usd, evals, None)
                    qRd, qpd, xid, usd, evals, gvec = out
                    return (_pair(qRd), _pair(qpd), _pair(xid), _pair(usd),
                            tuple(_pair(e) for e in evals), _pair(gvec))

                gvec0 = dfx.promote(jnp.zeros((N, nu, B), dtp))
                carry = (_pair(qRd), _pair(qpd), _pair(xid), _pair(usd),
                         tuple(_pair(e) for e in evals0), _pair(gvec0))
                carry = lax.fori_loop(0, self.df_iterations, df_body, carry)
                qRd, qpd, xid, usd = (_df(c) for c in carry[:4])
                gvec = _df(carry[5])

        gsum = gvec.hi + gvec.lo
        g = jnp.mean(jnp.sqrt(jnp.sum(gsum * gsum, axis=1)), axis=0)
        J = self._cost_value32(qRd, qpd, xid, usd, refs_df, term_tail, R32,
                               consts32)
        if al is not None:
            # augmented-cost term (f32 diagnostic, mirrors pipeline._solve)
            us32 = usd.hi + usd.lo
            glo32 = lb32 - us32
            ghi32 = us32 - ub32
            J = J + jnp.sum(
                lam_lo32 * glo32 + lam_hi32 * ghi32
                + 0.5 * (im_lo32 * glo32 * glo32
                         + im_hi32 * ghi32 * ghi32), axis=(0, 1))

        bk = lambda x: jnp.moveaxis(x, -1, 0)
        qs = jnp.zeros((B, N + 1, 4, 4), dtp)
        qs = qs.at[:, :, :3, :3].set(bk(qRd.hi))
        qs = qs.at[:, :, :3, 3].set(bk(qpd.hi))
        qs = qs.at[:, :, 3, 3].set(1.0)
        return DFState(qs=qs, xis=bk(xid.hi), us_hi=bk(usd.hi),
                       us_lo=bk(usd.lo),
                       J_opt=J, grad_norm=g)
