"""Lane-layout MS-iLQR pipeline for the SE(3) family (fastest path).

The solver keeps its whole state in "lane layout" — every array carries
the batch of problems on its trailing axis, (stage, ..., B) — from entry to
exit, so no per-iteration layout conversion touches the large Jacobian and
Hessian tensors.  One iteration is two stage recursions
(`ops/lanewise.lane_scan`), each over the same lane-layout stage functions:

  - the defect-aware Riccati backward pass (`riccati_stage`), seeded by the
    terminal quadratization;
  - the gap-closing rollout (`rollout_stage`) fused with the linearization
    of the NEW trajectory (`linearize_stage`): the rollout's dynamics
    evaluation is the linearizer's, so no separate linearize pass runs
    inside the loop.

Each recursion runs as one generated CUDA kernel with one thread per
problem on the GPU (``kernels=True``, the default there) or as a
`lax.scan` that XLA compiles (the plain reference, the default on the
CPU).  The one linearization
before the loop has no cross-stage carry and is plain XLA (a vmap over
stages).

Specializations: Fu and Luu are constants for the SE(3) free body + GN
tracking cost (Lux = 0); Exp(d_q) and f(x)^-1 are computed inside the
rollout step.

Scope: se3_dynamics (or the gravity/drone family) + GN tracking cost,
fixed iteration budget, mu = 0 — the MPC/throughput configuration (same
iterates as FastBatchSolver; see tests/test_pipeline.py).
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from trajectory_optimization_matrix_lie_groups.ops import dfx
from trajectory_optimization_matrix_lie_groups.ops import lie_lane as ll
from trajectory_optimization_matrix_lie_groups.ops.lanewise import (
    lane_scan,
)
from trajectory_optimization_matrix_lie_groups.ops.stage_linearize import (
    stage_cost_quad,
    stage_dynamics_eval,
    stage_jacobian,
)
from trajectory_optimization_matrix_lie_groups.utils.platform import (
    kernel_platform,
)

NX, NU = 12, 6


# -- Riccati backward, const-Fu/Luu specialization ---------------------------

def chol_factor_lane(Quu, nu):
    """Lane-batched nu x nu Cholesky (unrolled); DF-polymorphic.

    The DIAGONAL IS STORED AS ITS RECIPROCAL (L[j][j] = 1/sqrt(pivot)):
    the factorization computes that reciprocal anyway for the column
    scaling, and `chol_solve_lane` then multiplies instead of dividing —
    the two triangular solves hit the diagonal 2*nu*p times per stage and
    a VPU divide costs several multiplies.  Only the pivot updates read
    L entries, and those touch off-diagonals exclusively."""
    L = [[None] * nu for _ in range(nu)]
    for j in range(nu):
        sv = Quu[j, j, :]
        for kk in range(j):
            sv = sv - L[j][kk] * L[j][kk]
        inv = 1.0 / dfx.sqrt(sv)
        L[j][j] = inv
        for i2 in range(j + 1, nu):
            sv = Quu[i2, j, :]
            for kk in range(j):
                sv = sv - L[i2][kk] * L[j][kk]
            L[i2][j] = sv * inv
    return L


def chol_solve_lane(L, Bm, nu):
    """Solve (L L^T) X = Bm for lane-layout Bm (nu, p, B); DF-polymorphic.
    ``L`` from `chol_factor_lane` (diagonal stored as reciprocal)."""
    Y = [None] * nu
    for i2 in range(nu):
        sv = Bm[i2]
        for kk in range(i2):
            sv = sv - L[i2][kk][None, :] * Y[kk]
        Y[i2] = sv * L[i2][i2][None, :]
    X = [None] * nu
    for i2 in reversed(range(nu)):
        sv = Y[i2]
        for kk in range(i2 + 1, nu):
            sv = sv - L[kk][i2][None, :] * X[kk]
        X[i2] = sv * L[i2][i2][None, :]
    rows = jax.lax.broadcasted_iota(
        jnp.int32, (nu,) + (1,) * (len(Bm.shape) - 1), 0)
    if dfx.is_df(Bm):
        # row placement into the output is plain masking — assemble the hi
        # and lo planes without DF arithmetic
        Xp = [dfx.promote(x) for x in X]
        out_hi = jnp.zeros_like(Bm.hi)
        out_lo = jnp.zeros_like(Bm.lo)
        for i2 in range(nu):
            oh = (rows == i2).astype(Bm.dtype)
            out_hi = out_hi + oh * Xp[i2].hi[None]
            out_lo = out_lo + oh * Xp[i2].lo[None]
        return dfx.DF(out_hi, out_lo)
    out = jnp.zeros_like(Bm)
    for i2 in range(nu):
        out = out + (rows == i2).astype(Bm.dtype) * X[i2][None]
    return out


def riccati_stage(fx, dd, lx_t, lu_t, lxx_t, fu2, fu2T, Luu, Vx, Vxx,
                  *, nu, glow, half=6, luual_t=None):
    """One defect-aware Riccati step on lane-layout values; DF-polymorphic.

    Math per `solvers/lie_ilqr.py` / the reference's MS backward pass
    (traopt_controller.py:1741-1748), exploiting the Lie-family block
    structure: Fu = [0; fu2] (fu2 = bottom ``half`` rows — constant for the
    SE(3) free body, per-stage for the 3-D pendulum), Lux = 0, and
    Fx = [[A, Bb], [C, D]] with C = 0 unless ``glow`` (the gravity J_xi_q /
    pendulum L block).  ``half`` is the pose-block dimension: 6 for SE(3)
    (nx = 12), 3 for the SO(3) family (nx = 6).
    Returns (k, K, Qu, Vx_new, Vxx_new)."""
    h = half
    nx = 2 * h
    A, Bb, D = fx[:h, :h], fx[:h, h:], fx[h:, h:]
    AT, BbT, DT = ll.transpose(A), ll.transpose(Bb), ll.transpose(D)

    Vmod = Vx + ll.matvec(Vxx, dd, nx)
    Qx_top = ll.matvec(AT, Vmod[:h], h)
    Qx_bot = ll.matvec(BbT, Vmod[:h], h) + ll.matvec(DT, Vmod[h:], h)
    VF_l = ll.matmul(Vxx[:, :h], A, h)
    VF_r = ll.matmul(Vxx[:, :h], Bb, h) + ll.matmul(Vxx[:, h:], D, h)
    if glow:
        C = fx[h:, :h]
        CT = ll.transpose(C)
        Qx_top = Qx_top + ll.matvec(CT, Vmod[h:], h)
        VF_l = VF_l + ll.matmul(Vxx[:, h:], C, h)
    Qx = lx_t + dfx.concatenate([Qx_top, Qx_bot], axis=0)
    Qu = lu_t + ll.matvec(fu2T, Vmod[h:], h)
    VF = dfx.concatenate([VF_l, VF_r], axis=1)
    Qxx_top = ll.matmul(AT, VF[:h], h)
    if glow:
        Qxx_top = Qxx_top + ll.matmul(CT, VF[h:], h)
    Qxx_bot = ll.matmul(BbT, VF[:h], h) + ll.matmul(DT, VF[h:], h)
    Qxx = lxx_t + dfx.concatenate([Qxx_top, Qxx_bot], axis=0)
    Qux = ll.matmul(fu2T, VF[h:], h)                   # Lux = 0
    Quu = Luu + ll.matmul(fu2T,
                           ll.matmul(Vxx[h:, h:], fu2, h), h)
    if luual_t is not None:
        # diagonal AL penalty add via a one-hot mask (folds to nu adds in
        # the generated kernels)
        nb1 = (1,) * (len(Quu.shape) - 2)
        r_i = jax.lax.broadcasted_iota(jnp.int32, (nu, nu) + nb1, 0)
        c_i = jax.lax.broadcasted_iota(jnp.int32, (nu, nu) + nb1, 1)
        eye = (r_i == c_i).astype(Quu.dtype)
        Quu = Quu + eye * luual_t[:, None]

    L = chol_factor_lane(Quu, nu)
    K = -chol_solve_lane(L, Qux, nu)
    k = -chol_solve_lane(L, Qu[:, None, :], nu)[:, 0, :]

    KT = ll.transpose(K)
    QuxT = ll.transpose(Qux)
    KTQuu = ll.matmul(KT, Quu, nu)
    Vx_new = (Qx + ll.matvec(KTQuu, k, nu) + ll.matvec(KT, Qu, nu)
              + ll.matvec(QuxT, k, nu))
    # KT Qux + QuxT K = M + M^T exactly (transpose of a product), so
    # one matmul + the symmetrized (Qxx + KTQuu K) term gives the same
    # symmetrized V_xx as the 3-matmul form
    M = ll.matmul(KT, Qux, nu)
    S = Qxx + ll.matmul(KTQuu, K, nu)
    Vxx_new = 0.5 * (S + ll.transpose(S)) + M + ll.transpose(M)
    return k, K, Qu, Vx_new, Vxx_new


# -- rollout ------------------------------------------------------------------

def rollout_stage(R_new, p_new, xi_new, qR_t, qp_t, qRn_t, qpn_t, xi_t,
                  xin_t, u_t, k_t, K_t, d_t, fqR_t, fqp_t, fxi_t,
                  Jl, Jil, Pu, mg, *, dt, gravity):
    """One gap-closing rollout step on lane-layout values; DF-polymorphic.

    Mirrors the reference's MS forward pass (traopt_controller.py:2697-2726):
    feedback on the tangent-space deviation from the nominal, then the
    group composition x+ = x_next Exp(d) f(xbar)^-1 f(x_new).
    Returns (R_nn, p_nn, xi_nn, u_new, fqR_n, fqp_n, fxi_new)."""
    Ri_inv, pi_inv = ll.se3_inverse(qR_t, qp_t)
    Re, pe = ll.se3_compose(Ri_inv, pi_inv, R_new, p_new)
    xs_err = dfx.concatenate(
        [ll.se3_log(Re, pe), xi_new - xi_t], axis=0)

    u_new = u_t + k_t + sum(
        K_t[:, j, :] * xs_err[j:j + 1, :] for j in range(NX))

    fqR_n, fqp_n, fxi_new = stage_dynamics_eval(
        R_new, p_new, xi_new, u_new, Jl, Jil, Pu, mg,
        dt=dt, gravity=gravity)

    edR, edp = ll.se3_exp(d_t[:6])
    fiR, fip = ll.se3_inverse(fqR_t, fqp_t)
    R_a, p_a = ll.se3_compose(qRn_t, qpn_t, edR, edp)
    R_b, p_b = ll.se3_compose(R_a, p_a, fiR, fip)
    R_nn, p_nn = ll.se3_compose(R_b, p_b, fqR_n, fqp_n)
    R_nn = ll.so3_normalize(R_nn)
    xi_nn = xin_t + fxi_new - fxi_t + d_t[6:]
    return R_nn, p_nn, xi_nn, u_new, fqR_n, fqp_n, fxi_new


def linearize_stage(R, p, xi, u, Rn, pn, xin, RbiR, Rbip, Adb, xib, Jl, Jil,
                    W1, W2, Pu, mg, *, dt, gravity, exact_grav, evals=None):
    """Linearization + GN quadratization of one stage on lane-layout values:

        dynamics eval   fq = normalize(q Exp(xi dt)),  fxi (Euler-Poincare)
        defect          d = [Log(q_{i+1}^-1 fq); fxi - xi_{i+1}]
        dynamics jac    Fx = [[Ad(Exp(-tau)), Jr(tau) dt], [0, I + H dt]]
        cost quad       e = Log(q qbar^-1),  J_e_x = Jr^-1(e) Ad(qbar)

    ``evals``: a dynamics evaluation (fqR, fqp, fxi) already made at
    (R, p, xi, u) — the rollout's — to reuse instead of recomputing.
    Returns dict(fqR, fqp, fxi, d, Fx, lx, lxx, l) with l of shape (1, B)."""
    if evals is None:
        evals = stage_dynamics_eval(R, p, xi, u, Jl, Jil, Pu, mg, dt=dt,
                                    gravity=gravity)
    fqR, fqp, fxi = evals
    Rni, pni = ll.se3_inverse(Rn, pn)
    Rd, pd = ll.se3_compose(Rni, pni, fqR, fqp)
    d = dfx.concatenate([ll.se3_log(Rd, pd), fxi - xin], axis=0)
    Fx = stage_jacobian(R, xi, Jl, Jil, mg, dt=dt, gravity=gravity,
                        exact_grav=exact_grav)
    lx, lxx, l_val = stage_cost_quad(R, p, xi, RbiR, Rbip, Adb, xib, W1, W2)
    return dict(fqR=fqR, fqp=fqp, fxi=fxi, d=d, Fx=Fx, lx=lx, lxx=lxx,
                l=l_val[None])


# -- the two stage recursions (`lane_scan` init/step pairs) -------------------

def backward_init(c):
    """Value-function carry from the terminal quadratization."""
    lxN, lxxN, lN = stage_cost_quad(
        c["qRN"], c["qpN"], c["xiN"], c["RbiRN"], c["RbipN"], c["AdbN"],
        c["xibN"], c["W1N"], c["W2N"])
    return (lxN, lxxN), lN[None]


def backward_step(c, carry, x, *, nu, glow):
    """One Riccati stage.  Emits the gains and the per-stage MS gradient
    Qu = lu + Fu^T (V_x[t+1] + V_xx[t+1] d[t]) (so the (N, 12, 12, B)
    value tensor never reaches memory)."""
    Vx, Vxx = carry
    fu2 = c["Fu"][6:]
    k, K, Qu, Vx, Vxx = riccati_stage(
        x["Fx"], x["d"], x["lx"], x["lu"], x["lxx"], fu2,
        ll.transpose(fu2), c["Luu"], Vx, Vxx, nu=nu, glow=glow,
        luual_t=x.get("luual"))
    return (Vx, Vxx), dict(k=k, K=K, gvec=Qu)


def rollout_init(c):
    return (c["R0"], c["p0"], c["xi0"]), ()


def rollout_linearize_step(c, carry, x, *, dt, gravity, exact_grav):
    """Gap-closing rollout of stage t fused with the linearization of stage
    t of the NEW trajectory: the rollout's dynamics evaluation at the new
    (x_t, u_t) is the linearizer's, and the freshly produced x_{t+1} closes
    the defect."""
    R_new, p_new, xi_new = carry
    R_nn, p_nn, xi_nn, u_new, fqR_n, fqp_n, fxi_new = rollout_stage(
        R_new, p_new, xi_new, x["qR"], x["qp"], x["qRn"], x["qpn"], x["xi"],
        x["xin"], x["u"], x["k"], x["K"], x["d"], x["fqR"], x["fqp"],
        x["fxi"], c["Jl"], c["Jil"], c["Pu"], c["mg"], dt=dt,
        gravity=gravity)
    lin = linearize_stage(
        R_new, p_new, xi_new, u_new, R_nn, p_nn, xi_nn, x["RbiR"], x["Rbip"],
        x["Adb"], x["xib"], c["Jl"], c["Jil"], c["W1"], c["W2"], c["Pu"],
        c["mg"], dt=dt, gravity=gravity, exact_grav=exact_grav,
        evals=(fqR_n, fqp_n, fxi_new))
    return (R_nn, p_nn, xi_nn), dict(R=R_nn, p=p_nn, xi=xi_nn, u=u_new,
                                     **lin)


class PipelineState(NamedTuple):
    qs: jnp.ndarray    # (B, N+1, 4, 4)
    xis: jnp.ndarray
    us: jnp.ndarray
    J_opt: jnp.ndarray
    grad_norm: jnp.ndarray


class PipelineSolver:
    """End-to-end lane-layout MS-iLQR: per iteration, the Riccati backward
    and the rollout fused with the next linearization (module docstring).
    """

    def __init__(self, N: int, iterations: int, dt: float,
                 gravity: bool = False, exact_gravity_jacobian: bool = False,
                 kernels: bool = None):
        """``gravity`` (static) selects the rigid-body/drone dynamics family:
        pass `RigidBodyParams` as ``dyn`` (its Pu projection sets nu);
        ``exact_gravity_jacobian`` matches the flag in models/dynamics.py.

        ``kernels``: run the two stage recursions as generated kernels
        (`ops/lanewise.py`), or as XLA scans.  Default: the kernels on the
        GPU, the scans on the CPU (where the kernels are a host build for
        tests)."""
        self.N = N
        self.iterations = iterations
        self.dt = float(dt)
        self.gravity = gravity
        self.exact_grav = exact_gravity_jacobian
        self.kernels = (kernel_platform() == "cuda") if kernels is None \
            else bool(kernels)
        self._solve_jit = jax.jit(self._solve)

    def _scan(self, step, init, consts, xs, reverse=False):
        return lane_scan(step, init, consts, xs, reverse=reverse,
                         kernel=self.kernels)

    # the pieces of one iteration, on lane-layout arrays -------------------

    def _linearize_lane(self, qR, qp, xi, us, refs, consts):
        """All-stage linearization (no cross-stage carry: plain XLA)."""
        stage = functools.partial(
            linearize_stage, dt=self.dt, gravity=self.gravity,
            exact_grav=self.exact_grav)
        c = (consts["Jl"], consts["Jil"], consts["W1"], consts["W2"],
             consts["Pu"], consts["mg"])
        return jax.vmap(stage, in_axes=(0,) * 11 + (None,) * 6)(
            qR[:-1], qp[:-1], xi[:-1], us, qR[1:], qp[1:], xi[1:],
            refs["RbiR"], refs["Rbip"], refs["Adb"], refs["xib"], *c)

    def _backward_lane(self, lin, lu, term, consts, luu_al=None):
        """``term``: lane-layout terminal state + references
        (qRN, qpN, xiN, RbiRN, RbipN, AdbN, xibN, W1N, W2N), quadratized
        at the start of the recursion.  ``luu_al``: optional (N, nu, B)
        per-stage diagonal Quu additions (input-box AL penalty).
        Returns (k, K, gvec, lN)."""
        names = ("qRN", "qpN", "xiN", "RbiRN", "RbipN", "AdbN", "xibN",
                 "W1N", "W2N")
        c = dict(zip(names, term), Fu=consts["Fu"], Luu=consts["Luu"])
        xs = dict(Fx=lin["Fx"], d=lin["d"], lx=lin["lx"], lu=lu,
                  lxx=lin["lxx"])
        if luu_al is not None:
            xs["luual"] = luu_al
        step = functools.partial(backward_step, nu=lu.shape[-2],
                                 glow=self.gravity)
        ys, lN = self._scan(step, backward_init, c, xs, reverse=True)
        return ys["k"], ys["K"], ys["gvec"], lN[0]

    def _rollout_linearize_lane(self, qR, qp, xi, us, k, K, lin, refs,
                                consts):
        """Fused rollout + next-iteration linearization.  Returns the new
        (qR, qp, xi, us) and the new trajectory's linearization."""
        c = dict(R0=qR[0], p0=qp[0], xi0=xi[0], Jl=consts["Jl"],
                 Jil=consts["Jil"], W1=consts["W1"], W2=consts["W2"],
                 Pu=consts["Pu"], mg=consts["mg"])
        xs = dict(qR=qR[:-1], qp=qp[:-1], qRn=qR[1:], qpn=qp[1:],
                  xi=xi[:-1], xin=xi[1:], u=us, k=k, K=K, d=lin["d"],
                  fqR=lin["fqR"], fqp=lin["fqp"], fxi=lin["fxi"], **refs)
        step = functools.partial(rollout_linearize_step, dt=self.dt,
                                 gravity=self.gravity,
                                 exact_grav=self.exact_grav)
        ys, _ = self._scan(step, rollout_init, c, xs)
        qR_new = jnp.concatenate([qR[:1], ys.pop("R")], axis=0)
        qp_new = jnp.concatenate([qp[:1], ys.pop("p")], axis=0)
        xi_new = jnp.concatenate([xi[:1], ys.pop("xi")], axis=0)
        return qR_new, qp_new, xi_new, ys.pop("u"), ys

    # ----------------------------------------------------------------------

    def _prepare(self, dyn, cost, q0s, xi0s, us0):
        """Lane-layout setup: broadcast consts/references to the lanes and
        build the initial (qR, qp, xi, us) state.  Split out of `_solve` so
        tests can drive the stage recursions individually."""
        B = q0s.shape[0]
        N = self.N
        nu = us0.shape[-1]
        dtp = us0.dtype
        lanes = lambda M: jnp.broadcast_to(
            jnp.asarray(M, dtp)[..., None], jnp.asarray(M).shape + (B,))
        Pu = getattr(dyn, "Pu", None)
        if Pu is None:
            Pu = jnp.eye(6, dtype=dtp)
        mg = (dyn.m * dyn.g if self.gravity else jnp.zeros((), dtp))
        bt6 = dyn.Jinv @ jnp.asarray(Pu, dtp)
        Fu_c = jnp.concatenate(
            [jnp.zeros_like(bt6), bt6], axis=-2) * dyn.dt  # (12, nu)
        consts = dict(
            Jl=lanes(dyn.J), Jil=lanes(dyn.Jinv),
            W1=lanes(cost.Q1), W2=lanes(cost.Q2),
            Fu=jnp.broadcast_to(jnp.asarray(Fu_c, dtp)[:, :, None],
                                (12, nu, B)),
            Luu=lanes(2.0 * cost.R),
            Pu=lanes(Pu),
            mg=jnp.broadcast_to(jnp.asarray(mg, dtp), (1, B)),
        )
        ref = lambda x: jnp.moveaxis(jnp.broadcast_to(
            jnp.asarray(x, dtp)[:, None], (x.shape[0], B) + x.shape[1:]),
            1, -1)
        refs = dict(
            RbiR=ref(cost.q_ref_inv[:-1, :3, :3]),
            Rbip=ref(cost.q_ref_inv[:-1, :3, 3]),
            Adb=ref(cost.Ad_ref[:-1]),
            xib=ref(cost.xi_ref[:-1]),
        )
        term_refs = (ref(cost.q_ref_inv[-1:, :3, :3])[0],
                     ref(cost.q_ref_inv[-1:, :3, 3])[0],
                     ref(cost.Ad_ref[-1:])[0], ref(cost.xi_ref[-1:])[0],
                     lanes(cost.P1), lanes(cost.P2))

        # initial lane-layout state: x0 + reference tail
        q_ref_b = jnp.broadcast_to(
            jnp.asarray(cost.q_ref[1:], dtp)[:, None], (N, B, 4, 4))
        qR = jnp.concatenate([jnp.moveaxis(q0s[None, :, :3, :3], 1, -1),
                              jnp.moveaxis(q_ref_b[:, :, :3, :3], 1, -1)],
                             axis=0)
        qp = jnp.concatenate([jnp.moveaxis(q0s[None, :, :3, 3], 1, -1),
                              jnp.moveaxis(q_ref_b[:, :, :3, 3], 1, -1)],
                             axis=0)
        xi_ref_b = jnp.broadcast_to(
            jnp.asarray(cost.xi_ref[1:], dtp)[:, None], (N, B, 6))
        xi = jnp.concatenate([jnp.moveaxis(xi0s[None], 1, -1),
                              jnp.moveaxis(xi_ref_b, 1, -1)], axis=0)
        us = jnp.moveaxis(us0, 0, -1)  # (N, nu, B)
        return qR, qp, xi, us, refs, consts, term_refs

    def _iterate(self, dyn, cost, q0s, xi0s, us0, al=None):
        """The fixed-budget iteration from solver-layout inputs.  Returns
        the lane-layout (qR, qp, xi, us) and the per-lane (J, grad_norm).
        ``al``: see `_solve`."""
        B = q0s.shape[0]
        dtp = us0.dtype
        nu = us0.shape[-1]
        qR, qp, xi, us, refs, consts, term_refs = self._prepare(
            dyn, cost, q0s, xi0s, us0)
        if al is not None:
            lb_a, ub_a, lmbd_a, imu_a = al
            lam_l = jnp.moveaxis(lmbd_a, 0, -1).astype(dtp)
            imu_l = jnp.moveaxis(imu_a, 0, -1).astype(dtp)
            lb_a = jnp.asarray(lb_a, dtp).reshape(1, nu, 1)
            ub_a = jnp.asarray(ub_a, dtp).reshape(1, nu, 1)
            lam_lo, lam_hi = lam_l[:-1, :nu], lam_l[:-1, nu:]
            im_lo, im_hi = imu_l[:-1, :nu], imu_l[:-1, nu:]
        R_c = jnp.asarray(cost.R, dtp)

        def backward_metrics(qR, qp, xi, us, lin):
            lu = 2.0 * jnp.einsum("ij,njb->nib", R_c, us)
            luu_al = None
            J_al = jnp.zeros((B,), dtp)
            if al is not None:
                glo = lb_a - us
                ghi = us - ub_a
                lu = lu - (lam_lo + im_lo * glo) + (lam_hi + im_hi * ghi)
                luu_al = im_lo + im_hi
                J_al = jnp.sum(
                    lam_lo * glo + lam_hi * ghi
                    + 0.5 * (im_lo * glo * glo + im_hi * ghi * ghi),
                    axis=(0, 1))
            term = (qR[-1], qp[-1], xi[-1]) + term_refs
            k, K, gvec, lN = self._backward_lane(lin, lu, term, consts,
                                                 luu_al=luu_al)
            g = jnp.mean(jnp.sqrt(jnp.sum(gvec * gvec, axis=1)), axis=0)
            J = (jnp.sum(lin["l"][:, 0], axis=0)
                 + jnp.einsum("nib,ij,njb->b", us, R_c, us) + lN + J_al)
            return k, K, J, g

        def body(_, carry):
            qR, qp, xi, us, lin, J, g = carry
            k, K, J, g = backward_metrics(qR, qp, xi, us, lin)
            qR, qp, xi, us, lin = self._rollout_linearize_lane(
                qR, qp, xi, us, k, K, lin, refs, consts)
            return qR, qp, xi, us, lin, J, g

        lin0 = self._linearize_lane(qR, qp, xi, us, refs, consts)
        init = (qR, qp, xi, us, lin0, jnp.full((B,), jnp.inf, dtp),
                jnp.full((B,), jnp.inf, dtp))
        qR, qp, xi, us, _, J, g = lax.fori_loop(0, self.iterations, body,
                                                init)
        return qR, qp, xi, us, J, g

    def _solve(self, dyn, cost, q0s, xi0s, us0, al=None):
        """dyn: SE3Params; cost: TrackingCostParams; solver-layout inputs.

        ``al``: optional input-box AL state (lb (nu,), ub (nu,),
        lmbd (B, N+1, 2nu), imu (B, N+1, 2nu) diagonal penalties) — adds the
        augmented-Lagrangian u-terms to every backward pass (the terminal
        box constraint is identically zero, models/constraints.py:38)."""
        B = q0s.shape[0]
        qR, qp, xi, us, J, g = self._iterate(dyn, cost, q0s, xi0s, us0, al)
        bk = lambda x: jnp.moveaxis(x, -1, 0)
        qs = jnp.zeros((B, self.N + 1, 4, 4), us.dtype)
        qs = qs.at[:, :, :3, :3].set(bk(qR))
        qs = qs.at[:, :, :3, 3].set(bk(qp))
        qs = qs.at[:, :, 3, 3].set(1.0)
        return PipelineState(qs=qs, xis=bk(xi), us=bk(us), J_opt=J,
                             grad_norm=g)

    def solve(self, dyn, cost, q0s, xi0s, us0, al=None):
        return self._solve_jit(dyn, cost, jnp.asarray(q0s), jnp.asarray(xi0s),
                               jnp.asarray(us0), al)
