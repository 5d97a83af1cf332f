"""Lane-layout MS-iLQR pipeline for the SO(3) family.

SE(3)-family problems run on `solvers/pipeline.PipelineSolver`; this
module is its SO(3) twin covering BOTH SO(3)-family dynamics of the
reference:

  - free rigid-body attitude (`SO3Dynamics`, traopt_dynamics.py:275-419):
    constant Fu = [0; Jinv] dt;
  - the 3-D pendulum actuated at the pivot (`Pendulum3dDyanmics`,
    traopt_dynamics.py:421-627): gravity torque hat(m g rho) R^T down and
    input moment hat(m rho) R^T u — both state-dependent — giving a
    PER-STAGE Fu = [0; Jinv hat(m rho) R^T] dt that rides the Riccati scan
    as one extra per-stage input.

Same fused layout as the SE(3) pipeline (Riccati backward; rollout fused
with the next iteration's linearization), each a `lax.scan` over the
lane-layout stage functions that XLA compiles; state dim nx = 6 (pose
half 3), nu = 3.  The Riccati stage math is shared
(`pipeline.riccati_stage(half=3, glow=pendulum)` — the pendulum's L block
occupies the same bottom-left slot as the SE(3) gravity J_xi_q block).

The terminal quadratization replicates the reference SO(3) cost class's
quirk (value+gradient from Q, Hessian from P — traopt_cost.py:477-487 vs
:526-531; `models/costs.py` docstring) behind ``term_quirk`` (default True,
matching every SO(3)-family parity build).
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from trajectory_optimization_matrix_lie_groups.ops import lie_lane as ll
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    riccati_stage,
)

NX, NU, H = 6, 3, 3


def _cross(a, b):
    return ll._vec([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


# -- stage math (lane layout) --------------------------------------------------

def so3_stage_dynamics_eval(R, xi, u, Jl, Jil, mgr, mr, *, dt, pendulum):
    """Euler step: fq = normalize(R Exp(xi dt)); fxi = xi + dt Jinv torque
    with torque = hat(xi)^T J xi + u (free) or + gravity/input moments
    (pendulum; models/dynamics.py:135-146)."""
    Re = ll.so3_exp(xi * dt)
    fqR = ll.so3_normalize(ll.matmul3(R, Re))
    Jxi = ll.matvec3(Jl, xi)
    torque = -_cross(xi, Jxi)
    if pendulum:
        Rt = ll.transpose(R)
        Rtd = -R[2]                      # R^T (0,0,-1) = -(third row of R)
        torque = torque + _cross(mgr, Rtd) + _cross(mr, ll.matvec3(Rt, u))
    else:
        torque = torque + u
    fxi = xi + dt * ll.matvec3(Jil, torque)
    return fqR, fxi


def so3_stage_jacobian(R, xi, u, Jl, Jil, mgr, mr, *, dt, pendulum):
    """Lane-layout (Fx, fu2): Fx = [[Exp(-tau), Jr(tau) dt], [L dt, I+H dt]]
    (L = 0 for the free body), fu2 = bottom half of Fu
    (models/dynamics.py:90-103 free, :148-168 pendulum)."""
    bs = xi.shape[1:]  # trailing batch dims
    dtp = xi.dtype
    tau = xi * dt
    J_q_q = ll.so3_exp(-tau)
    J_q_xi = ll.so3_left_jacobian(-tau) * dt    # Jr(tau) dt
    G = ll.hat(ll.matvec3(Jl, xi))
    H_blk = ll.matmul3(Jil, G - ll.matmul3(ll.hat(xi), Jl))
    eye = ll._eye3(dtp, bs)
    D = eye + H_blk * dt
    if pendulum:
        Rt = ll.transpose(R)
        # hat(down) R with down = (0,0,-1): rows (R[1], -R[0], 0)
        z = jnp.zeros_like(R[0, 0])
        hdR = ll._mat3([[R[1, 0], R[1, 1], R[1, 2]],
                         [-R[0, 0], -R[0, 1], -R[0, 2]],
                         [z, z, z]])
        L1 = ll.matmul3(ll.hat(mgr), ll.matmul3(Rt, hdR))
        L2 = ll.matmul3(ll.hat(mr),
                         ll.matmul3(Rt, ll.matmul3(ll.hat(u), R)))
        C = ll.matmul3(Jil, L1 + L2) * dt
        fu2 = ll.matmul3(Jil, ll.matmul3(ll.hat(mr), Rt)) * dt
    else:
        C = jnp.zeros((3, 3) + bs, dtp)
        fu2 = Jil * dt
    return ll.blk(J_q_q, J_q_xi, C, D), fu2


def so3_stage_cost_quad(R, xi, RbiR, xib, W1v, W2v, W1h, W2h):
    """GN tracking quadratization on SO(3): e = Log(R Rref^-1),
    J_e_x = Jr^-1(e) Ad(Rref) with Ad(Rref) = Rref = RbiR^T.

    (W1v, W2v) weight the value+gradient, (W1h, W2h) the Hessian — equal
    for stage costs; the terminal SO(3) quirk passes (Q, P)
    (traopt_cost.py:477-487 vs :526-531).  Returns (lx, lxx, l)."""
    bs = xi.shape[1:]
    dtp = xi.dtype
    e = ll.so3_log(ll.matmul3(R, RbiR))
    ev = xi - xib
    Adb = ll.transpose(RbiR)
    Jex = ll.matmul3(ll.so3_left_jacobian_inv(-e), Adb)   # Jr_inv(e) Adb
    JT2 = 2.0 * ll.transpose(Jex)
    W1e = ll.matvec3(W1v, e)
    W2ev = ll.matvec3(W2v, ev)
    lx = jnp.concatenate([ll.matvec3(JT2, W1e), 2.0 * W2ev], axis=0)
    H_e = ll.matmul3(ll.matmul3(2.0 * ll.transpose(Jex), W1h), Jex)
    Z = jnp.zeros((3, 3) + bs, dtp)
    lxx = ll.blk(H_e, Z, Z, 2.0 * W2h)
    l_val = (sum(e[i] * W1e[i] for i in range(3))
             + sum(ev[i] * W2ev[i] for i in range(3)))
    return lx, lxx, l_val


def so3_rollout_stage(R_new, xi_new, R_t, Rn_t, xi_t, xin_t, u_t, k_t, K_t,
                      d_t, fqR_t, fxi_t, Jl, Jil, mgr, mr, *, dt, pendulum):
    """Gap-closing rollout step (SO(3) twin of pipeline.rollout_stage;
    ref traopt_controller.py:1383-1407)."""
    xs_err = jnp.concatenate(
        [ll.so3_log(ll.matmul3(ll.transpose(R_t), R_new)),
         xi_new - xi_t], axis=0)
    u_new = u_t + k_t + sum(
        K_t[:, j, :] * xs_err[j:j + 1, :] for j in range(NX))
    fqR_n, fxi_n = so3_stage_dynamics_eval(
        R_new, xi_new, u_new, Jl, Jil, mgr, mr, dt=dt, pendulum=pendulum)
    R_a = ll.matmul3(Rn_t, ll.so3_exp(d_t[:3]))
    R_b = ll.matmul3(R_a, ll.transpose(fqR_t))
    R_nn = ll.so3_normalize(ll.matmul3(R_b, fqR_n))
    xi_nn = xin_t + fxi_n - fxi_t + d_t[3:]
    return R_nn, xi_nn, u_new, fqR_n, fxi_n


def so3_linearize_stage(R, xi, u, Rn, xin, RbiR, xib, Jl, Jil, W1, W2, mgr,
                        mr, *, dt, pendulum, evals=None):
    """Linearization + GN quadratization of one stage (defect against the
    next state).  ``evals``: the rollout's (fqR, fxi) at (R, xi, u), reused
    instead of recomputed."""
    if evals is None:
        evals = so3_stage_dynamics_eval(R, xi, u, Jl, Jil, mgr, mr, dt=dt,
                                        pendulum=pendulum)
    fqR, fxi = evals
    d = jnp.concatenate(
        [ll.so3_log(ll.matmul3(ll.transpose(Rn), fqR)), fxi - xin],
        axis=0)
    Fx, fu2 = so3_stage_jacobian(R, xi, u, Jl, Jil, mgr, mr, dt=dt,
                                 pendulum=pendulum)
    lx, lxx, l_val = so3_stage_cost_quad(R, xi, RbiR, xib, W1, W2, W1, W2)
    return dict(fqR=fqR, fxi=fxi, d=d, Fx=Fx, fu2=fu2, lx=lx, lxx=lxx,
                l=l_val[None])


class SO3PipelineState(NamedTuple):
    qs: jnp.ndarray    # (B, N+1, 3, 3)
    xis: jnp.ndarray   # (B, N+1, 3)
    us: jnp.ndarray    # (B, N, 3)
    J_opt: jnp.ndarray
    grad_norm: jnp.ndarray


class SO3PipelineSolver:
    """End-to-end lane-layout MS-iLQR for SO(3) attitude / 3-D pendulum:
    per iteration the Riccati backward and the rollout fused with the next
    linearization, at a fixed iteration budget, mu = 0 — the
    MPC/throughput configuration, iterate-identical to `FastBatchSolver`
    (tests/test_pipeline_so3.py)."""

    def __init__(self, N: int, iterations: int, dt: float,
                 pendulum: bool = False, term_quirk: bool = True):
        self.N = N
        self.iterations = iterations
        self.dt = float(dt)
        self.pendulum = pendulum
        self.term_quirk = term_quirk
        self._solve_jit = jax.jit(self._solve)

    def _linearize_lane(self, qR, xi, us, refs, consts):
        stage = functools.partial(so3_linearize_stage, dt=self.dt,
                                  pendulum=self.pendulum)
        cs = (consts["Jl"], consts["Jil"], consts["W1"], consts["W2"],
              consts["mgr"], consts["mr"])
        return jax.vmap(stage, in_axes=(0,) * 7 + (None,) * 6)(
            qR[:-1], xi[:-1], us, qR[1:], xi[1:], refs["RbiR"], refs["xib"],
            *cs)

    def _backward_lane(self, lin, lu, term, consts):
        qRN, xiN, RbiRN, xibN, W1vN, W2vN, W1hN, W2hN = term
        lxN, lxxN, lN = so3_stage_cost_quad(qRN, xiN, RbiRN, xibN, W1vN,
                                            W2vN, W1hN, W2hN)
        Luu = consts["Luu"]

        def step(carry, x):
            Fx, fu2, d, lx, lu_t, lxx = x
            k, K, Qu, Vx, Vxx = riccati_stage(
                Fx, d, lx, lu_t, lxx, fu2, ll.transpose(fu2), Luu, *carry,
                nu=NU, glow=self.pendulum, half=H)
            return (Vx, Vxx), (k, K, Qu)

        xs = (lin["Fx"], lin["fu2"], lin["d"], lin["lx"], lu, lin["lxx"])
        _, (k, K, gvec) = lax.scan(step, (lxN, lxxN), xs, reverse=True)
        return k, K, gvec, lN

    def _rollout_linearize_lane(self, qR, xi, us, k, K, lin, refs, consts):
        Jl, Jil, mgr, mr = (consts[n] for n in ("Jl", "Jil", "mgr", "mr"))
        W1, W2 = consts["W1"], consts["W2"]

        def step(carry, x):
            R_new, xi_new = carry
            (R_t, Rn_t, xi_t, xin_t, u_t, k_t, K_t, d_t, fqR_t, fxi_t,
             RbiR_t, xib_t) = x
            R_nn, xi_nn, u_new, fqR_n, fxi_n = so3_rollout_stage(
                R_new, xi_new, R_t, Rn_t, xi_t, xin_t, u_t, k_t, K_t, d_t,
                fqR_t, fxi_t, Jl, Jil, mgr, mr, dt=self.dt,
                pendulum=self.pendulum)
            new_lin = so3_linearize_stage(
                R_new, xi_new, u_new, R_nn, xi_nn, RbiR_t, xib_t, Jl, Jil,
                W1, W2, mgr, mr, dt=self.dt, pendulum=self.pendulum,
                evals=(fqR_n, fxi_n))
            return (R_nn, xi_nn), (R_nn, xi_nn, u_new, new_lin)

        xs = (qR[:-1], qR[1:], xi[:-1], xi[1:], us, k, K, lin["d"],
              lin["fqR"], lin["fxi"], refs["RbiR"], refs["xib"])
        _, (oR, oxi, ou, new_lin) = lax.scan(step, (qR[0], xi[0]), xs)
        qR_new = jnp.concatenate([qR[:1], oR], axis=0)
        xi_new = jnp.concatenate([xi[:1], oxi], axis=0)
        return qR_new, xi_new, ou, new_lin

    # ----------------------------------------------------------------------

    def _prepare(self, dyn, cost, q0s, xi0s, us0):
        B = q0s.shape[0]
        N = self.N
        dtp = us0.dtype
        lanes = lambda M: jnp.broadcast_to(
            jnp.asarray(M, dtp)[..., None], jnp.asarray(M).shape + (B,))
        if self.pendulum:
            rho = (dyn.l / 2.0) * jnp.asarray([0.0, 0.0, -1.0], dtp)
            mgr = lanes(dyn.m * dyn.g * rho)
            mr = lanes(dyn.m * rho)
        else:
            mgr = lanes(jnp.zeros(3, dtp))
            mr = lanes(jnp.zeros(3, dtp))
        consts = dict(
            Jl=lanes(dyn.J), Jil=lanes(dyn.Jinv),
            W1=lanes(cost.Q1), W2=lanes(cost.Q2),
            Luu=lanes(2.0 * cost.R), mgr=mgr, mr=mr,
        )
        ref = lambda x: jnp.moveaxis(
            jnp.broadcast_to(x[:, None], (x.shape[0], B) + x.shape[1:]),
            1, -1)
        refs = dict(
            RbiR=ref(cost.q_ref_inv[:-1]),
            xib=ref(cost.xi_ref[:-1]),
        )
        q_ref_b = jnp.broadcast_to(cost.q_ref[1:][:, None], (N, B, 3, 3))
        qR = jnp.concatenate([jnp.moveaxis(q0s[None], 1, -1),
                              jnp.moveaxis(q_ref_b, 1, -1)], axis=0)
        xi_ref_b = jnp.broadcast_to(cost.xi_ref[1:][:, None], (N, B, 3))
        xi = jnp.concatenate([jnp.moveaxis(xi0s[None], 1, -1),
                              jnp.moveaxis(xi_ref_b, 1, -1)], axis=0)
        us = jnp.moveaxis(us0, 0, -1)
        return qR, xi, us, refs, consts

    def _solve(self, dyn, cost, q0s, xi0s, us0):
        B = q0s.shape[0]
        dtp = us0.dtype
        qR, xi, us, refs, consts = self._prepare(dyn, cost, q0s, xi0s, us0)
        lanes = lambda M: jnp.broadcast_to(
            jnp.asarray(M, dtp)[..., None], jnp.asarray(M).shape + (B,))
        ref = lambda x: jnp.moveaxis(
            jnp.broadcast_to(x[:, None], (x.shape[0], B) + x.shape[1:]),
            1, -1)
        RbiR_N = ref(cost.q_ref_inv[-1:])[0]
        xib_N = ref(cost.xi_ref[-1:])[0]
        # terminal quirk: value+gradient weights Q, Hessian weights P
        W1vN = lanes(cost.Q1 if self.term_quirk else cost.P1)
        W2vN = lanes(cost.Q2 if self.term_quirk else cost.P2)
        W1hN = lanes(cost.P1)
        W2hN = lanes(cost.P2)

        def backward_metrics(qR, xi, us, lin):
            lu = 2.0 * jnp.einsum("ij,nj...->ni...", cost.R.astype(dtp), us)
            term = (qR[-1], xi[-1], RbiR_N, xib_N, W1vN, W2vN, W1hN, W2hN)
            k, K, gvec, lN = self._backward_lane(lin, lu, term, consts)
            g = jnp.mean(jnp.sqrt(jnp.sum(gvec * gvec, axis=1)), axis=0)
            J = jnp.sum(lin["l"][:, 0], axis=0) + \
                jnp.einsum("ni...,ij,nj...->...", us, cost.R.astype(dtp),
                           us) + lN
            return k, K, J, g

        def body(_, carry):
            qR, xi, us, lin, J, g = carry
            k, K, J, g = backward_metrics(qR, xi, us, lin)
            qR, xi, us, lin = self._rollout_linearize_lane(
                qR, xi, us, k, K, lin, refs, consts)
            return qR, xi, us, lin, J, g

        lin0 = self._linearize_lane(qR, xi, us, refs, consts)
        init = (qR, xi, us, lin0, jnp.full((B,), jnp.inf, dtp),
                jnp.full((B,), jnp.inf, dtp))
        qR, xi, us, _, J, g = lax.fori_loop(0, self.iterations, body, init)

        bk = lambda x: jnp.moveaxis(x, -1, 0)
        return SO3PipelineState(qs=bk(qR), xis=bk(xi), us=bk(us), J_opt=J,
                                grad_norm=g)

    def solve(self, dyn, cost, q0s, xi0s, us0):
        return self._solve_jit(dyn, cost, jnp.asarray(q0s),
                               jnp.asarray(xi0s), jnp.asarray(us0))
