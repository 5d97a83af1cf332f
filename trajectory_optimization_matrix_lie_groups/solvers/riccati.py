"""Parallel-prefix (associative-scan) Riccati backward pass.

The reference's backward pass is a strictly sequential per-stage recursion
(`traopt_controller.py:1637-1694`).  Here the value-function recursion is
reformulated as an associative combination of per-stage *conditional
value-function elements* (the dual parameterization of Sarkka &
Garcia-Fernandez, "Temporal Parallelization of Dynamic Programming and
Linear Quadratic ...", generalized to cross terms l_ux, linear control cost
l_u, and multiple-shooting defects), so `lax.associative_scan` computes all
V_i in O(log N) depth of large batched 12x12 ops — the parallel-prefix
shape of the Riccati sweep.

Element e = (A, b, C, eta, Jm) represents the segment cost-to-go
    S(x, z) = max_lam [ lam^T (z - A x - b) - 1/2 lam^T C lam ]
              + 1/2 x^T Jm x - eta^T x    (+ const),
with stage leaf (eliminating u from  l(x,u) + [z = Fx x + Fu u + d]):
    A  = Fx - Fu Luu^-1 Lux          b  = d - Fu Luu^-1 Lu
    C  = Fu Luu^-1 Fu^T              Jm = Lxx - Lux^T Luu^-1 Lux
    eta = Lux^T Luu^-1 Lu - Lx
and terminal element (0, 0, 0, -LxN, LxxN).  The suffix combination from
stage i yields V_i(dx) = 1/2 dx^T Jm dx - eta^T dx, i.e. Vx_i = -eta_i,
Vxx_i = Jm_i; gains then come from the standard Q-quantities in one batched
solve over all stages.

Regularization.  The reference's per-step adaptive Levenberg-Marquardt
retry (`traopt_controller.py:899-923`) is inherently sequential — each
stage's mu escalation depends on the previous stage's value function.  The
parallel-prefix equivalent implemented here is a *whole-sweep batched
retry* (`parallel_backward_adaptive`): run the O(log N) scan at the current
mu, check every stage's Quu for positive definiteness (batched Cholesky)
and the outputs for finiteness, and on failure escalate mu with the
reference's exact delta-doubling schedule and redo the sweep — a
`lax.while_loop` around the whole scan instead of around each stage.  The
accepted mu is uniform across stages (slightly more conservative than the
reference's per-step values; documented deviation per SURVEY §7 hard part
3), de-escalates on success identically, and reports the same
`exceeded` flag at mu_max.  With mu threaded through both the stage
elements (Luu + mu Fu^T Fu, Lux + mu Fu^T Fx) and the gain stage
(V + mu I), a fixed-mu parallel sweep is algebraically identical to the
sequential fixed-mu recursion (tests/test_riccati_reg.py pins this).
"""

import jax.numpy as jnp
from jax import lax


def _bmv(M, v):
    return jnp.einsum("...ij,...j->...i", M, v)


def _solve(M, B):
    return jnp.linalg.solve(M, B)


def build_elements(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu=0.0):
    """Per-stage elements + terminal element, stacked along axis 0.

    Shapes: Fx (N,n,n), Fu (N,n,m), d (N,n), Lx (N+1,n), Lu (N,m),
    Lxx (N+1,n,n), Lux (N,m,n), Luu (N,m,m).
    """
    n = Fx.shape[-1]
    # LM regularization in the reference's form Quu = Luu + fu^T (V+mu I) fu,
    # Qux = Lux + fu^T (V+mu I) fx — i.e. Luu += mu fu^T fu AND
    # Lux += mu fu^T fx at the element level (both needed for the fixed-mu
    # parallel sweep to equal the sequential fixed-mu recursion).
    LuuR = Luu + mu * jnp.einsum("nji,njk->nik", Fu, Fu)
    Lux = Lux + mu * jnp.einsum("nji,njk->nik", Fu, Fx)
    Ui_Lux = _solve(LuuR, Lux)                 # Luu^-1 Lux  (N,m,n)
    Ui_Lu = _solve(LuuR, Lu[..., None])[..., 0]  # (N,m)
    Ui_FuT = _solve(LuuR, jnp.swapaxes(Fu, -1, -2))  # (N,m,n)
    LuxT = jnp.swapaxes(Lux, -1, -2)

    A = Fx - Fu @ Ui_Lux
    b = d - _bmv(Fu, Ui_Lu)
    C = Fu @ Ui_FuT
    Jm = Lxx[:-1] - LuxT @ Ui_Lux
    eta = _bmv(LuxT, Ui_Lu) - Lx[:-1]

    # terminal element
    zN = jnp.zeros((1, n, n), dtype=Fx.dtype)
    A = jnp.concatenate([A, zN], axis=0)
    b = jnp.concatenate([b, jnp.zeros((1, n), dtype=Fx.dtype)], axis=0)
    C = jnp.concatenate([C, zN], axis=0)
    eta = jnp.concatenate([eta, -Lx[-1:]], axis=0)
    Jm = jnp.concatenate([Jm, Lxx[-1:]], axis=0)
    return A, b, C, eta, Jm


def combine(e_earlier, e_later):
    """Associative combination (earlier segment, later segment)."""
    A1, b1, C1, eta1, J1 = e_earlier
    A2, b2, C2, eta2, J2 = e_later
    n = A1.shape[-1]
    I = jnp.eye(n, dtype=A1.dtype)
    # (I + C1 J2)^-1 applied from the left
    M = I + C1 @ J2
    Minv_A1 = _solve(M, A1)
    Minv_bC = _solve(M, (b1 + _bmv(C1, eta2))[..., None])[..., 0]
    Minv_C1 = _solve(M, C1)
    # (I + J2 C1)^-1 applied from the left
    Mt = I + J2 @ C1
    Mtinv = _solve(Mt, jnp.broadcast_to(I, Mt.shape))
    A1T = jnp.swapaxes(A1, -1, -2)

    A = A2 @ Minv_A1
    b = _bmv(A2, Minv_bC) + b2
    C = A2 @ Minv_C1 @ jnp.swapaxes(A2, -1, -2) + C2
    eta = _bmv(A1T @ Mtinv, eta2 - _bmv(J2, b1)) + eta1
    J = A1T @ Mtinv @ J2 @ A1 + J1
    J = 0.5 * (J + jnp.swapaxes(J, -1, -2))
    return A, b, C, eta, J


def parallel_backward(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu=0.0):
    """All-stage gains and value functions via associative scan.

    Returns (k, K, Vx_next, Vxx_next) matching the sequential backward's
    outputs: Vx_next[i] = V_x at stage i+1 (the quantity the gradient and
    gains use).
    """
    elems = build_elements(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu)
    # Under reverse=True, associative_scan feeds the operator
    # (later-accumulated, earlier) — flip into our (earlier, later) combine.
    suffix = lax.associative_scan(lambda a, b: combine(b, a), elems,
                                  reverse=True, axis=0)
    _, _, _, eta_s, J_s = suffix
    Vx = -eta_s      # (N+1, n)
    Vxx = J_s        # (N+1, n, n)
    Vx_next = Vx[1:]
    Vxx_next = Vxx[1:]

    # batched gains from V_{i+1} (reference _Q with fixed mu)
    fuT = jnp.swapaxes(Fu, -1, -2)
    n = Fx.shape[-1]
    eye = jnp.eye(n, dtype=Fx.dtype)
    Vreg = Vxx_next + mu * eye
    Vmod = Vx_next + _bmv(Vxx_next, d)
    Qu = Lu + _bmv(fuT, Vmod)
    Qux = Lux + fuT @ Vreg @ Fx
    Quu = Luu + fuT @ Vreg @ Fu
    k = -_solve(Quu, Qu[..., None])[..., 0]
    K = -_solve(Quu, Qux)
    return k, K, Vx_next, Vxx_next


def _all_quu_pd(Fx, Fu, Luu, Vxx_next, mu):
    """Batched PD check of every stage's regularized Quu via Cholesky
    (non-PD -> NaN rows -> non-finite)."""
    n = Fx.shape[-1]
    eye = jnp.eye(n, dtype=Fx.dtype)
    fuT = jnp.swapaxes(Fu, -1, -2)
    Quu = Luu + fuT @ (Vxx_next + mu * eye) @ Fu
    Quu = 0.5 * (Quu + jnp.swapaxes(Quu, -1, -2))
    chol = jnp.linalg.cholesky(Quu)
    return jnp.all(jnp.isfinite(chol))


def parallel_backward_adaptive(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu,
                               mu, delta, mu_min=1e-6, mu_max=1e10,
                               delta_0=2.0):
    """PD-safe parallel-prefix backward: whole-sweep batched LM retry.

    The reference escalates mu per stage inside the sequential recursion
    (`traopt_controller.py:899-923`); here the O(log N) associative sweep
    runs at a single mu, every stage's Quu is Cholesky-checked in one
    batched op, and on any failure (or non-finite scan output — an
    indefinite Jm can blow up the combine) mu is escalated with the exact
    reference delta-doubling schedule and the sweep redone.  On success mu
    de-escalates for the next solver iteration, matching
    `LieILQR._backward_sequential`'s carry semantics.

    Returns (k, K, Vx_next, Vxx_next, mu_out, delta_out, exceeded) — the
    same 7-tuple as the sequential backward, so `backward='associative'`
    drops into the production solvers.
    """
    def attempt(m):
        k, K, Vx_n, Vxx_n = parallel_backward(
            Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu=m)
        ok = (_all_quu_pd(Fx, Fu, Luu, Vxx_n, m)
              & jnp.all(jnp.isfinite(k)) & jnp.all(jnp.isfinite(K))
              & jnp.all(jnp.isfinite(Vxx_n)) & jnp.all(jnp.isfinite(Vx_n)))
        return k, K, Vx_n, Vxx_n, ok

    k0, K0, Vx0, Vxx0, ok0 = attempt(mu)

    def cond(c):
        return jnp.logical_not(c[0])

    def body(c):
        _, mu_q, mu_st, dlt, exc, outs = c
        # failure path: delta' = max(1, d) * d0 ; mu' = max(mu_min, mu*delta')
        dlt_inc = jnp.maximum(1.0, dlt) * delta_0
        mu_inc = jnp.maximum(mu_min, mu_q * dlt_inc)
        hit_max = mu_inc >= mu_max
        k, K, Vx_n, Vxx_n, ok = attempt(mu_inc)
        done = ok | hit_max
        return (done, mu_inc, mu_inc, dlt_inc,
                exc | (hit_max & jnp.logical_not(ok)),
                (k, K, Vx_n, Vxx_n))

    done0 = ok0
    state = (done0, jnp.asarray(mu, Fx.dtype), jnp.asarray(mu, Fx.dtype),
             jnp.asarray(delta, Fx.dtype), jnp.asarray(False),
             (k0, K0, Vx0, Vxx0))
    done, mu_q, mu_st, dlt, exceeded, (k, K, Vx_n, Vxx_n) = lax.while_loop(
        cond, body, state)
    # success path de-escalation (ref :1657-1663 semantics)
    dlt_dec = jnp.minimum(1.0, dlt) / delta_0
    mu_dec = mu_q * dlt_dec
    mu_dec = jnp.where(mu_dec <= mu_min, 0.0, mu_dec)
    mu_out = jnp.where(exceeded, mu_q, mu_dec)
    delta_out = jnp.where(exceeded, dlt, dlt_dec)
    # On `exceeded` the last attempt may carry non-finite rows (failed
    # Cholesky); the sequential backward always returns finite gains at
    # mu_max, and nothing in the fixed-budget drivers acts on `exceeded`
    # — so sanitize branchlessly: zero gains (a no-op control update the
    # line search will reject) and the pure-cost value function where the
    # scan output went non-finite.  No-ops on the success path.
    def _fin(x, fb):
        return jnp.where(jnp.isfinite(x), x, fb)

    k = _fin(k, jnp.zeros_like(k))
    K = _fin(K, jnp.zeros_like(K))
    Vx_n = _fin(Vx_n, Lx[1:])
    Vxx_n = _fin(Vxx_n, Lxx[1:])
    return k, K, Vx_n, Vxx_n, mu_out, delta_out, exceeded
