"""Mixed-precision DF polish (solvers/df_mixed.py): stage-math equivalence
to the full-DF stage functions at f32 grade (the preconditioner parts), DF
grade on the residual path, and parity-tier convergence to the f64 fixed
point inside the 1e-4 BASELINE gate.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops import dfx
from trajectory_optimization_matrix_lie_groups.ops import lie_lane as ll
from trajectory_optimization_matrix_lie_groups.ops.stage_linearize import (
    stage_cost_quad,
)
from trajectory_optimization_matrix_lie_groups.solvers.df_mixed import (
    MixedDFPipelineSolver,
    riccati_stage_mx,
    stage_cost_quad_mx,
)
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    riccati_stage,
)

RNG = np.random.default_rng(11)


def _df_of(x64):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return dfx.DF(jnp.asarray(hi), jnp.asarray(lo))


def _join(d):
    return np.asarray(d.hi, np.float64) + np.asarray(d.lo, np.float64)


def _psd(n, B, scale=1.0):
    A = RNG.normal(size=(B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) / n * scale + \
        0.1 * np.eye(n)[None] * scale
    return np.moveaxis(M, 0, -1).copy()  # lane layout (n, n, B)


def test_riccati_stage_mx_matches_full_df():
    """Same Riccati formula: the mixed stage's K/Vxx agree with the full-DF
    stage at f32 grade, its Qu/Vx (residual path) at better-than-f32 grade,
    and its k at f32 RELATIVE grade — on random (non-converged) data the
    absolute f32-chain terms dominate, so tolerances are f32-scale."""
    B, nu, h = 16, 6, 6
    lane = lambda a: np.moveaxis(a, 0, -1).copy()
    fx = _df_of(lane(RNG.normal(size=(B, 12, 12)) * 0.3
                     + np.eye(12)[None]))
    dd = _df_of(lane(RNG.normal(size=(B, 12)) * 1e-3))
    lx = _df_of(lane(RNG.normal(size=(B, 12))))
    lu = _df_of(lane(RNG.normal(size=(B, nu))))
    lxx64 = _psd(12, B)
    Vxx64 = _psd(12, B)
    Vx = _df_of(lane(RNG.normal(size=(B, 12))))
    fu2_64 = lane(RNG.normal(size=(B, h, nu)) * 0.05)
    Luu64 = _psd(nu, B, scale=0.1)

    lxx_df, Vxx_df = _df_of(lxx64), _df_of(Vxx64)
    fu2_df = _df_of(fu2_64)
    fu2T_df = ll.transpose(fu2_df)
    Luu_df = _df_of(Luu64)

    k_d, K_d, Qu_d, Vx_d, Vxx_d = riccati_stage(
        fx, dd, lx, lu, lxx_df, fu2_df, fu2T_df, Luu_df, Vx, Vxx_df,
        nu=nu, glow=False)

    fu2_32 = fu2_df.hi
    k_m, K_m, Qu_m, Vx_m, Vxx_m = riccati_stage_mx(
        fx, dd, lx, lu, lxx_df.hi, fu2_df, fu2T_df, fu2_32,
        ll.transpose(fu2_32), Luu_df.hi, Vx, Vxx_df.hi,
        nu=nu, glow=False)

    scale = np.abs(_join(Vx_d)).max()
    np.testing.assert_allclose(np.asarray(K_m), _join(K_d), atol=2e-4)
    np.testing.assert_allclose(np.asarray(Vxx_m), _join(Vxx_d),
                               rtol=0, atol=5e-4 * max(1.0, scale))
    # residual path: Qu in DF everywhere except the (vanishing-at-fixed-
    # point) V_xx d product -> error bounded by f32 eps * |Vxx||d|
    dQu = np.abs(np.asarray(Qu_m.hi, np.float64)
                 + np.asarray(Qu_m.lo, np.float64) - _join(Qu_d)).max()
    assert dQu < 1e-6, dQu
    dVx = np.abs(_join(Vx_m) - _join(Vx_d)).max()
    assert dVx < 5e-4 * max(1.0, scale), dVx
    # k: f32 with relative-only error vs the DF k
    np.testing.assert_allclose(np.asarray(k_m), _join(k_d),
                               rtol=5e-3, atol=2e-5)


def test_stage_cost_quad_mx_matches_full_df():
    B = 16
    lane = lambda a: np.moveaxis(a, 0, -1).copy()
    dq = RNG.normal(size=(B, 6)) * 0.3
    from trajectory_optimization_matrix_lie_groups.ops import se3

    q = np.asarray(se3.exp(jnp.asarray(dq, jnp.float64)))
    R = _df_of(lane(q[:, :3, :3]))
    p = _df_of(lane(q[:, :3, 3]))
    xi = _df_of(lane(RNG.normal(size=(B, 6))))
    qb = np.asarray(se3.exp(jnp.asarray(RNG.normal(size=(B, 6)) * 0.3,
                                        jnp.float64)))
    RbiR = _df_of(lane(np.swapaxes(qb[:, :3, :3], -1, -2).copy()))
    Rbip = _df_of(lane(-np.einsum("bji,bj->bi", qb[:, :3, :3],
                                  qb[:, :3, 3])))
    AdbM = np.zeros((B, 6, 6))
    AdbM[:, :3, :3] = qb[:, :3, :3]
    AdbM[:, 3:, 3:] = qb[:, :3, :3]
    Adb = _df_of(lane(AdbM))
    xib = _df_of(lane(RNG.normal(size=(B, 6))))
    W1_64 = _psd(6, B)
    W2_64 = _psd(6, B)
    W1, W2 = _df_of(W1_64), _df_of(W2_64)

    lx_d, lxx_d, l_d = stage_cost_quad(R, p, xi, RbiR, Rbip, Adb, xib,
                                       W1, W2)
    lx_m, lxx32, l32 = stage_cost_quad_mx(R, p, xi, RbiR, Rbip, Adb, xib,
                                          W1, W2, W1.hi)

    np.testing.assert_allclose(_join(lx_m), _join(lx_d), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(lxx32), _join(lxx_d),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(l32), _join(l_d),
                               rtol=2e-5, atol=1e-5)


def test_small_angle_log_and_newton_renorm():
    """The polish-rollout specializations: `so3_log_small`/`se3_log_small`
    match the f64 closed forms to DF grade inside the documented envelope
    (|theta| <= ~0.35), and one polar-Newton step restores orthogonality
    quadratically for a near-orthogonal DF rotation."""
    from trajectory_optimization_matrix_lie_groups.ops import se3

    B = 48
    w = RNG.uniform(-1, 1, (B, 3))
    w *= (RNG.uniform(1e-6, 0.34, (B, 1))
          / np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-12))
    v = RNG.uniform(-2, 2, (B, 3))
    xi = np.concatenate([w, v], axis=-1)
    q64 = np.asarray(se3.exp(jnp.asarray(xi, jnp.float64)))
    R = _df_of(np.moveaxis(q64[:, :3, :3], 0, -1).copy())
    p = _df_of(q64[:, :3, 3].T.copy())
    back = ll.se3_log_small(R, p)
    np.testing.assert_allclose(_join(back), xi.T, atol=5e-13)

    # Newton renormalization: perturb orthogonality by ~1e-7, expect
    # orthogonality restored to ~1e-14 (error squares)
    Rp = _df_of(np.moveaxis(q64[:, :3, :3]
                            + 1e-7 * RNG.normal(size=(B, 3, 3)), 0, -1))
    Rn = ll.so3_normalize_newton(Rp)
    Rn64 = np.moveaxis(_join(Rn), -1, 0)
    ortho = np.abs(np.einsum("bij,bkj->bik", Rn64, Rn64)
                   - np.eye(3)[None]).max()
    assert ortho < 5e-13, ortho


@pytest.mark.parity
@pytest.mark.parametrize("fx_mode", ["df", "hybrid"])
def test_df_mixed_hits_f64_fixed_point(fx_mode):
    """f32 phase + mixed-precision polish lands inside the 1e-4 gate vs the
    f64 oracle at the same total budget (mirror of
    test_df_pipeline_hits_f64_fixed_point; parity-marked for the multi-
    minute XLA:CPU compile of the polish graph).  'hybrid' runs the f32
    Jacobian on all but the last polish iteration — the closing
    DF-Jacobian iteration must erase the f32 bias."""
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.solvers.batched import (
        FastBatchSolver,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.df_pipeline import (
        join_us,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    H, B = 30, 3
    cp = params["cost"]
    cut = lambda a: a[: H + 1]
    cp = cp._replace(q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
                     Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))
    params = {**params, "cost": cp}

    key = jax.random.PRNGKey(0)
    dq = 0.05 * jax.random.normal(key, (B, 6), dtype=jnp.float64)
    q0s = SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 6))
    us0s = jnp.zeros((B, H, 6), jnp.float64)

    F32_ITERS, DF_ITERS = 10, 3
    fast = FastBatchSolver(solver.model, N=H, iterations=F32_ITERS + DF_ITERS)
    ref = fast.solve(params, q0s, xi0s, us0s, cp.q_ref, cp.xi_ref)
    us_ref = np.asarray(ref.us, np.float64)

    np_params = jax.tree.map(np.asarray, params)
    mx = MixedDFPipelineSolver(N=H, dt=float(params["dyn"].dt),
                               f32_iterations=F32_ITERS,
                               df_iterations=DF_ITERS, fx_mode=fx_mode)
    out = mx.solve(np_params, q0s, xi0s, us0s)
    us_mx = join_us(out)
    err = np.max(np.abs(us_mx - us_ref))
    assert err < 1e-4, err
    # gradient at the polished point is DF-grade small
    assert float(np.asarray(out.grad_norm).max()) < 1e-6
    np.testing.assert_allclose(np.asarray(out.J_opt, np.float64),
                               np.asarray(ref.J_opt, np.float64), rtol=1e-4)


def test_riccati_stage_mx_al_diag_add():
    """``luual_t`` adds the input-box AL penalty on Quu's diagonal only:
    the mixed stage with the add must match the plain stage called with
    Luu32 pre-incremented by diag(luual) — same K, k, Qu, Vx, Vxx to f32
    rounding (the two paths sum Quu's terms in different orders)."""
    B, nu, h = 8, 6, 6
    lane = lambda a: np.moveaxis(a, 0, -1).copy()
    fx = _df_of(lane(RNG.normal(size=(B, 12, 12)) * 0.3
                     + np.eye(12)[None]))
    dd = _df_of(lane(RNG.normal(size=(B, 12)) * 1e-3))
    lx = _df_of(lane(RNG.normal(size=(B, 12))))
    lu = _df_of(lane(RNG.normal(size=(B, nu))))
    lxx32 = _psd(12, B).astype(np.float32)
    Vxx32 = _psd(12, B).astype(np.float32)
    Vx = _df_of(lane(RNG.normal(size=(B, 12))))
    fu2_df = _df_of(lane(RNG.normal(size=(B, h, nu)) * 0.05))
    fu2T_df = ll.transpose(fu2_df)
    fu2_32 = fu2_df.hi
    fu2T_32 = ll.transpose(fu2_32)
    Luu32 = _psd(nu, B, scale=0.1).astype(np.float32)
    # active-set style diag: some rows zero, some large
    luual = np.abs(lane(RNG.normal(size=(B, nu)))).astype(np.float32)
    luual[::2] = 0.0

    out_al = riccati_stage_mx(
        fx, dd, lx, lu, lxx32, fu2_df, fu2T_df, fu2_32, fu2T_32,
        jnp.asarray(Luu32), Vx, jnp.asarray(Vxx32), nu=nu, glow=False,
        luual_t=jnp.asarray(luual))
    Luu_inc = Luu32 + np.eye(nu, dtype=np.float32)[..., None] * \
        luual[None, :, :]
    out_ref = riccati_stage_mx(
        fx, dd, lx, lu, lxx32, fu2_df, fu2T_df, fu2_32, fu2T_32,
        jnp.asarray(Luu_inc), Vx, jnp.asarray(Vxx32), nu=nu, glow=False)

    for a, b in zip(out_al, out_ref):
        if hasattr(a, "hi"):
            a, b = _join(a), _join(b)
        else:
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-6 * scale)
