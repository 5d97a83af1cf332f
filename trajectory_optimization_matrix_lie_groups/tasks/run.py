"""Task runner: the reference's `main_*.py` scripts as one CLI.

Usage:
    python -m trajectory_optimization_matrix_lie_groups.tasks.run <task> [--plot DIR]

Tasks mirror the reference scripts:
    cartpole            main_ddp.py
    so3_tracking        main_SO3ddp_tracking_exact.py (SS)
    so3_tracking_ms     main_SO3ddp_tracking_exact_ms.py (MS)
    pendulum3d_ms       main_pendulum3d_ddp_tracking_exact_ms.py
    se3_tracking        main_SE3ddp_tracking_exact.py (SS)
    se3_tracking_ms     main_SE3ddp_tracking_exact_ms.py (MS)
    drone_ms            main_drone_ddp_tracking_exact_ms.py
    rigid_body_ms       main_RigidBody_ddp_tracking_exact_ms.py (gravity)
    se3_al_ms           main_SE3ddp_tracking_exact_al_ms.py (input box +-10)
    errstate_tracking   main_SE3ddp_tracking_approx.py
    errstate_generate   main_errSE3ddp_nonlinear_rollout_generation.py
    errstate_generate_linear  main_errSE3ddp_linear_rollout_generation.py
    baseline_su2        main_SU2_SE3_baseline.py (embedded R^13 iLQR)
    baseline_embedded   baseline_SE3_nlpsol_embedded.py families (3 variants)
    dynamics_sim        main_SE3dynamics.py / main_errSE3dynamics.py
    cost_landscape      visualization/visual_cost_3d_fixed.py
    mpc                 (new) closed-loop receding-horizon MPC demo
    al_batch            (new) batched input-constrained solves (ALFastSolver)
    mpc_batch           (new) Monte-Carlo closed-loop MPC on the pipeline
    benchmark_compare   benchmark_SE3_tracking.py (cross-solver agreement)
    benchmark_compare_so3  benchmark_SO3_tracking.py + benchmark_pendulum_swingup.py
    sweep               visualization/perturb_all_compute.py (reduced ranges)

Benchmark problems are rebuilt from the reference pickles where available;
the AL and error-state tasks use the reference script constants.
"""

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.utils.platform import (
    setup_compile_cache,
)


def _summary(name, J_hist, grad_hist, state=None, extra=None):
    out = dict(task=name, iterations=len(J_hist),
               J_first=J_hist[0] if J_hist else None,
               J_final=J_hist[-1] if J_hist else None,
               grad_final=grad_hist[-1] if grad_hist else None)
    if state is not None and hasattr(state, "converged"):
        out["converged"] = bool(state.converged)
    if extra:
        out.update(extra)
    print(json.dumps(out))
    return out


def run_cartpole(args):
    from trajectory_optimization_matrix_lie_groups.tasks import cartpole

    xs, us, J_hist, grad_hist, state = cartpole.run(n_iterations=200)
    res = _summary("cartpole", J_hist, grad_hist, state,
                   {"final_state": np.asarray(xs[-1]).tolist()})
    if args.plot:
        from trajectory_optimization_matrix_lie_groups.viz import plots

        plots.convergence(J_hist, grad_hist, f"{args.plot}/cartpole_convergence.png")
    return res


def run_benchmark_task(name, bench_name, ms, args):
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, solver, params, x0, us0, sol_key = build_benchmark(bench_name, ms)
    t0 = time.perf_counter()
    (qs, xis), us, J_hist, grad_hist, defect_hist, state = solver.fit(params, x0, us0)
    wall = time.perf_counter() - t0
    us_ref = np.asarray(data[sol_key]["us"])
    err = float(np.max(np.abs(np.asarray(us) - us_ref)))
    res = _summary(name, J_hist, grad_hist, state,
                   {"wall_s": round(wall, 2), "us_vs_reference_max_err": err})
    if args.plot:
        from trajectory_optimization_matrix_lie_groups.viz import plots

        plots.convergence(J_hist, grad_hist, f"{args.plot}/{name}_convergence.png",
                          defect_hist=defect_hist)
        plots.trajectory_3d(np.asarray(qs), np.asarray(params["cost"].q_ref),
                            f"{args.plot}/{name}_trajectory.png")
    return res


def run_al(args):
    import dataclasses

    from trajectory_optimization_matrix_lie_groups.models import (
        constraints as cs,
        costs,
    )
    from trajectory_optimization_matrix_lie_groups.models.base import make_model
    from trajectory_optimization_matrix_lie_groups.models import dynamics
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.solvers.al_ilqr import ALILQR
    from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, solver0, params0, x0, us0, _ = build_benchmark("se3_tracking", True)
    prob = data["prob"]
    H = 200
    q_ref = jnp.asarray(np.asarray(prob["q_ref"])[: H + 1])
    xi_ref = jnp.asarray(np.asarray(prob["xi_ref"])[: H + 1])
    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(prob["J"]), float(prob["dt"]))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(SE3, prob["Q"], prob["R"], prob["P"],
                                    q_ref, xi_ref)
    constr = cs.input_box(12, 6)
    constr_p = cs.input_box_params(-100.0, 100.0, 6)
    al_cd = costs.al_cost(cd, constr)
    model_c, _ = make_model(dyn, al_cd, dp, None)
    alp = costs.al_init_params(cp, constr_p, H, constr.constr_size, mu0=1e-2)
    # production configuration of the PD-safe parallel-prefix Riccati
    # (solvers/riccati.parallel_backward_adaptive): O(log N)-depth backward
    # with the whole-sweep batched LM retry, on the constrained task whose
    # AL penalty escalation (mu up to 1e8 on Quu) is exactly where PD
    # safety earns its keep
    cfg = SolverConfig(N=H, multiple_shooting=True, rollout="nonlinear",
                       tol_grad_norm=1e-8, max_iterations=100,
                       backward="associative")
    inner = LieILQR(model_c, cfg)
    al = ALILQR(inner, constr, tol_constr=1e-2)
    q0 = SE3.normalize(q_ref[0] @ SE3.exp(jnp.asarray([0.02, -0.01, 0.03, 0.05, -0.02, 0.01])))
    xi0 = xi_ref[0] + 0.05
    res = al.fit({"dyn": dp, "cost": alp}, (q0, xi0), jnp.zeros((H, 6)),
                 n_al_iters=20, n_ilqr_iters=100)
    print(json.dumps(dict(
        task="se3_al_ms", outer_iterations=res.outer_iterations,
        constr_converged=bool(res.constr_converged),
        max_violation=float(jnp.max(res.constr_eval)),
        u_range=[float(jnp.min(res.us)), float(jnp.max(res.us))],
    )))


def run_errstate(args):
    from trajectory_optimization_matrix_lie_groups.models import errorstate as es
    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.solvers.errorstate_ilqr import (
        ErrorStateILQR,
        ESConfig,
    )

    N, dt = 400, 0.01
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), jnp.eye(3)],
    ])
    R_goal = SE3.exp(jnp.array([0.0, 0.0, jnp.pi / 4, 0.0, 0.0, 0.0]))
    X_goal = R_goal.at[:3, 3].set(jnp.array([10.0, 10.0, 10.0]))
    q0 = jnp.eye(4)
    xi0 = jnp.concatenate([
        jnp.array([jnp.pi / 4, jnp.pi / 4, jnp.pi / 2]) / (N * dt),
        jnp.array([11.0, 11.0, 9.0]) / (N * dt),
    ])
    us0 = jnp.zeros((N, 6))
    p0 = es.errorstate_params(J, dt, jnp.zeros((N + 1, 4, 4)), jnp.zeros((N + 1, 6)))
    qs, xis = es.rollout_nominal(p0, q0, xi0, us0)
    params = es.reanchor(p0, qs, xis)
    Q, P, Rm = jnp.eye(6), 1e7 * jnp.eye(6), 1e3 * jnp.eye(6)
    cp = es.goal_cost_params(Q, Rm, P, params.q_ref, X_goal)
    cfg = ESConfig(N=N, mode="generation_nonlinear", n_alphas=15,
                   tol_grad_norm=1e-3, max_iterations=100)
    solver = ErrorStateILQR(cfg, es.goal_cost,
                            reanchor_cost=lambda c, qs_new: es.goal_cost_params(
                                Q, Rm, P, qs_new, X_goal))
    state, J_hist, grad_hist, _ = solver.fit(cp, params, us0)
    final_err = se3.log(se3.inverse(state.qs[-1]) @ X_goal)
    _summary("errstate_generate", J_hist, grad_hist, state,
             {"final_goal_err_norm": float(jnp.linalg.norm(final_err))})


def run_sweep_task(args):
    import dataclasses

    from trajectory_optimization_matrix_lie_groups.parallel import (
        BatchSolver,
        make_batch_mesh,
    )
    from trajectory_optimization_matrix_lie_groups.parallel.sweep import run_sweep
    from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    cfg = dataclasses.replace(solver.cfg, N=200, max_iterations=10,
                              tol_grad_norm=0.0, tol_d_norm=0.0,
                              backward="sequential_fixed")
    solver = LieILQR(solver.model, cfg)
    cp = params["cost"]
    cut = lambda a: a[:201]
    params = {**params, "cost": cp._replace(
        q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
        Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))}
    mesh = make_batch_mesh()
    bs = BatchSolver(solver, mesh=mesh)
    ranges = {
        "w_z": np.arange(-1.0, 1.0, 0.05) + 1.0,
        "p_x": np.arange(-8.0, 8.0, 0.4),
        "v_x": np.arange(-4.0, 4.0, 0.2),
        "th_z": np.arange(-30.0, 30.0, 1.5),
    }
    t0 = time.perf_counter()
    out = run_sweep(bs, params, ranges, cp.q_ref[0], cp.xi_ref[0], nu=6)
    wall = time.perf_counter() - t0
    total = sum(len(v.values) for v in out.values())
    print(json.dumps(dict(task="sweep", n_solves=total, wall_s=round(wall, 2),
                          solves_per_s=round(total / wall, 1),
                          params={k: dict(n=len(v.values),
                                          J_min=float(v.J_opt.min()),
                                          J_max=float(v.J_opt.max()))
                                  for k, v in out.items()})))


def run_rigid_body(args):
    """SE(3) rigid body under gravity tracking the drone-racing path
    (ref `main_RigidBody_ddp_tracking_exact_ms.py:101-158`: same path and
    weights as the SE3 task, `RigidBodyDynamics` with g=9.8)."""
    from trajectory_optimization_matrix_lie_groups.models import costs, dynamics
    from trajectory_optimization_matrix_lie_groups.models.base import make_model
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
        LieILQR,
        SolverConfig,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, _, params0, _, _, _ = build_benchmark("se3_tracking", True)
    prob = data["prob"]
    H = 200
    q_ref = jnp.asarray(np.asarray(prob["q_ref"])[: H + 1])
    xi_ref = jnp.asarray(np.asarray(prob["xi_ref"])[: H + 1].reshape(H + 1, 6))
    dyn = dynamics.rigid_body_dynamics()
    dp = dynamics.rigid_body_params(jnp.asarray(prob["J"]), float(prob["dt"]),
                                    g=9.8)
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(SE3, prob["Q"], prob["R"], prob["P"],
                                    q_ref, xi_ref)
    model, params = make_model(dyn, cd, dp, cp)
    cfg = SolverConfig(N=H, multiple_shooting=True, rollout="nonlinear",
                       n_alphas=20, tol_grad_norm=1e-6, tol_d_norm=1e-4,
                       max_iterations=100)
    solver = LieILQR(model, cfg)
    t0 = time.perf_counter()
    (qs, xis), us, J_hist, grad_hist, defect_hist, state = solver.fit(
        params, (q_ref[0], xi_ref[0]), jnp.zeros((H, 6)))
    wall = time.perf_counter() - t0
    res = _summary("rigid_body_ms", J_hist, grad_hist, state,
                   {"wall_s": round(wall, 2),
                    "defect_final": defect_hist[-1] if defect_hist else None})
    if args.plot:
        from trajectory_optimization_matrix_lie_groups.viz import plots

        plots.convergence(J_hist, grad_hist,
                          f"{args.plot}/rigid_body_ms_convergence.png",
                          defect_hist=defect_hist)
        plots.trajectory_3d(np.asarray(qs), np.asarray(q_ref),
                            f"{args.plot}/rigid_body_ms_trajectory.png")
    return res


def _errstate_circle_reference(N=400, dt=0.01):
    """Twist-integrated reference mirroring the error-state scripts'
    construction (ref `main_SE3ddp_tracking_approx.py:52-66`: constant twist
    from an euler/position target divided by the horizon)."""
    from trajectory_optimization_matrix_lie_groups.models import (
        errorstate as es,
    )

    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), jnp.eye(3)],
    ])
    w_ref = jnp.array([jnp.pi / 4, jnp.pi / 4, jnp.pi / 2]) / (N * dt)
    v_ref = jnp.array([10.0, 10.0, 10.0]) / (N * dt)
    xi0 = jnp.concatenate([w_ref, v_ref])
    p0 = es.errorstate_params(J, dt, jnp.zeros((N + 1, 4, 4)),
                              jnp.zeros((N + 1, 6)))
    qs, xis = es.rollout_nominal(p0, jnp.eye(4), xi0, jnp.zeros((N, 6)))
    return es.reanchor(p0, qs, xis), J, xi0


def run_errstate_tracking(args):
    """Error-state approximate tracking (ref `main_SE3ddp_tracking_approx.py`,
    `iLQR_Tracking_ErrorState_Approx` at traopt_controller.py:3300)."""
    from trajectory_optimization_matrix_lie_groups.models import errorstate as es
    from trajectory_optimization_matrix_lie_groups.solvers.errorstate_ilqr import (
        ErrorStateILQR,
        ESConfig,
    )

    N = 400
    params, J, xi0 = _errstate_circle_reference(N=N)
    cp = es.ErrorStateTrackingCostParams(
        Q=jnp.eye(12), R=1e-5 * jnp.eye(6), P=10.0 * jnp.eye(12),
        xi_ref=params.xi_ref)
    cfg = ESConfig(N=N, mode="tracking", rollout="nonlinear", n_alphas=13,
                   tol_grad_norm=1e-3, max_iterations=50)
    solver = ErrorStateILQR(cfg, es.tracking_cost_es)
    # perturbed start: the error state x = [Log(qbar^-1 q); xi]
    x_err0 = jnp.concatenate(
        [jnp.array([0.05, -0.03, 0.08, 0.2, -0.1, 0.15]), xi0 + 0.05])
    state, J_hist, grad_hist, _ = solver.fit(cp, params, jnp.zeros((N, 6)),
                                             x0=x_err0)
    _summary("errstate_tracking", J_hist, grad_hist, state,
             {"final_err_norm": float(jnp.linalg.norm(state.xs[-1][:6]))})


def run_errstate_linear(args):
    """Error-state goal generation with LTV (linear) rollout
    (ref `main_errSE3ddp_linear_rollout_generation.py:34-130`: Q=I, P=1e5 I,
    R=1e1 I, goal = yaw pi/4 at [10,10,10])."""
    from trajectory_optimization_matrix_lie_groups.models import errorstate as es
    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.solvers.errorstate_ilqr import (
        ErrorStateILQR,
        ESConfig,
    )

    N, dt = 400, 0.01
    J = jnp.block([
        [jnp.diag(jnp.array([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), jnp.eye(3)],
    ])
    R_goal = SE3.exp(jnp.array([0.0, 0.0, jnp.pi / 4, 0.0, 0.0, 0.0]))
    X_goal = R_goal.at[:3, 3].set(jnp.array([10.0, 10.0, 10.0]))
    # deviated reference (ref :68-79): integrate a twist slightly off-goal
    xi0 = jnp.concatenate([
        jnp.array([jnp.pi / 4 + 0.1, jnp.pi / 4 - 0.1, jnp.pi / 2]) / (N * dt),
        jnp.array([11.0, 11.0, 9.0]) / (N * dt),
    ])
    p0 = es.errorstate_params(J, dt, jnp.zeros((N + 1, 4, 4)),
                              jnp.zeros((N + 1, 6)))
    qs, xis = es.rollout_nominal(p0, jnp.eye(4), xi0, jnp.zeros((N, 6)))
    params = es.reanchor(p0, qs, xis)
    Q, P, Rm = jnp.eye(6), 1e5 * jnp.eye(6), 1e1 * jnp.eye(6)
    cp = es.goal_cost_params(Q, Rm, P, params.q_ref, X_goal)
    cfg = ESConfig(N=N, mode="generation_linear", n_alphas=15,
                   tol_grad_norm=1e-3, max_iterations=100)
    solver = ErrorStateILQR(cfg, es.goal_cost)
    state, J_hist, grad_hist, _ = solver.fit(cp, params, jnp.zeros((N, 6)))
    final_err = se3.log(se3.inverse(state.qs[-1]) @ X_goal)
    _summary("errstate_generate_linear", J_hist, grad_hist, state,
             {"final_goal_err_norm": float(jnp.linalg.norm(final_err))})


def run_baseline_su2(args):
    """Embedded-Euclidean SU(2) baseline on the SE3 tracking slice
    (ref `main_SU2_SE3_baseline.py`, `EmbeddedEuclideanSU2_SE3:642`)."""
    from trajectory_optimization_matrix_lie_groups.baselines.embedded import (
        solve_su2,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )
    from trajectory_optimization_matrix_lie_groups.utils.metrics import (
        quat_norm_violation,
    )

    data, _, _, _, _, _ = build_benchmark("se3_tracking", True)
    prob = data["prob"]
    H = 200
    q_ref = np.asarray(prob["q_ref"])[: H + 1]
    xi_ref = np.asarray(prob["xi_ref"])[: H + 1]
    xs, us, J_hist, grad_hist, st = solve_su2(
        prob["J"], float(prob["dt"]), q_ref, xi_ref,
        prob["Q"], prob["R"], prob["P"],
        (jnp.asarray(q_ref[0]), jnp.asarray(xi_ref[0]).reshape(6) + 0.05),
        jnp.zeros((H, 6)), n_iterations=100)
    drift = np.asarray(quat_norm_violation(xs))
    _summary("baseline_su2", J_hist, grad_hist, st,
             {"quat_norm_violation_max": float(drift.max())})


def run_baseline_embedded(args):
    """The three embedded rotation-matrix baseline families (ref
    `traopt_baseline.py` EmbeddedEuclidean*_DynamicsConstr{,_LogCost},
    ConstraintStabilization*) on the SE3 tracking slice."""
    from trajectory_optimization_matrix_lie_groups.baselines.embedded import (
        solve_se3_matrix,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )
    from trajectory_optimization_matrix_lie_groups.utils.metrics import (
        orthogonality_violation,
    )

    data, _, _, _, _, _ = build_benchmark("se3_tracking", True)
    prob = data["prob"]
    H = 120
    q_ref = np.asarray(prob["q_ref"])[: H + 1]
    xi_ref = np.asarray(prob["xi_ref"])[: H + 1]
    x0 = (jnp.asarray(q_ref[0]), jnp.asarray(xi_ref[0]).reshape(6) + 0.05)
    out = {}
    for variant in ("dynconstr", "logcost", "stabilized"):
        xs, us, J_hist, grad_hist, st = solve_se3_matrix(
            prob["J"], float(prob["dt"]), q_ref, xi_ref,
            prob["Q"], prob["R"], prob["P"], x0, jnp.zeros((H, 6)),
            variant=variant, n_iterations=60)
        Rms = np.asarray(xs)[:, :9].reshape(-1, 3, 3)
        viol = np.asarray(orthogonality_violation(Rms))
        out[variant] = dict(J_final=float(J_hist[-1]),
                            orthogonality_violation_max=float(viol.max()))
    print(json.dumps(dict(task="baseline_embedded", variants=out)))


def run_dynamics_sim(args):
    """Open-loop dynamics comparison (ref `main_SE3dynamics.py`,
    `main_errSE3dynamics.py`): exact SE(3) rollout vs error-state
    linearized propagation about the nominal, report divergence."""
    from trajectory_optimization_matrix_lie_groups.models import errorstate as es
    from trajectory_optimization_matrix_lie_groups.ops import se3

    N = 200
    params, J, xi0 = _errstate_circle_reference(N=N)
    key = jax.random.PRNGKey(0)
    us = 0.1 * jax.random.normal(key, (N, 6))
    # exact group rollout with the input sequence
    qs_exact, xis_exact = es.rollout_nominal(params, jnp.eye(4), xi0, us)
    # error-state propagation of the same inputs about the (zero-input) nominal
    def step(x, i):
        x_next = es.step_euler(params, x, us[i], i)
        return x_next, x_next
    x0 = jnp.zeros(12).at[6:].set(xi0)
    _, xs_es = jax.lax.scan(step, x0, jnp.arange(N))
    # reconstruct group trajectory from the error state and compare
    qs_es = jnp.einsum("nij,njk->nik", params.q_ref[1:],
                       se3.exp(xs_es[:, :6]))
    pose_div = jnp.linalg.norm(
        se3.log(se3.inverse(qs_es) @ qs_exact[1:]), axis=-1)
    vel_div = jnp.linalg.norm(xs_es[:, 6:] - xis_exact[1:], axis=-1)

    # open-loop 3-D pendulum swing (ref main_pendulum3d_dynamics.py:7-35:
    # J=diag(.5,.7,.9), m=1, l=0.5, dt=0.01, 10-degree initial tilt, u=0)
    from trajectory_optimization_matrix_lie_groups.models import dynamics
    from trajectory_optimization_matrix_lie_groups.ops.group import SO3

    pp = dynamics.pendulum3d_params(jnp.diag(jnp.array([0.5, 0.7, 0.9])),
                                    1.0, 0.5, 0.01)
    pend = dynamics.pendulum3d_dynamics()
    q0p = SO3.exp(jnp.array([jnp.deg2rad(10.0), 0.0, 0.0]))

    def pstep(carry, i):
        q, xi = carry
        q, xi = pend.step(pp, q, xi, jnp.zeros(3), i)
        return (q, xi), jnp.linalg.norm(SO3.log(q))

    (_, _), tilt = jax.lax.scan(pstep, (q0p, jnp.zeros(3)), jnp.arange(320))
    # released from rest at 10 deg it swings through the hanging equilibrium:
    # tilt dips toward 0 and stays bounded near the release amplitude
    # (slight Euler energy drift allowed).
    t0 = float(jnp.linalg.norm(SO3.log(q0p)))  # release tilt (pre-scan)
    print(json.dumps(dict(
        task="dynamics_sim", N=N,
        pose_divergence_final=float(pose_div[-1]),
        pose_divergence_max=float(pose_div.max()),
        vel_divergence_max=float(vel_div.max()),
        pendulum_tilt_initial=t0,
        pendulum_tilt_min=float(jnp.min(tilt)),
        pendulum_tilt_max=float(jnp.max(tilt)),
        pendulum_swings=bool((jnp.min(tilt) < 0.25 * t0)
                             & (jnp.max(tilt) < 1.5 * t0)),
    )))


def run_cost_landscape(args):
    """SE(3) cost-landscape grid (ref `visualization/visual_cost_3d_fixed.py`:
    left/right-error cost over a (theta_z, theta_y) rotation grid)."""
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )
    from trajectory_optimization_matrix_lie_groups.viz.cost_landscape import (
        plot_landscape,
        pose_error_grid,
    )

    data, _, params, _, _, _ = build_benchmark("se3_tracking", True)
    cp = params["cost"]
    th = np.linspace(-180.0, 180.0, 73)
    out = {}
    for left in (True, False):
        Z, _, _ = pose_error_grid(cp.q_ref[0], th, th, cp.Q1, left=left)
        name = "left" if left else "right"
        out[name] = dict(min=float(Z.min()), max=float(Z.max()))
        if args.plot:
            plot_landscape(Z, th, th, f"{args.plot}/cost_landscape_{name}.png",
                           title=f"SE(3) {name}-error cost landscape")
    print(json.dumps(dict(task="cost_landscape", grids=out)))


def run_mpc(args):
    """Closed-loop receding-horizon MPC on the SE3 tracking path (new
    capability: the BASELINE.json north-star workload, H=40 window)."""
    import dataclasses

    from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR
    from trajectory_optimization_matrix_lie_groups.solvers.mpc import (
        make_closed_loop,
    )
    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    H, T = 40, 150
    cfg = dataclasses.replace(solver.cfg, N=H, max_iterations=4,
                              tol_grad_norm=0.0, tol_d_norm=0.0,
                              backward="sequential_fixed", line_search=False)
    solver = LieILQR(solver.model, cfg)
    run = make_closed_loop(solver, T)
    cp = params["cost"]
    q0 = SE3.normalize(cp.q_ref[0] @ SE3.exp(
        jnp.asarray([0.05, -0.03, 0.08, 0.3, -0.2, 0.25], cp.xi_ref.dtype)))
    t0 = time.perf_counter()
    res = run(params, q0, cp.xi_ref[0])
    jax.block_until_ready(res.us)
    wall = time.perf_counter() - t0
    track_err = jnp.linalg.norm(
        se3.log(se3.inverse(cp.q_ref[: T + 1]) @ res.qs), axis=-1)
    print(json.dumps(dict(
        task="mpc", horizon=H, steps=T, wall_s=round(wall, 2),
        solves_per_s=round(T / wall, 1),
        tracking_err_initial=float(track_err[0]),
        tracking_err_final=float(track_err[-1]),
        tracking_err_shrink_ratio=float(track_err[-1] / track_err[0]),
    )))
    if args.plot:
        from trajectory_optimization_matrix_lie_groups.viz import plots

        plots.trajectory_3d(np.asarray(res.qs),
                            np.asarray(cp.q_ref[: T + 1]),
                            f"{args.plot}/mpc_trajectory.png")


def run_rollout_sweep_task(args):
    """Open-loop rollout sweeps (ref `visualization/rollout_all_compute.py`:
    J=diag(.5,.7,.9)+I, dt=0.01, 14 s horizon, zero controls, 12 initial-
    condition parameters swept one at a time)."""
    from trajectory_optimization_matrix_lie_groups.models import dynamics
    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.parallel.sweep import (
        run_rollout_sweep,
    )

    J = jnp.block([
        [jnp.diag(jnp.asarray([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), jnp.eye(3)],
    ])
    dt, Nsim = 0.01, 1400  # ref rollout_all_compute.py:100-101
    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(J, jnp.asarray(dt))
    # ref base initial condition (rollout_all_compute.py:40-52)
    base_q0 = se3.from_rotation_translation(
        jnp.eye(3), jnp.asarray([1.0, 1.0, -1.0]))
    base_xi0 = jnp.asarray([0.0, 0.0, 1.0, 0.2, 0.0, 2.0])
    ranges = {
        "th_z": np.arange(-180.0, 180.0, 10.0),
        "w_z": np.arange(-1.0, 1.0, 0.1) + 1.0,
        "p_z": np.arange(-6.0, 6.0, 0.5),
        "v_x": np.arange(-4.0, 4.0, 0.25),
    }
    t0 = time.perf_counter()
    out = run_rollout_sweep(dyn, dp, ranges, base_q0, base_xi0, N=Nsim)
    wall = time.perf_counter() - t0
    total = sum(len(v.values) for v in out.values())
    print(json.dumps(dict(
        task="rollout_sweep", n_rollouts=total, steps=Nsim,
        wall_s=round(wall, 2),
        params={k: dict(
            n=len(v.values),
            all_finite=bool(np.all(np.isfinite(v.qs))
                            and np.all(np.isfinite(v.xis))),
            final_pos_spread=float(
                np.ptp(v.qs[:, -1, :3, 3], axis=0).max()),
        ) for k, v in out.items()})))


def run_mpc_native(args):
    """Closed-loop MPC on the native C++ runtime (no JAX device in the
    loop): the deployable-controller counterpart of the `mpc` task, same
    window/budget/warm-start semantics (native.NativeMPC)."""
    from trajectory_optimization_matrix_lie_groups import native
    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    if native.LIB is None:
        print(json.dumps(dict(task="mpc_native", error="no native toolchain")))
        return
    data, _, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    prob = data["prob"]
    cp = params["cost"]
    H, T = 40, 150
    s = native.NativeSE3Solver(prob["J"], prob["dt"], prob["Q"], prob["R"],
                               prob["P"], np.asarray(cp.q_ref),
                               np.asarray(cp.xi_ref), iterations=4)
    mpc = native.NativeMPC(s, H)
    q0 = np.asarray(SE3.normalize(cp.q_ref[0] @ SE3.exp(
        jnp.asarray([0.05, -0.03, 0.08, 0.3, -0.2, 0.25], cp.xi_ref.dtype))))
    t0 = time.perf_counter()
    qs, xis, us, J_pred = mpc.run(q0, np.asarray(cp.xi_ref[0]), T)
    wall = time.perf_counter() - t0
    track_err = jnp.linalg.norm(
        se3.log(se3.inverse(cp.q_ref[: T + 1]) @ jnp.asarray(qs)), axis=-1)
    print(json.dumps(dict(
        task="mpc_native", horizon=H, steps=T, wall_s=round(wall, 3),
        solves_per_s=round(T / wall, 1),
        ms_per_solve=round(wall / T * 1e3, 3),
        tracking_err_initial=float(track_err[0]),
        tracking_err_final=float(track_err[-1]),
        tracking_err_shrink_ratio=float(track_err[-1] / track_err[0]),
    )))


def run_benchmark_compare(args):
    """Cross-solver agreement benchmark (ref `benchmark_SE3_tracking.py`):
    MS-iLQR vs SS-iLQR vs the three embedded baselines on one SE(3)
    tracking slice, with the reference's metrics — manifold violation
    ||R^T R - I|| (:414-418), dynamics violation via one-step re-simulation
    (:453-457), and final tracking error (:832-848)."""
    import dataclasses

    from trajectory_optimization_matrix_lie_groups.baselines.embedded import (
        solve_se3_matrix,
    )
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )
    from trajectory_optimization_matrix_lie_groups.utils import metrics

    data, solver_ms, params, x0, _, _ = build_benchmark("se3_tracking", True)
    prob = data["prob"]
    H = 120
    cp = params["cost"]
    cut = lambda a: a[: H + 1]
    cp = cp._replace(q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
                     Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))
    params = {**params, "cost": cp}
    q0 = SE3.normalize(cp.q_ref[0] @ SE3.exp(
        jnp.asarray([0.02, -0.01, 0.03, 0.05, -0.02, 0.01], cp.xi_ref.dtype)))
    xi0 = cp.xi_ref[0] + 0.05
    us0 = jnp.zeros((H, 6), cp.xi_ref.dtype)
    model = solver_ms.model
    out = {}
    artifacts = {}

    def lie_metrics(name, qs, xis, us, J_hist):
        orth = metrics.orthogonality_violation(qs)
        dyn_v = metrics.dynamics_violation(model, params, qs, xis, us)
        track = metrics.tracking_errors(SE3, cp, qs, xis)
        out[name] = dict(
            J_final=float(J_hist[-1]),
            orthogonality_violation_max=float(jnp.max(orth)),
            dynamics_violation_max=float(jnp.max(dyn_v)),
            tracking_err_final=float(track[0][-1]),
        )

    for name, ms in (("ms_ilqr", True), ("ss_ilqr", False)):
        cfg = dataclasses.replace(solver_ms.cfg, N=H, multiple_shooting=ms,
                                  max_iterations=100)
        s = LieILQR(model, cfg)
        (qs, xis), us, J_hist, grad_hist, defect_hist, _ = s.fit(
            params, (q0, xi0), us0)
        lie_metrics(name, qs, xis, us, J_hist)
        artifacts[name] = dict(xs=dict(qs=qs, xis=xis), us=us,
                               J_hist=J_hist, grad_hist=grad_hist,
                               defect_hist=defect_hist)

    q_ref_np = np.asarray(cp.q_ref)
    xi_ref_np = np.asarray(cp.xi_ref)
    for variant in ("dynconstr", "logcost", "stabilized",
                    "stabilized_logcost"):
        xs, us, J_hist, grad_hist, st = solve_se3_matrix(
            prob["J"], float(prob["dt"]), q_ref_np, xi_ref_np,
            prob["Q"], prob["R"], prob["P"], (q0, xi0), us0,
            variant=variant, n_iterations=60)
        Rms = np.asarray(xs)[:, :9].reshape(-1, 3, 3)
        out[f"baseline_{variant}"] = dict(
            J_final=float(J_hist[-1]),
            orthogonality_violation_max=float(np.max(np.asarray(
                metrics.orthogonality_violation(Rms)))),
        )
        artifacts[f"{variant}_euc"] = dict(xs=xs, us=us, J_hist=J_hist,
                                           grad_hist=grad_hist)
    # cross-solver agreement: the Lie solvers must agree closely
    dj = abs(out["ms_ilqr"]["J_final"] - out["ss_ilqr"]["J_final"])
    out["ms_ss_J_gap"] = dj
    if args.plot:
        # reference-format result artifact (benchmark_SE3_tracking.py:272-345)
        from trajectory_optimization_matrix_lie_groups.utils import (
            save_benchmark_pickle,
        )

        save_benchmark_pickle(
            f"{args.plot}/results_benchmark_compare.pkl",
            dict(J=prob["J"], dt=prob["dt"], q_ref=np.asarray(cp.q_ref),
                 xi_ref=np.asarray(cp.xi_ref),
                 x0=(np.asarray(q0), np.asarray(xi0)),
                 Q=prob["Q"], P=prob["P"], R=prob["R"]),
            artifacts)
        out["pickle"] = f"{args.plot}/results_benchmark_compare.pkl"
    print(json.dumps(dict(task="benchmark_compare", horizon=H, solvers=out)))


def run_benchmark_compare_so3(args):
    """SO(3)-family cross-solver agreement (ref `benchmark_SO3_tracking.py`
    and `benchmark_pendulum_swingup.py`): MS-iLQR vs SS-iLQR vs the
    embedded SU(2) baseline and all four embedded-matrix mechanism
    families, on the SO(3) attitude-tracking slice AND the 3-D pendulum
    swing-up, with the reference's agreement metrics — orthogonality
    violation, dynamics violation via one-step re-simulation, final
    tracking error (benchmark_SO3_tracking.py:414-518 analogues)."""
    import dataclasses

    from trajectory_optimization_matrix_lie_groups.baselines.embedded import (
        solve_so3_family,
    )
    from trajectory_optimization_matrix_lie_groups.ops.group import SO3
    from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )
    from trajectory_optimization_matrix_lie_groups.utils import metrics

    results = {}
    for bench_name, pendulum, H in (("so3_tracking", False, 80),
                                    ("pendulum_swingup", True, 80)):
        data, solver_ms, params, x0, _, _ = build_benchmark(bench_name, True)
        prob = data["prob"]
        cp = params["cost"]
        H = min(H, cp.q_ref.shape[0] - 1)
        cut = lambda a: a[: H + 1]
        cp = cp._replace(q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
                         Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))
        params = {**params, "cost": cp}
        q0 = SO3.normalize(cp.q_ref[0] @ SO3.exp(
            jnp.asarray([0.02, -0.01, 0.03], cp.xi_ref.dtype)))
        xi0 = cp.xi_ref[0] + 0.05
        us0 = jnp.zeros((H, 3), cp.xi_ref.dtype)
        model = solver_ms.model
        out = {}

        def lie_metrics(name, qs, xis, us, J_hist, params=params,
                        model=model, cp=cp, out=out):
            orth = metrics.orthogonality_violation(qs)
            dyn_v = metrics.dynamics_violation(model, params, qs, xis, us)
            track = metrics.tracking_errors(SO3, cp, qs, xis)
            out[name] = dict(
                J_final=float(J_hist[-1]),
                orthogonality_violation_max=float(jnp.max(orth)),
                dynamics_violation_max=float(jnp.max(dyn_v)),
                tracking_err_final=float(track[0][-1]),
            )

        for name, ms in (("ms_ilqr", True), ("ss_ilqr", False)):
            cfg = dataclasses.replace(solver_ms.cfg, N=H,
                                      multiple_shooting=ms,
                                      max_iterations=100)
            s = LieILQR(model, cfg)
            (qs, xis), us, J_hist, *_ = s.fit(params, (q0, xi0), us0)
            lie_metrics(name, qs, xis, us, J_hist)

        R_ref_np = np.asarray(cp.q_ref)
        xi_ref_np = np.asarray(cp.xi_ref)
        pend_kw = {}
        if pendulum:
            pend_kw = dict(m=float(prob["m"]), length=float(prob["length"]),
                           g=float(prob.get("g", 9.8)))
        for form in ("su2", "dynconstr", "logcost", "stabilized",
                     "stabilized_logcost"):
            xs, us_b, J_hist, grad_hist, st = solve_so3_family(
                prob["J"], float(prob["dt"]), R_ref_np, xi_ref_np,
                prob["Q"], prob["R"], prob["P"],
                (np.asarray(q0), np.asarray(xi0)), np.asarray(us0),
                formulation=form, pendulum=pendulum, n_iterations=60,
                **pend_kw)
            rec = dict(J_final=float(J_hist[-1]))
            xs = np.asarray(xs)
            if form == "su2":
                rec["quat_norm_violation_max"] = float(np.max(np.abs(
                    np.linalg.norm(xs[:, :4], axis=-1) - 1.0)))
            else:
                Rms = xs[:, :9].reshape(-1, 3, 3)
                rec["orthogonality_violation_max"] = float(np.max(np.asarray(
                    metrics.orthogonality_violation(Rms))))
            out[f"baseline_{form}"] = rec
        out["ms_ss_J_gap"] = abs(out["ms_ilqr"]["J_final"]
                                 - out["ss_ilqr"]["J_final"])
        results[bench_name] = dict(horizon=H, solvers=out)
    print(json.dumps(dict(task="benchmark_compare_so3", **results)))


def run_al_batch(args):
    """Batched input-constrained SE(3) tracking: the AL outer loop over a
    batch of perturbed starts in one SPMD program (new capability — the
    reference solves one constrained problem per process)."""
    from trajectory_optimization_matrix_lie_groups.models import (
        constraints as cs,
        costs,
        dynamics,
    )
    from trajectory_optimization_matrix_lie_groups.models.base import make_model
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.solvers.al_fast import (
        ALFastSolver,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.batched import (
        FastBatchSolver,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, _, params0, _, _, _ = build_benchmark("se3_tracking", True)
    prob = data["prob"]
    H, B = 60, 32
    q_ref = jnp.asarray(np.asarray(prob["q_ref"])[: H + 1])
    xi_ref = jnp.asarray(np.asarray(prob["xi_ref"])[: H + 1].reshape(H + 1, 6))
    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(prob["J"]), float(prob["dt"]))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(SE3, prob["Q"], prob["R"], prob["P"],
                                    q_ref, xi_ref)
    lb, ub = -100.0, 100.0
    constr = cs.input_box(12, 6)
    constr_p = cs.input_box_params(lb, ub, 6)
    al_cd = costs.al_cost(cd, constr)
    model_c, _ = make_model(dyn, al_cd, dp, None)
    alp = costs.al_init_params(cp, constr_p, H, constr.constr_size, mu0=1e-2,
                               dtype=q_ref.dtype)

    dq = 0.03 * jax.random.normal(jax.random.PRNGKey(2), (B, 6),
                                  dtype=q_ref.dtype)
    q0s = SE3.normalize(q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(xi_ref[0], (B, 6)) + 0.05
    us0 = jnp.zeros((B, H, 6), q_ref.dtype)

    if jax.default_backend() == "gpu":
        # the pipeline with in-loop AL terms (f32 on the GPU)
        from trajectory_optimization_matrix_lie_groups.solvers.al_pipeline import (
            ALPipelineSolver,
        )
        from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
            PipelineSolver,
        )

        f32 = lambda t: jax.tree.map(
            lambda x: x.astype(jnp.float32) if hasattr(x, "dtype")
            and jnp.issubdtype(x.dtype, jnp.floating) else x, t)
        pipe = PipelineSolver(N=H, iterations=25,
                                    dt=float(prob["dt"]))
        al = ALPipelineSolver(pipe, lb=np.full(6, lb), ub=np.full(6, ub),
                              tol_constr=1e-2)
        t0 = time.perf_counter()
        res = al.solve(f32(dp), f32(cp), f32(q0s), f32(xi0s), f32(us0),
                       n_al_iters=15)
        wall = time.perf_counter() - t0
        engine = "al_pipeline (generated kernels)"
    else:
        inner = FastBatchSolver(model_c, N=H, iterations=25)
        al = ALFastSolver(inner, constr, tol_constr=1e-2)
        t0 = time.perf_counter()
        res = al.solve({"dyn": dp, "cost": alp}, q0s, xi0s, us0,
                       q_ref=q_ref, xi_ref=xi_ref, n_al_iters=15,
                       rescue=True)
        wall = time.perf_counter() - t0
        engine = "al_fast (xla) + batched line-searched rescue"
    mv = np.asarray(res.max_violation)
    print(json.dumps(dict(
        task="al_batch", batch=B, horizon=H, engine=engine,
        outer_iterations=res.outer_iterations,
        constr_converged=bool(res.constr_converged),
        lanes_converged=int((mv < 1e-2).sum()),
        max_violation=float(mv.max()),
        u_max=float(jnp.max(res.us)), u_min=float(jnp.min(res.us)),
        wall_s=round(wall, 2),
    )))


def run_mpc_batch(args):
    """Monte-Carlo closed-loop MPC: B perturbed plants track the SE(3) path
    simultaneously, every step solved by the lane-layout pipeline (the
    per-step inner solves of all instances run as one program)."""
    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.solvers.mpc import (
        make_closed_loop_batch,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
        PipelineSolver,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, solver_full, params, _, _, _ = build_benchmark("se3_tracking", True)
    cp = params["cost"]
    dp = params["dyn"]
    to32 = lambda t: jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, t)
    cp, dp = to32(cp), to32(dp)
    on_gpu = jax.default_backend() == "gpu"
    B, H, T = (1024, 40, 100) if on_gpu else (4, 10, 5)
    pipe = PipelineSolver(N=H, iterations=4, dt=float(dp.dt))
    run = make_closed_loop_batch(pipe, solver_full.model, T)

    def mk(seed):
        dq = 0.05 * jax.random.normal(jax.random.PRNGKey(seed), (B, 6),
                                      dtype=jnp.float32)
        return SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))

    reps = 3
    q0_batches = [jax.device_put(mk(s)) for s in range(reps + 1)]
    jax.block_until_ready(q0_batches)
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 6)).astype(jnp.float32)
    res = jax.block_until_ready(run(dp, cp, q0_batches[0], xi0s))
    wall = np.inf
    for r in range(1, reps + 1):
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(dp, cp, q0_batches[r], xi0s))
        wall = min(wall, time.perf_counter() - t0)
    err0 = jnp.linalg.norm(jax.vmap(
        lambda q: se3.log(se3.inverse(cp.q_ref[0]) @ q))(res.qs[:, 0]),
        axis=-1)
    errT = jnp.linalg.norm(jax.vmap(
        lambda q: se3.log(se3.inverse(cp.q_ref[T]) @ q))(res.qs[:, -1]),
        axis=-1)
    result = dict(
        task="mpc_batch", batch=B, horizon=H, steps=T,
        wall_s=round(wall, 3),
        mpc_solves_per_s=round(B * T / wall, 1),
        tracking_err_mean_initial=float(jnp.mean(err0)),
        tracking_err_mean_final=float(jnp.mean(errT)),
        shrink_ratio=float(jnp.mean(errT) / jnp.mean(err0)),
    )
    print(json.dumps(result))


def run_mpc_batch_constrained(args):
    """Monte-Carlo closed-loop MPC with input box constraints: every plant
    step runs a fixed AL outer budget around the pipeline solve and applies
    a saturated first control (new capability; see
    solvers/mpc.make_closed_loop_batch_constrained)."""
    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.solvers.mpc import (
        make_closed_loop_batch_constrained,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
        PipelineSolver,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, solver_full, params, _, _, _ = build_benchmark("se3_tracking", True)
    cp = params["cost"]
    dp = params["dyn"]
    to32 = lambda t: jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, t)
    cp, dp = to32(cp), to32(dp)
    on_gpu = jax.default_backend() == "gpu"
    B, H, T = (1024, 40, 100) if on_gpu else (4, 10, 5)
    lb, ub = -300.0, 300.0
    pipe = PipelineSolver(N=H, iterations=4, dt=float(dp.dt))
    run = make_closed_loop_batch_constrained(pipe, solver_full.model, T,
                                             lb, ub, n_al_iters=4)

    def mk(seed):
        dq = 0.05 * jax.random.normal(jax.random.PRNGKey(seed), (B, 6),
                                      dtype=jnp.float32)
        return SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))

    reps = 2
    q0_batches = [jax.device_put(mk(s)) for s in range(reps + 1)]
    jax.block_until_ready(q0_batches)
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 6)).astype(jnp.float32)
    res, maxv = jax.block_until_ready(run(dp, cp, q0_batches[0], xi0s))
    wall = np.inf
    for r in range(1, reps + 1):
        t0 = time.perf_counter()
        res, maxv = jax.block_until_ready(run(dp, cp, q0_batches[r], xi0s))
        wall = min(wall, time.perf_counter() - t0)
    errT = jnp.linalg.norm(jax.vmap(
        lambda q: se3.log(se3.inverse(cp.q_ref[T]) @ q))(res.qs[:, -1]),
        axis=-1)
    result = dict(
        task="mpc_batch_constrained", batch=B, horizon=H, steps=T,
        bounds=[lb, ub], wall_s=round(wall, 3),
        mpc_solves_per_s=round(B * T / wall, 1),
        u_max=float(res.us.max()), u_min=float(res.us.min()),
        planned_violation_mean=float(jnp.mean(maxv)),
        tracking_err_mean_final=float(jnp.mean(errT)),
    )
    print(json.dumps(result))


TASKS = {
    "cartpole": run_cartpole,
    "so3_tracking": lambda a: run_benchmark_task("so3_tracking", "so3_tracking", False, a),
    "so3_tracking_ms": lambda a: run_benchmark_task("so3_tracking_ms", "so3_tracking", True, a),
    "pendulum3d_ms": lambda a: run_benchmark_task("pendulum3d_ms", "pendulum_swingup", True, a),
    "se3_tracking": lambda a: run_benchmark_task("se3_tracking", "se3_tracking", False, a),
    "se3_tracking_ms": lambda a: run_benchmark_task("se3_tracking_ms", "se3_tracking", True, a),
    "drone_ms": lambda a: run_benchmark_task("drone_ms", "drone_racing", True, a),
    "rigid_body_ms": run_rigid_body,
    "se3_al_ms": run_al,
    "errstate_tracking": run_errstate_tracking,
    "errstate_generate": run_errstate,
    "errstate_generate_linear": run_errstate_linear,
    "baseline_su2": run_baseline_su2,
    "baseline_embedded": run_baseline_embedded,
    "dynamics_sim": run_dynamics_sim,
    "cost_landscape": run_cost_landscape,
    "mpc": run_mpc,
    "mpc_native": run_mpc_native,
    "al_batch": run_al_batch,
    "mpc_batch": run_mpc_batch,
    "mpc_batch_constrained": run_mpc_batch_constrained,
    "benchmark_compare": run_benchmark_compare,
    "benchmark_compare_so3": run_benchmark_compare_so3,
    "sweep": run_sweep_task,
    "rollout_sweep": run_rollout_sweep_task,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("task", choices=sorted(TASKS))
    ap.add_argument("--plot", default=None, help="directory for output figures")
    ap.add_argument("--x64", action="store_true", help="enable float64")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    setup_compile_cache()
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    if args.plot:
        import os

        os.makedirs(args.plot, exist_ok=True)
    TASKS[args.task](args)


if __name__ == "__main__":
    main()
