"""Closed-loop MPC on the SE(3) drone-racing path (fully jitted scan)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models import costs as costs_m
from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR
from trajectory_optimization_matrix_lie_groups.solvers.mpc import make_closed_loop
from trajectory_optimization_matrix_lie_groups.tasks.parity import build_benchmark


@pytest.mark.parity
def test_closed_loop_mpc_tracks_path():
    data, solver_full, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    cp_full = params["cost"]
    H, T = 30, 100
    cfg = dataclasses.replace(
        solver_full.cfg, N=H, tol_grad_norm=0.0, tol_d_norm=0.0, max_iterations=4
    )
    solver = LieILQR(solver_full.model, cfg)
    run = make_closed_loop(solver, T)

    # start near the path (MPC regime)
    q0 = SE3.normalize(cp_full.q_ref[0] @ SE3.exp(
        jnp.asarray([0.05, -0.03, 0.08, 0.2, -0.1, 0.1])))
    xi0 = cp_full.xi_ref[0] + 0.1
    res = run(params, q0, xi0)

    assert res.us.shape == (T, 6)
    assert bool(jnp.all(jnp.isfinite(res.us)))
    # closed-loop tracking error must shrink vs the initial offset
    e0 = SE3.log(q0 @ SE3.inverse(cp_full.q_ref[0]))
    eT = SE3.log(res.qs[-1] @ SE3.inverse(cp_full.q_ref[T]))
    assert float(jnp.linalg.norm(eT)) < 0.5 * float(jnp.linalg.norm(e0)), (
        f"e0={np.asarray(e0)}, eT={np.asarray(eT)}"
    )


def test_mpc_f32_closed_loop_fidelity():
    """Open-loop f32 controls carry ~1e-3 noise in flat-in-u directions
    (sigma_min(Quu) ~ 2R = 2e-5), but the closed loop is
    insensitive: the f32 plant trajectory matches f64 to ~1e-5."""
    import dataclasses
    import os

    import numpy as np

    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR
    from trajectory_optimization_matrix_lie_groups.solvers.mpc import (
        make_closed_loop,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    import jax

    H, T, ITERS = 30, 25, 5

    def run(dtype):
        data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
        cfg = dataclasses.replace(solver.cfg, N=H, max_iterations=ITERS,
                                  tol_grad_norm=0.0, tol_d_norm=0.0,
                                  backward="sequential_fixed")
        eng = LieILQR(solver.model, cfg)
        cast = lambda t: jax.tree.map(
            lambda x: x.astype(dtype) if hasattr(x, "dtype")
            and jnp.issubdtype(x.dtype, jnp.floating) else x, t)
        params = cast(params)
        q0 = cast(jnp.asarray(np.asarray(params["cost"].q_ref[0])))
        xi0 = cast(jnp.asarray(np.asarray(params["cost"].xi_ref[0]))
                   + 0.05 * jnp.arange(6, dtype=dtype))
        return make_closed_loop(eng, T)(params, q0, xi0)

    out32 = run(jnp.float32)
    out64 = run(jnp.float64)
    e = se3.log(jnp.asarray(out32.qs, jnp.float64)
                @ se3.inverse(jnp.asarray(out64.qs, jnp.float64)))
    assert float(np.max(np.abs(np.asarray(e)))) < 1e-4
    dxi = np.max(np.abs(np.asarray(out32.xis, np.float64)
                        - np.asarray(out64.xis)))
    assert dxi < 1e-4


def test_batched_closed_loop_matches_host_loop():
    """Pipeline-backed batched MPC scan == a host loop of pipe.solve calls."""
    import jax

    from trajectory_optimization_matrix_lie_groups.solvers.mpc import (
        make_closed_loop_batch,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
        PipelineSolver,
    )

    data, solver_full, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    cp_full = params["cost"]
    dp = params["dyn"]
    model = solver_full.model
    H, T, B = 10, 5, 3
    pipe = PipelineSolver(N=H, iterations=3, dt=float(dp.dt))
    run = make_closed_loop_batch(pipe, model, T)

    dq = 0.05 * jax.random.normal(jax.random.PRNGKey(4), (B, 6))
    q0s = SE3.normalize(cp_full.q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(cp_full.xi_ref[0], (B, 6)) + 0.1
    res = run(dp, cp_full, q0s, xi0s)
    assert res.us.shape == (B, T, 6)
    assert bool(jnp.all(jnp.isfinite(res.J_pred)))

    # manual host loop with the same solver must agree exactly
    qs, xis = q0s, xi0s
    us_warm = jnp.zeros((B, H, 6), xi0s.dtype)
    for t in range(T):
        cut = lambda a: a[t: t + H + 1]
        cp_t = cp_full._replace(
            q_ref=cut(cp_full.q_ref), q_ref_inv=cut(cp_full.q_ref_inv),
            Ad_ref=cut(cp_full.Ad_ref), xi_ref=cut(cp_full.xi_ref))
        out = pipe.solve(dp, cp_t, qs, xis, us_warm)
        u0 = out.us[:, 0]
        np.testing.assert_allclose(np.asarray(res.us[:, t]), np.asarray(u0),
                                   atol=1e-10)
        qs, xis = model.step({"dyn": dp, "cost": cp_t}, qs, xis, u0, 0)
        us_warm = jnp.concatenate([out.us[:, 1:], out.us[:, -1:]], axis=1)
    np.testing.assert_allclose(np.asarray(res.qs[:, -1]), np.asarray(qs),
                               atol=1e-10)


@pytest.mark.slow
def test_batched_closed_loop_with_disturbance():
    """Per-step twist disturbances: noisy loops stay bounded and differ
    from the noiseless run; sigma=0 with a key reproduces noiseless."""
    import jax

    from trajectory_optimization_matrix_lie_groups.solvers.mpc import (
        make_closed_loop_batch,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
        PipelineSolver,
    )

    data, solver_full, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    cp_full = params["cost"]
    dp = params["dyn"]
    H, T, B = 10, 5, 2
    pipe = PipelineSolver(N=H, iterations=3, dt=float(dp.dt))
    run = make_closed_loop_batch(pipe, solver_full.model, T)
    q0s = jnp.broadcast_to(cp_full.q_ref[0], (B, 4, 4))
    xi0s = jnp.broadcast_to(cp_full.xi_ref[0], (B, 6))

    clean = run(dp, cp_full, q0s, xi0s)
    zero = run(dp, cp_full, q0s, xi0s, noise_key=jax.random.PRNGKey(1),
               noise_sigma=0.0)
    np.testing.assert_allclose(np.asarray(zero.us), np.asarray(clean.us),
                               atol=1e-12)
    noisy = run(dp, cp_full, q0s, xi0s, noise_key=jax.random.PRNGKey(1),
                noise_sigma=0.05)
    assert bool(jnp.all(jnp.isfinite(noisy.us)))
    assert float(jnp.max(jnp.abs(noisy.us - clean.us))) > 1e-4
