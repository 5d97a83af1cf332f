"""Native (C++) serial MS-iLQR runtime vs golden and the JAX engine."""

import numpy as np
import pytest

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups import native
from trajectory_optimization_matrix_lie_groups.tasks import se3_bench

pytestmark = pytest.mark.skipif(native.LIB is None,
                                reason="no native toolchain")
# tests marked `parity` solve problems rebuilt from the reference's
# benchmark pickles
parity = pytest.mark.parity


def test_native_matches_golden():
    prob = se3_bench.problem_np64()
    q0, xi0, us_golden = se3_bench.load_golden()
    s = native.NativeSE3Solver(prob["J"], prob["dt"], prob["Q"], prob["R"],
                               prob["P"], prob["q_ref"], prob["xi_ref"],
                               iterations=12)
    us, J, g = s.solve(q0, xi0)
    # same iterate sequence as FastBatchSolver f64 at 12 iterations (5.1e-7
    # from the fully-converged golden)
    assert np.max(np.abs(us - us_golden)) < 3e-6
    assert abs(J - 36.6183163) < 1e-3
    assert g < 1e-8


@parity
def test_native_matches_jax_engine():
    """Per-iterate agreement with FastBatchSolver (f64) on a short horizon."""
    from trajectory_optimization_matrix_lie_groups.solvers.batched import (
        FastBatchSolver,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
        cut_reference,
    )
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    import jax

    H, ITERS, B = 40, 6, 2
    data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    params = cut_reference(params, H)
    cp = params["cost"]
    dq = 0.05 * jax.random.normal(jax.random.PRNGKey(2), (B, 6))
    q0s = SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 6))
    fast = FastBatchSolver(solver.model, N=H, iterations=ITERS)
    ref = fast.solve(params, q0s, xi0s, jnp.zeros((B, H, 6)),
                     cp.q_ref, cp.xi_ref)

    prob = data["prob"]
    s = native.NativeSE3Solver(prob["J"], prob["dt"], prob["Q"], prob["R"],
                               prob["P"], np.asarray(cp.q_ref),
                               np.asarray(cp.xi_ref), iterations=ITERS)
    us, J, g = s.solve_batch(np.asarray(q0s), np.asarray(xi0s))
    np.testing.assert_allclose(us, np.asarray(ref.us), atol=1e-8)
    np.testing.assert_allclose(J, np.asarray(ref.J_opt), rtol=1e-10)


@parity
def test_native_drone_gravity_matches_jax_engine():
    """Drone family (gravity wrench + 6x4 Pu, nu=4) vs FastBatchSolver."""
    from trajectory_optimization_matrix_lie_groups.solvers.batched import (
        FastBatchSolver,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
        cut_reference,
    )
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    import jax

    H, ITERS, B = 30, 5, 2
    data, solver, params, x0, us0, _ = build_benchmark("drone_racing", True)
    params = cut_reference(params, H)
    cp = params["cost"]
    dp = params["dyn"]
    dq = 0.03 * jax.random.normal(jax.random.PRNGKey(3), (B, 6))
    q0s = SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 6))
    fast = FastBatchSolver(solver.model, N=H, iterations=ITERS)
    ref = fast.solve(params, q0s, xi0s, jnp.zeros((B, H, 4)),
                     cp.q_ref, cp.xi_ref)

    prob = data["prob"]
    s = native.NativeSE3Solver(prob["J"], prob["dt"], prob["Q"], prob["R"],
                               prob["P"], np.asarray(cp.q_ref),
                               np.asarray(cp.xi_ref), iterations=ITERS,
                               g=float(dp.g), Pu=np.asarray(dp.Pu))
    assert s.nu == 4
    us, J, g = s.solve_batch(np.asarray(q0s), np.asarray(xi0s))
    assert us.shape == (B, H, 4)
    np.testing.assert_allclose(us, np.asarray(ref.us), atol=1e-8)
    np.testing.assert_allclose(J, np.asarray(ref.J_opt), rtol=1e-10)


@parity
@pytest.mark.parametrize("name,pendulum", [("so3_tracking", False),
                                           ("pendulum_swingup", True)])
def test_native_so3_matches_jax_engine(name, pendulum):
    """SO(3) families (free attitude, 3-D pendulum) vs FastBatchSolver."""
    from trajectory_optimization_matrix_lie_groups.solvers.batched import (
        FastBatchSolver,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
        cut_reference,
    )
    from trajectory_optimization_matrix_lie_groups.ops.group import SO3
    import jax

    H, ITERS, B = 30, 6, 2
    data, solver, params, x0, us0, _ = build_benchmark(name, True)
    prob = data["prob"]
    params = cut_reference(params, H)
    cp = params["cost"]
    dq = 0.05 * jax.random.normal(jax.random.PRNGKey(3), (B, 3))
    q0s = SO3.normalize(cp.q_ref[0][None] @ SO3.exp(dq))
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 3))
    fast = FastBatchSolver(solver.model, N=H, iterations=ITERS)
    ref = fast.solve(params, q0s, xi0s, jnp.zeros((B, H, 3)),
                     cp.q_ref, cp.xi_ref)

    kw = {}
    if pendulum:
        kw = dict(pendulum=True, m=float(prob["m"]),
                  length=float(prob["length"]), g=9.8)
    s = native.NativeSO3Solver(prob["J"], prob["dt"], prob["Q"], prob["R"],
                               prob["P"], np.asarray(cp.q_ref),
                               np.asarray(cp.xi_ref), iterations=ITERS, **kw)
    us, J, g = s.solve_batch(np.asarray(q0s), np.asarray(xi0s))
    assert us.shape == (B, H, 3)
    np.testing.assert_allclose(us, np.asarray(ref.us), atol=1e-8)
    np.testing.assert_allclose(J, np.asarray(ref.J_opt), rtol=1e-10)

    us1, J1, g1 = s.solve(np.asarray(q0s[0]), np.asarray(xi0s[0]))
    np.testing.assert_allclose(us1, us[0], atol=1e-12)


@parity
def test_native_mpc_matches_jax_closed_loop():
    """NativeMPC == make_closed_loop (backward='sequential_fixed') at f64."""
    import dataclasses

    from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
        LieILQR,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.mpc import (
        make_closed_loop,
    )
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    H, T, ITERS = 20, 12, 4
    data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    cfg = dataclasses.replace(solver.cfg, N=H, max_iterations=ITERS,
                              tol_grad_norm=0.0, tol_d_norm=0.0,
                              backward="sequential_fixed")
    eng = LieILQR(solver.model, cfg)
    cp = params["cost"]
    q0 = jnp.asarray(np.asarray(cp.q_ref[0]))
    xi0 = (jnp.asarray(np.asarray(cp.xi_ref[0]))
           + 0.05 * jnp.arange(6, dtype=jnp.float64))
    ref = make_closed_loop(eng, T)(params, q0, xi0)

    prob = data["prob"]
    s = native.NativeSE3Solver(prob["J"], prob["dt"], prob["Q"], prob["R"],
                               prob["P"], np.asarray(cp.q_ref),
                               np.asarray(cp.xi_ref), iterations=ITERS)
    mpc = native.NativeMPC(s, H)
    qs, xis, us, J_pred = mpc.run(np.asarray(q0), np.asarray(xi0), T)
    np.testing.assert_allclose(us, np.asarray(ref.us), atol=1e-9)
    np.testing.assert_allclose(qs, np.asarray(ref.qs), atol=1e-9)
    np.testing.assert_allclose(xis, np.asarray(ref.xis), atol=1e-9)
    # J conventions differ by one rollout (post-rollout vs linearization
    # point)
    np.testing.assert_allclose(J_pred, np.asarray(ref.J_pred), rtol=1e-4)


def test_native_al_matches_al_fast():
    """Native AL outer loop (input box) == ALFastSolver at f64."""
    from trajectory_optimization_matrix_lie_groups.models import (
        constraints as cs,
        costs,
        dynamics,
    )
    from trajectory_optimization_matrix_lie_groups.models.base import (
        make_model,
    )
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.solvers.al_fast import (
        ALFastSolver,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.batched import (
        FastBatchSolver,
    )
    import jax

    prob = se3_bench.problem_np64()
    H, B, ITERS = 40, 2, 20
    q_ref = jnp.asarray(np.asarray(prob["q_ref"])[: H + 1])
    xi_ref = jnp.asarray(np.asarray(prob["xi_ref"])[: H + 1].reshape(H + 1, 6))
    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(prob["J"]), float(prob["dt"]))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(SE3, prob["Q"], prob["R"], prob["P"],
                                    q_ref, xi_ref)
    dq = 0.03 * jax.random.normal(jax.random.PRNGKey(2), (B, 6))
    q0s = SE3.normalize(q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(xi_ref[0], (B, 6)) + 0.05
    us0 = jnp.zeros((B, H, 6))
    lb, ub = -100.0, 100.0

    constr = cs.input_box(12, 6)
    al_cd = costs.al_cost(cd, constr)
    model_c, _ = make_model(dyn, al_cd, dp, None)
    alp = costs.al_init_params(cp, cs.input_box_params(lb, ub, 6), H,
                               constr.constr_size, mu0=1e-2)
    inner = FastBatchSolver(model_c, N=H, iterations=ITERS)
    ref = ALFastSolver(inner, constr, tol_constr=1e-2).solve(
        {"dyn": dp, "cost": alp}, q0s, xi0s, us0,
        q_ref=q_ref, xi_ref=xi_ref, n_al_iters=15)

    s = native.NativeSE3Solver(prob["J"], prob["dt"], prob["Q"], prob["R"],
                               prob["P"], np.asarray(q_ref),
                               np.asarray(xi_ref), iterations=ITERS)
    us, J, g, maxv, outer = s.solve_al(np.asarray(q0s), np.asarray(xi0s),
                                       lb, ub, n_al_iters=15)
    assert outer == ref.outer_iterations
    np.testing.assert_allclose(us, np.asarray(ref.us), atol=1e-8)
    np.testing.assert_allclose(maxv, np.asarray(ref.max_violation),
                               atol=1e-9)
    assert us.max() <= ub + 1e-2 and us.min() >= lb - 1e-2


@parity
def test_native_mpc_constrained():
    """NativeMPC with input bounds: box respected, tracking preserved."""
    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.ops.group import SE3
    from trajectory_optimization_matrix_lie_groups.tasks.parity import (
        build_benchmark,
    )

    data, _, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    prob = data["prob"]
    cp = params["cost"]
    H, T = 30, 25
    s = native.NativeSE3Solver(prob["J"], prob["dt"], prob["Q"], prob["R"],
                               prob["P"], np.asarray(cp.q_ref),
                               np.asarray(cp.xi_ref), iterations=4)
    q0 = np.asarray(SE3.normalize(cp.q_ref[0] @ SE3.exp(
        jnp.asarray([0.05, -0.03, 0.08, 0.3, -0.2, 0.25]))))
    xi0 = np.asarray(cp.xi_ref[0])

    _, _, us_u, _ = native.NativeMPC(s, H).run(q0, xi0, T)
    lb, ub = -300.0, 300.0
    assert np.abs(us_u).max() > ub, "bounds not exercised unconstrained"

    qs_c, _, us_c, _ = native.NativeMPC(s, H, lb=lb, ub=ub).run(q0, xi0, T)
    assert us_c.max() <= ub + 1e-2 and us_c.min() >= lb - 1e-2
    err_c = np.linalg.norm(np.asarray(se3.log(
        se3.inverse(jnp.asarray(cp.q_ref[: T + 1])) @ jnp.asarray(qs_c))),
        axis=-1)
    # with the box active the reference is not trackable at the
    # unconstrained rate: require bounded error, not contraction
    assert err_c[-1] < 2.5 * err_c[0]
    assert np.all(np.isfinite(us_c))
