"""In-graph AL solve + masked line-searched rescue (VERDICT round-2 item 6).

`ALFastSolver.solve_in_graph` must (a) reproduce the host-loop `solve`
exactly when no rescue is needed, and (b) converge hard lanes via the
masked rescue INSIDE one jitted program — including composed into the
closed-loop constrained MPC (`make_closed_loop_batch_constrained`), which
previously had no rescue at all (fixed AL budget only).
"""

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
from trajectory_optimization_matrix_lie_groups.solvers.al_fast import (
    ALFastSolver,
)
from trajectory_optimization_matrix_lie_groups.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups.solvers.mpc import (
    make_closed_loop_batch_constrained,
)
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups.tasks.parity import (
    build_benchmark,
)


def _to32(t):
    return jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x, t)


def _al_setup(dp, H, lb, ub, cp):
    dyn = dynamics.se3_dynamics()
    constr = cs.input_box(12, 6)
    al_cd = costs.al_cost(costs.tracking_cost(SE3, 6), constr)
    model_c, _ = make_model(dyn, al_cd, dp, None)
    constr_p = cs.input_box_params(lb, ub, 6)
    alp = costs.al_init_params(cp, constr_p, H, constr.constr_size,
                               mu0=1e-2, dtype=cp.Q1.dtype)
    return model_c, constr, alp


def test_solve_in_graph_matches_host_loop():
    data, solver, params, x0, us0_full, _ = build_benchmark(
        "se3_tracking", True)
    H, B = 30, 3
    dp, cp = params["dyn"], params["cost"]
    cut = lambda a: a[: H + 1]
    cp = cp._replace(q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
                     Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))
    dq = 0.03 * jax.random.normal(jax.random.PRNGKey(2), (B, 6))
    q0s = SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 6)) + 0.05
    us0 = jnp.zeros((B, H, 6))

    model_c, constr, alp = _al_setup(dp, H, -100.0, 100.0, cp)
    inner = FastBatchSolver(model_c, N=H, iterations=20)
    al = ALFastSolver(inner, constr, tol_constr=1e-2)
    p = {"dyn": dp, "cost": alp}

    res_h = al.solve(p, q0s, xi0s, us0, n_al_iters=8)
    res_g = jax.jit(
        lambda p, q, x, u: al.solve_in_graph(p, q, x, u, n_al_iters=8)
    )(p, q0s, xi0s, us0)
    np.testing.assert_allclose(np.asarray(res_g.us), np.asarray(res_h.us),
                               atol=0)
    np.testing.assert_allclose(np.asarray(res_g.max_violation),
                               np.asarray(res_h.max_violation), atol=0)
    assert bool(res_g.constr_converged) == (
        float(np.max(np.asarray(res_h.max_violation))) < al.tol_constr)


@pytest.mark.slow
def test_constrained_mpc_masked_rescue():
    """Hard instances (tight box, big perturbation, tiny AL budget) leave
    the fixed-budget constrained MPC at O(1e3) violation; the masked
    in-graph rescue converges every lane below tolerance within the SAME
    jitted program."""
    H, T, B, ITERS, NAL = 10, 2, 2, 4, 2
    data, solver, params, x0, us0_full, _ = build_benchmark(
        "se3_tracking", True, dtype=jnp.float32)
    params = _to32(params)
    dp, cp, model = params["dyn"], params["cost"], solver.model
    lb, ub = -60.0, 60.0

    dq = 0.12 * jax.random.normal(jax.random.PRNGKey(4), (B, 6), jnp.float32)
    q0s = SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 6)) + jnp.float32(0.8)

    pipe = PipelineSolver(N=H, iterations=ITERS,
                                dt=float(data["prob"]["dt"]))
    run = make_closed_loop_batch_constrained(pipe, model, T, lb, ub,
                                             n_al_iters=NAL)
    _, maxv = run(dp, cp, q0s, xi0s)
    assert float(np.max(np.asarray(maxv))) > 1e-2, \
        "expected hard lanes (otherwise this test exercises nothing)"

    model_c, constr, _ = _al_setup(dp, H, lb, ub, cp)
    inner = FastBatchSolver(model_c, N=H, iterations=20)
    alf = ALFastSolver(inner, constr, tol_constr=1e-2)
    run_r = make_closed_loop_batch_constrained(
        pipe, model, T, lb, ub, n_al_iters=NAL, rescue=alf, rescue_outers=8)
    _, maxv_r = run_r(dp, cp, q0s, xi0s)
    assert float(np.max(np.asarray(maxv_r))) < 1e-2, np.asarray(maxv_r)
