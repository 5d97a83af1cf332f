"""Builders reconstructing the reference benchmark problems from their pickles.

Each reference benchmark pickle (`visualization/results_benchmark_2nd_draft/`)
stores the complete problem spec in its `prob` dict (writer:
`benchmark_SE3_tracking.py:272-345`).  These builders rebuild the identical
problem on our stack so the converged controls can be diffed against the
stored solutions (the BASELINE 1e-4 gate; in practice we match to ~1e-10).

Solver options per benchmark script:
  - SO3 tracking:      tol 1e-8,  50 iters  (benchmark_SO3_tracking.py:84-87)
  - pendulum swing-up: tol 1e-12, 100 iters (benchmark_pendulum_swingup.py:73-76)
  - SE3 tracking:      tol 1e-12, 200 iters (benchmark_SE3_tracking.py:88-91)
  - drone racing:      tol 1e-12, 200 iters (benchmark_drone_racing_tracking.py:81-84)
  all with line_search=False, rollout='nonlinear'; alpha ladders: 13 (SO3
  MS/SS, SE3 SS), 20 (SE3 MS).
"""

import numpy as np

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups.models.base import make_model
from trajectory_optimization_matrix_lie_groups.ops.group import SE3, SO3
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (
    LieILQR,
    SolverConfig,
)

RESULTS_DIR = "/root/reference/visualization/results_benchmark_2nd_draft/"

BENCHMARKS = {
    "se3_tracking": dict(pkl="results_se3_tracking_benchmark.pkl", family="se3",
                         tol=1e-12, iters=200),
    "se3_generate": dict(pkl="results_se3_tracking_generate_benchmark.pkl",
                         family="se3", tol=1e-12, iters=200),
    "se3_drone_path": dict(pkl="results_se3_tracking_drone_benchmark.pkl",
                           family="se3", tol=1e-12, iters=200),
    "drone_racing": dict(pkl="results_drone_racing_tracking_benchmark.pkl",
                         family="drone", tol=1e-12, iters=200),
    "so3_tracking": dict(pkl="results_so3_tracking_benchmark.pkl", family="so3",
                         tol=1e-8, iters=50),
    "pendulum_swingup": dict(pkl="results_pendulum_swingup_benchmark.pkl",
                             family="pendulum3d", tol=1e-12, iters=100),
}


def build_from_prob(prob, family, ms, tol=1e-12, iters=200, dtype=jnp.float64):
    """Build (solver, params, x0, us0, solution_key) from a pickle `prob`."""
    q_ref = jnp.asarray(np.asarray(prob["q_ref"]), dtype)
    N = q_ref.shape[0] - 1

    if family == "so3":
        dyn = dynamics.so3_dynamics()
        dp = dynamics.so3_params(jnp.asarray(prob["J"], dtype),
                                 jnp.asarray(float(prob["dt"]), dtype))
        group, nu, sol = SO3, 3, ("ms_so3" if ms else "ss_so3")
    elif family == "pendulum3d":
        dyn = dynamics.pendulum3d_dynamics()
        dp = dynamics.pendulum3d_params(jnp.asarray(prob["J"], dtype),
                                        float(prob["m"]), float(prob["length"]),
                                        jnp.asarray(float(prob["dt"]), dtype))
        group, nu, sol = SO3, 3, ("ms_so3" if ms else "ss_so3")
    elif family == "se3":
        dyn = dynamics.se3_dynamics()
        dp = dynamics.se3_params(jnp.asarray(prob["J"], dtype),
                                 jnp.asarray(float(prob["dt"]), dtype))
        group, nu, sol = SE3, 6, ("ms_se3" if ms else "ss_se3")
    elif family == "drone":
        dyn = dynamics.drone_dynamics()
        dp = dynamics.drone_params(jnp.asarray(prob["J"], dtype),
                                   jnp.asarray(float(prob["dt"]), dtype))
        group, nu, sol = SE3, 4, ("ms_se3" if ms else "ss_se3")
    else:
        raise ValueError(family)

    xi_ref = jnp.asarray(np.asarray(prob["xi_ref"]).reshape(N + 1, group.dim), dtype)
    cd = costs.tracking_cost(group, nu, ref_so3_terminal_quirk=(group is SO3))
    cp = costs.tracking_cost_params(
        group, jnp.asarray(prob["Q"], dtype), jnp.asarray(prob["R"], dtype),
        jnp.asarray(prob["P"], dtype), q_ref, xi_ref)
    model, params = make_model(dyn, cd, dp, cp)

    cfg = SolverConfig(
        N=N, multiple_shooting=ms, line_search=False, rollout="nonlinear",
        n_alphas=(20 if (group is SE3 and ms) else 13),
        defect_kappa=(1e-12 if group is SE3 else 1e-14),
        tol_grad_norm=tol, tol_d_norm=1e-6, max_iterations=iters,
    )
    solver = LieILQR(model, cfg)
    q0 = jnp.asarray(np.asarray(prob["x0"][0]), dtype)
    xi0 = jnp.asarray(np.asarray(prob["x0"][1]).reshape(group.dim), dtype)
    us0 = jnp.zeros((N, nu), dtype)
    return solver, params, (q0, xi0), us0, sol


def build_benchmark(name, ms, dtype=jnp.float64):
    import os

    from trajectory_optimization_matrix_lie_groups.utils import (
        load_benchmark_pickle,
    )

    spec = BENCHMARKS[name]
    data = load_benchmark_pickle(os.path.join(RESULTS_DIR, spec["pkl"]))
    out = build_from_prob(data["prob"], spec["family"], ms,
                          tol=spec["tol"], iters=spec["iters"], dtype=dtype)
    return data, *out


def cut_reference(params, H):
    """Truncate a params dict's cost reference to the first H+1 entries.

    Shared by tests and probe scripts that cross-check engines on a short
    horizon slice of a benchmark problem.
    """
    cp = params["cost"]
    cut = lambda a: a[: H + 1]
    return {**params, "cost": cp._replace(
        q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
        Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))}
