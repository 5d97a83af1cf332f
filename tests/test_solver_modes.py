"""Solver-mode coverage: merit line search, linear (associative-scan)
rollout — both must reach the same stationary point as the default path."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR
from trajectory_optimization_matrix_lie_groups.tasks.parity import build_benchmark


@pytest.mark.parity
def test_ms_line_search_same_solution():
    """MS + merit line search (main_SO3ddp_tracking_exact_ms.py:145-149 uses
    line_search=True) must converge to the same controls as the accept-all
    path on the SO3 tracking benchmark."""
    data, solver, params, x0, us0, sol_key = build_benchmark("so3_tracking", True)
    cfg_ls = dataclasses.replace(solver.cfg, line_search=True)
    solver_ls = LieILQR(solver.model, cfg_ls)
    (_, _), us_ls, J_hist, grad_hist, _, st = solver_ls.fit(params, x0, us0)
    assert bool(st.converged), f"LS run failed to converge: grad {grad_hist[-1]}"
    us_ref = np.asarray(data[sol_key]["us"])
    err = np.max(np.abs(np.asarray(us_ls) - us_ref))
    assert err < 1e-4, f"line-search solution off by {err:.3e}"


@pytest.mark.parity
def test_ms_linear_rollout_same_solution():
    """MS + linear gap-closing rollout (lax.associative_scan) must converge
    to the same controls (the reference's 'linear' mode,
    traopt_controller.py:2720-2726)."""
    data, solver, params, x0, us0, sol_key = build_benchmark("so3_tracking", True)
    cfg_lin = dataclasses.replace(solver.cfg, rollout="linear")
    solver_lin = LieILQR(solver.model, cfg_lin)
    (_, _), us_lin, J_hist, grad_hist, _, st = solver_lin.fit(params, x0, us0)
    assert bool(st.converged)
    us_ref = np.asarray(data[sol_key]["us"])
    err = np.max(np.abs(np.asarray(us_lin) - us_ref))
    assert err < 1e-4, f"linear-rollout solution off by {err:.3e}"


@pytest.mark.parity
def test_ms_fixed_mu_backward_same_solution():
    """Throughput mode (fixed-mu sequential Riccati) must reach the same
    stationary point on the SO3 tracking benchmark."""
    data, solver, params, x0, us0, sol_key = build_benchmark("so3_tracking", True)
    cfg_f = dataclasses.replace(solver.cfg, backward="sequential_fixed")
    solver_f = LieILQR(solver.model, cfg_f)
    (_, _), us_f, J_hist, grad_hist, _, st = solver_f.fit(params, x0, us0)
    assert bool(st.converged)
    us_ref = np.asarray(data[sol_key]["us"])
    err = np.max(np.abs(np.asarray(us_f) - us_ref))
    assert err < 1e-4, f"fixed-mu solution off by {err:.3e}"


@pytest.mark.parity
def test_ms_associative_backward_same_solution():
    data, solver, params, x0, us0, sol_key = build_benchmark("so3_tracking", True)
    cfg_a = dataclasses.replace(solver.cfg, backward="associative")
    solver_a = LieILQR(solver.model, cfg_a)
    (_, _), us_a, J_hist, grad_hist, _, st = solver_a.fit(params, x0, us0)
    assert bool(st.converged)
    us_ref = np.asarray(data[sol_key]["us"])
    err = np.max(np.abs(np.asarray(us_a) - us_ref))
    assert err < 1e-4, f"associative solution off by {err:.3e}"


@pytest.mark.parity
@pytest.mark.parametrize("name", ["se3_tracking", "se3_generate",
                                  "se3_drone_path", "drone_racing",
                                  "so3_tracking", "pendulum_swingup"])
def test_ms_associative_all_benchmarks(name):
    """Round-2 item 3 'done' gate: the PD-safe parallel-prefix backward
    (`riccati.parallel_backward_adaptive` via backward='associative')
    reproduces every reference benchmark's converged controls within the
    1e-4 parity gate."""
    data, solver, params, x0, us0, sol_key = build_benchmark(name, True)
    cfg_a = dataclasses.replace(solver.cfg, backward="associative")
    solver_a = LieILQR(solver.model, cfg_a)
    (_, _), us_a, J_hist, grad_hist, _, st = solver_a.fit(params, x0, us0)
    us_ref = np.asarray(data[sol_key]["us"])
    err = np.max(np.abs(np.asarray(us_a) - us_ref))
    assert err < 1e-4, f"{name}: associative solution off by {err:.3e}"
