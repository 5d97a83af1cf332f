"""Golden-trajectory parity for every reference benchmark problem.

Each case rebuilds the exact problem from the reference's results pickle and
requires the converged control sequence to match the stored solution within
the BASELINE 1e-4 gate (typically achieved at ~1e-9).
"""

import os

import numpy as np
import pytest

from trajectory_optimization_matrix_lie_groups.tasks.parity import (
    BENCHMARKS,
    RESULTS_DIR,
    build_benchmark,
)

pytestmark = pytest.mark.skipif(
    not os.path.isdir(RESULTS_DIR), reason="reference pickles absent"
)

CASES = [
    ("so3_tracking", True), ("so3_tracking", False),
    ("pendulum_swingup", True), ("pendulum_swingup", False),
    ("drone_racing", True), ("drone_racing", False),
    ("se3_generate", True), ("se3_generate", False),
    ("se3_drone_path", True), ("se3_drone_path", False),
]


@pytest.mark.parity
@pytest.mark.parametrize("name,ms", CASES, ids=[f"{n}-{'ms' if m else 'ss'}" for n, m in CASES])
def test_benchmark_parity(name, ms):
    data, solver, params, x0, us0, sol_key = build_benchmark(name, ms)
    (qs, xis), us, J_hist, grad_hist, defect_hist, state = solver.fit(
        params, x0, us0)
    us_ref = np.asarray(data[sol_key]["us"])
    err = float(np.max(np.abs(np.asarray(us) - us_ref)))
    J_ref = float(data[sol_key]["J_hist"][-1])
    assert err < 1e-4, (
        f"{name} {'MS' if ms else 'SS'}: max|us-us_ref|={err:.3e}, "
        f"J={J_hist[-1]:.8g} vs ref {J_ref:.8g}, iters={len(J_hist)} "
        f"vs ref {len(data[sol_key]['J_hist'])}"
    )
