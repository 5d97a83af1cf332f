"""Anchored-pose fast solver: algebraic equivalence + f32 accuracy gain."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.solvers.anchored import (
    AnchoredFastSolver,
    build_anchored,
)
from trajectory_optimization_matrix_lie_groups.utils import load_benchmark_pickle

PKL = "/root/reference/visualization/results_benchmark_2nd_draft/results_se3_tracking_benchmark.pkl"
GOLD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "trajectory_optimization_matrix_lie_groups", "tasks", "golden", "")


@pytest.mark.parity
def test_anchored_f64_matches_golden():
    data = load_benchmark_pickle(PKL)
    prob = data["prob"]
    H = 200
    q_ref = np.asarray(prob["q_ref"])[: H + 1]
    xi_ref = np.asarray(prob["xi_ref"])[: H + 1]
    us_golden = np.load(GOLD + "bench_se3_n200_us.npy")
    q0 = np.load(GOLD + "bench_se3_n200_q0.npy")
    xi0 = np.load(GOLD + "bench_se3_n200_xi0.npy")

    ap = build_anchored(prob["J"], float(prob["dt"]), prob["Q"], prob["R"],
                        prob["P"], q_ref, xi_ref, dtype=jnp.float64)
    fs = AnchoredFastSolver(ap, N=H, iterations=14)
    q0_loc = np.linalg.inv(q_ref[0]) @ q0
    qs, xis, us, J, grad = fs.solve(
        jnp.asarray(q0_loc)[None], jnp.asarray(xi0)[None],
        jnp.zeros((1, H, 6)))
    err = np.abs(np.asarray(us[0]) - us_golden).max()
    assert err < 1e-4, f"anchored f64 err {err:.3e}"
    assert float(grad[0]) < 1e-8


@pytest.mark.parity
def test_anchored_f32_gradient_floor_improves():
    """The anchored representation lowers the f32 gradient floor by removing
    world-frame pose cancellation (~1.5e-7 -> ~2e-8 on the bench problem)."""
    data = load_benchmark_pickle(PKL)
    prob = data["prob"]
    H = 120
    q_ref = np.asarray(prob["q_ref"])[: H + 1]
    xi_ref = np.asarray(prob["xi_ref"])[: H + 1]
    q0 = np.load(GOLD + "bench_se3_n200_q0.npy")
    xi0 = np.load(GOLD + "bench_se3_n200_xi0.npy")

    ap = build_anchored(prob["J"], float(prob["dt"]), prob["Q"], prob["R"],
                        prob["P"], q_ref, xi_ref, dtype=jnp.float32)
    fs = AnchoredFastSolver(ap, N=H, iterations=14)
    q0_loc = np.linalg.inv(q_ref[0]) @ q0
    qs, xis, us, J, grad = fs.solve(
        jnp.asarray(q0_loc, jnp.float32)[None],
        jnp.asarray(xi0, jnp.float32)[None],
        jnp.zeros((1, H, 6), jnp.float32))
    assert np.isfinite(float(J[0]))
    assert float(grad[0]) < 1e-7
