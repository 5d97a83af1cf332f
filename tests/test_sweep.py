"""Perturbation-sweep harness on the virtual 8-device mesh."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.parallel import (
    BatchSolver,
    make_batch_mesh,
)
from trajectory_optimization_matrix_lie_groups.parallel.sweep import (
    build_x0_batch,
    run_sweep,
)
from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR
from trajectory_optimization_matrix_lie_groups.tasks.parity import build_benchmark

pytestmark = pytest.mark.multidevice


def test_sweep_two_params():
    data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    cfg = dataclasses.replace(solver.cfg, N=40, max_iterations=4,
                              tol_grad_norm=0.0, tol_d_norm=0.0)
    solver = LieILQR(solver.model, cfg)
    cp = params["cost"]
    cp_small = cp._replace(q_ref=cp.q_ref[:41], q_ref_inv=cp.q_ref_inv[:41],
                           Ad_ref=cp.Ad_ref[:41], xi_ref=cp.xi_ref[:41])
    params = {**params, "cost": cp_small}
    mesh = make_batch_mesh(8)
    bs = BatchSolver(solver, mesh=mesh)
    ranges = {
        "w_z": np.linspace(-0.5, 0.5, 16),
        "p_x": np.linspace(-1.0, 1.0, 16),
    }
    base_q0 = cp.q_ref[0]
    base_xi0 = cp.xi_ref[0]
    out = run_sweep(bs, params, ranges, base_q0, base_xi0, nu=6)
    assert set(out) == {"w_z", "p_x"}
    for r in out.values():
        assert r.us.shape == (16, 40, 6)
        assert np.all(np.isfinite(r.J_opt))
    # J should be minimal near the unperturbed value
    jz = out["p_x"].J_opt
    assert jz[np.argmin(np.abs(out["p_x"].values))] <= jz.max()


def test_build_x0_batch_angles():
    q0 = np.eye(4)
    xi0 = np.zeros(6)
    q0s, xi0s = build_x0_batch("th_z", jnp.asarray([0.0, 90.0]), q0, xi0)
    np.testing.assert_allclose(np.asarray(q0s[0]), np.eye(4), atol=1e-12)
    # 90 deg about z maps e_x -> e_y
    np.testing.assert_allclose(np.asarray(q0s[1][:3, 0]), [0, 1, 0], atol=1e-12)


def test_rollout_sweep_matches_serial():
    """Batched open-loop rollout sweep == a serial per-step rollout."""
    from trajectory_optimization_matrix_lie_groups.models import dynamics
    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.parallel.sweep import (
        run_rollout_sweep,
    )

    J = jnp.block([
        [jnp.diag(jnp.asarray([0.5, 0.7, 0.9])), jnp.zeros((3, 3))],
        [jnp.zeros((3, 3)), jnp.eye(3)],
    ])
    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(J, jnp.asarray(0.01))
    base_q0 = se3.from_rotation_translation(
        jnp.eye(3), jnp.asarray([1.0, 1.0, -1.0]))
    base_xi0 = jnp.asarray([0.0, 0.0, 1.0, 0.2, 0.0, 2.0])
    N = 50
    values = np.asarray([0.5, 1.0, 1.5])
    out = run_rollout_sweep(dyn, dp, {"w_z": values}, base_q0, base_xi0, N=N)
    res = out["w_z"]
    assert res.qs.shape == (3, N + 1, 4, 4)
    assert np.all(np.isfinite(res.qs)) and np.all(np.isfinite(res.xis))

    # serial oracle for the middle lane
    q, xi = base_q0, base_xi0.at[2].set(1.0)
    for i in range(N):
        q, xi = dyn.step(dp, q, xi, jnp.zeros(6), i)
    np.testing.assert_allclose(res.qs[1, -1], np.asarray(q), atol=1e-12)
    np.testing.assert_allclose(res.xis[1, -1], np.asarray(xi), atol=1e-12)
