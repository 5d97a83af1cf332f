"""Utility-layer tests: reference generation, rotations, metrics, landscape."""

import os

import numpy as np

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops import se3, so3
from trajectory_optimization_matrix_lie_groups.utils import metrics, rotations
from trajectory_optimization_matrix_lie_groups.utils.trajectories import (
    generate_reference,
    load_reference_triple,
    save_reference_triple,
)
from trajectory_optimization_matrix_lie_groups.viz.cost_landscape import (
    pose_error_grid,
)


def test_generate_reference_roundtrip(tmp_path):
    xi = np.array([0.0, 0.0, 1.0, 2.0, 0.0, 0.2])
    q_ref, xi_ref = generate_reference(np.eye(4), xi, N=50, dt=0.01)
    assert q_ref.shape == (51, 4, 4)
    # consistency: q_{i+1} = q_i Exp(xi dt)
    d = se3.rminus(jnp.asarray(q_ref[1:]), jnp.asarray(q_ref[:-1]) @ se3.exp(jnp.asarray(xi_ref[:-1]) * 0.01))
    assert float(jnp.abs(d).max()) < 1e-12
    p = str(tmp_path / "ref.npy")
    save_reference_triple(p, q_ref, xi_ref, 0.01)
    q2, x2, dt = load_reference_triple(p)
    np.testing.assert_allclose(q2, q_ref)
    assert dt == 0.01


def test_rotation_conversions():
    rpy = jnp.array([0.2, -0.4, 1.1])
    q = rotations.euler_zyx_to_quat(rpy)
    R = rotations.quat_to_matrix(q)
    np.testing.assert_allclose(np.asarray(rotations.matrix_to_euler_zyx(R)),
                               np.asarray(rpy), atol=1e-10)
    w = jnp.array([0.3, 0.4, 0.0])
    np.testing.assert_allclose(float(rotations.rotation_angle(so3.exp(w))),
                               0.5, atol=1e-10)


def test_metrics_orthogonality():
    qs = se3.exp(0.3 * jnp.ones((5, 6)))
    v = metrics.orthogonality_violation(qs)
    assert float(jnp.max(v)) < 1e-12
    bad = qs.at[:, 0, 0].multiply(1.01)
    assert float(jnp.max(metrics.orthogonality_violation(bad))) > 1e-3


def test_cost_landscape_grid():
    Z, TZ, TY = pose_error_grid(np.eye(4), np.linspace(-30, 30, 7),
                                np.linspace(-30, 30, 5),
                                np.diag([10.0, 10, 10, 1, 1, 1]))
    assert Z.shape == (7, 5)
    # minimum at the unperturbed center
    assert Z[3, 2] <= Z.min() + 1e-9


def test_replay_fallback(tmp_path):
    """Without rerun installed, replay degrades to the quat-pos export."""
    from trajectory_optimization_matrix_lie_groups.viz.replay import (
        replay_trajectory,
    )

    qs = se3.exp(0.1 * jnp.ones((4, 6)))
    out = replay_trajectory(qs, dt=0.01,
                            fallback_path=str(tmp_path / "traj.npy"))
    qp = np.load(out)
    assert qp.shape == (4, 7)
    # unit quaternions
    np.testing.assert_allclose(np.linalg.norm(qp[:, :4], axis=1), 1.0,
                               atol=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    """Solver-state pytrees (incl. NamedTuples) round-trip through orbax."""
    from trajectory_optimization_matrix_lie_groups.models import costs
    from trajectory_optimization_matrix_lie_groups.utils import checkpoint

    state = {
        "us": jnp.arange(12.0).reshape(2, 6),
        "step": np.int64(7),
        "al": costs.ALParams(
            cost=None, constr=None,
            lmbd=jnp.ones((3, 4)), Imu=jnp.zeros((3, 4, 4)),
            mu=jnp.asarray(0.5)),
    }
    p = checkpoint.save(str(tmp_path / "ckpt"), state)
    back = checkpoint.restore(p, template=state)
    np.testing.assert_array_equal(np.asarray(back["us"]),
                                  np.asarray(state["us"]))
    assert isinstance(back["al"], costs.ALParams)
    np.testing.assert_array_equal(np.asarray(back["al"].lmbd),
                                  np.ones((3, 4)))
    assert float(back["al"].mu) == 0.5


def test_interactive_viewers(tmp_path):
    """Slider viewers construct and scrub headlessly; animation writes a gif."""
    import jax.numpy as jnp

    from trajectory_optimization_matrix_lie_groups.models import dynamics
    from trajectory_optimization_matrix_lie_groups.ops import se3
    from trajectory_optimization_matrix_lie_groups.parallel.sweep import (
        SweepResult,
        run_rollout_sweep,
    )
    from trajectory_optimization_matrix_lie_groups.viz import interactive

    J = jnp.eye(6)
    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(J, jnp.asarray(0.01))
    base_q0 = se3.from_rotation_translation(jnp.eye(3), jnp.zeros(3))
    base_xi0 = jnp.asarray([0.0, 0.0, 1.0, 1.0, 0.0, 0.0])
    out = run_rollout_sweep(dyn, dp, {"w_z": np.asarray([0.5, 1.0, 1.5])},
                            base_q0, base_xi0, N=20)
    res = out["w_z"]

    fig, slider, update = interactive.rollout_slider(res)
    update(2)  # programmatic scrub must not raise
    import matplotlib.pyplot as plt
    plt.close(fig)

    sw = SweepResult(param="w_z", values=res.values,
                     J_opt=np.asarray([3.0, 2.0, 4.0]),
                     grad_norm=np.zeros(3), converged=np.ones(3, bool),
                     us=np.random.default_rng(0).normal(size=(3, 20, 6)))
    fig2, s2, u2 = interactive.sweep_slider(sw)
    u2(1)
    plt.close(fig2)

    gif = str(tmp_path / "sweep.gif")
    interactive.rollout_animation(res, gif)
    import os
    assert os.path.getsize(gif) > 0


def test_save_benchmark_pickle_roundtrip(tmp_path):
    """Reference-schema result pickle (benchmark_SE3_tracking.py:272-345):
    a 'prob' spec entry + one entry per solver with xs/us/histories; must
    round-trip through load_benchmark_pickle with arrays intact."""
    from trajectory_optimization_matrix_lie_groups.utils.trajectories import (
        load_benchmark_pickle,
        save_benchmark_pickle,
    )

    N = 4
    q_ref, xi_ref = generate_reference(
        np.eye(4), np.array([0, 0, 0.3, 1.0, 0, 0]), N=N, dt=0.01)
    prob = dict(J=np.eye(6), dt=0.01, q_ref=q_ref, xi_ref=xi_ref,
                x0=(q_ref[0], xi_ref[0]),
                Q=np.eye(12), P=np.eye(12), R=np.eye(6))
    qs = jnp.asarray(q_ref)
    solvers = {
        "ms_ilqr": dict(xs=dict(qs=qs, xis=jnp.asarray(xi_ref)),
                        us=jnp.zeros((N, 6)),
                        J_hist=[3.0, 2.0, 1.0], grad_hist=[1e-1, 1e-3],
                        defect_hist=[1e-2, 1e-6]),
        "baseline": dict(xs=np.zeros((N + 1, 12)), us=np.zeros((N, 6)),
                         J_hist=[2.5], grad_hist=[1e-2]),
    }
    path = save_benchmark_pickle(str(tmp_path / "res.pkl"), prob, solvers)
    data = load_benchmark_pickle(path)
    assert set(data) == {"prob", "ms_ilqr", "baseline"}
    np.testing.assert_allclose(data["prob"]["q_ref"], q_ref)
    np.testing.assert_allclose(data["prob"]["x0"][1], xi_ref[0])
    # jnp arrays became numpy; nested xs dict preserved
    ms = data["ms_ilqr"]
    assert isinstance(ms["us"], np.ndarray)
    np.testing.assert_allclose(ms["xs"]["qs"], q_ref)
    assert ms["J_hist"] == [3.0, 2.0, 1.0]
    assert ms["defect_hist"][-1] == 1e-6
