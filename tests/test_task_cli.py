"""Smoke tests for the task-runner CLI (fast tasks only)."""

import json

import pytest

from trajectory_optimization_matrix_lie_groups.tasks.run import main


@pytest.mark.parity
def test_cli_drone_ms(capsys):
    main(["drone_ms"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"]
    assert out["us_vs_reference_max_err"] < 1e-4


@pytest.mark.parity
def test_cli_pendulum_ms(capsys):
    main(["pendulum3d_ms"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"]
    assert out["us_vs_reference_max_err"] < 1e-4


def test_cli_dynamics_sim(capsys):
    main(["dynamics_sim"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # error-state propagation about the anchor stays close to the exact
    # rollout over a short horizon; velocity part is exact by construction
    assert out["vel_divergence_max"] < 1e-10
    assert out["pose_divergence_max"] < 0.05
    # open-loop pendulum released at 10 deg oscillates through the hanging
    # equilibrium and stays bounded (ref main_pendulum3d_dynamics.py)
    assert out["pendulum_swings"]


@pytest.mark.parity
def test_cli_mpc_native(capsys):
    from trajectory_optimization_matrix_lie_groups import native

    if native.LIB is None:
        pytest.skip("no native toolchain")
    main(["mpc_native"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 150
    # receding-horizon loop shrinks the injected initial perturbation
    assert out["tracking_err_shrink_ratio"] < 0.8


@pytest.mark.parity
def test_cli_cost_landscape(capsys):
    main(["cost_landscape"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for grid in out["grids"].values():
        assert grid["min"] >= 0.0
        assert grid["max"] > 0.0


@pytest.mark.parity
def test_cli_errstate_tracking(capsys):
    main(["errstate_tracking"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"]
    assert out["final_err_norm"] < 0.05


@pytest.mark.parity
def test_cli_benchmark_compare(capsys, tmp_path):
    main(["benchmark_compare", "--plot", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    s = out["solvers"]
    # --plot writes the reference-schema result pickle (round-2 writer,
    # tasks/run.py save_benchmark_pickle call) — verify it round-trips
    from trajectory_optimization_matrix_lie_groups.utils import (
        load_benchmark_pickle,
    )

    data = load_benchmark_pickle(s["pickle"])
    assert "prob" in data and "ms_ilqr" in data
    assert data["ms_ilqr"]["us"].shape[1] == 6
    assert data["prob"]["q_ref"].shape[0] == out["horizon"] + 1
    # cross-solver agreement (the reference's de-facto integration test)
    assert out["solvers"]["ms_ss_J_gap"] < 1.0
    for name in ("ms_ilqr", "ss_ilqr"):
        assert s[name]["orthogonality_violation_max"] < 1e-5
        assert s[name]["dynamics_violation_max"] < 1e-5
    for name in ("baseline_dynconstr", "baseline_logcost",
                 "baseline_stabilized"):
        assert s[name]["orthogonality_violation_max"] < 1e-2


@pytest.mark.parity
def test_cli_benchmark_compare_so3(capsys):
    main(["benchmark_compare_so3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pend = out["pendulum_swingup"]["solvers"]
    # MS and SS agree on the pendulum; log-cost baselines land near the
    # Lie solvers' objective; all matrix baselines stay near-orthogonal
    assert pend["ms_ss_J_gap"] < 1e-3
    assert abs(pend["baseline_logcost"]["J_final"]
               - pend["ms_ilqr"]["J_final"]) < 0.5
    for k, v in pend.items():
        if isinstance(v, dict) and "orthogonality_violation_max" in v:
            assert v["orthogonality_violation_max"] < 1e-2


@pytest.mark.parity
def test_cli_se3_al_ms_associative(capsys):
    """The constrained AL task now runs on the PD-safe parallel-prefix
    backward (backward='associative') — VERDICT round-2 item 3 wiring."""
    main(["se3_al_ms"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["constr_converged"]
    assert out["max_violation"] < 1e-2
    assert out["u_range"][0] >= -100.1 and out["u_range"][1] <= 100.1
