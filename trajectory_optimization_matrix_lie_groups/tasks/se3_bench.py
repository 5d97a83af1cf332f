"""The bench's N=200 SE(3) multiple-shooting tracking problem, built in-repo.

Weights and step follow the reference's SE(3) MS tracking script
(`main_SE3ddp_tracking_exact_ms.py:150-165`, SURVEY §2.4): dt = 0.004,
Q = diag(25·3, 10·3, 1·6), P = 10 Q, R = 1e-5·I, cut to an N = 200 horizon.
The reference path is generated here from a seed
(`utils/trajectories.generate_reference`: twist integration, as the
reference makes its `.npy` paths): a screw motion with seeded smooth
sinusoidal twist perturbations.  The initial state is the path's first
pose and twist offset by a seeded perturbation.

The inertia is the one `tasks/al_bench.py` uses (Ib = diag(0.5, 0.7, 0.9),
m = 1): the inertia of the reference's stored benchmark problem is not part
of this repository.

Used by bench.py, chip_smoke.py, scripts/gen_bench_golden.py (the f64 CPU
golden in tasks/golden/bench_se3_n200_*.npy) and the tests.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from trajectory_optimization_matrix_lie_groups.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups.models.base import make_model
from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.utils.trajectories import (
    generate_reference,
)

__all__ = ["HORIZON", "DT", "SEED", "GOLDEN_DIR", "AL_BOX_FRACTION",
           "problem_np64", "build_problem", "build_problem_np64",
           "load_golden", "al_box", "al_summary"]

HORIZON = 200
DT = 0.004
SEED = 0
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
# the input box of the constrained (AL) runs, as a fraction of the golden's
# largest |u| per component (see `al_box`)
AL_BOX_FRACTION = 0.25
AL_MIN_CONVERGED = 0.8


def _inertia():
    Ib = np.diag([0.5, 0.7, 0.9])
    return np.block([[Ib, np.zeros((3, 3))], [np.zeros((3, 3)), np.eye(3)]])


def problem_np64(horizon=HORIZON, seed=SEED):
    """The problem's data as float64 numpy: dict(J, dt, Q, R, P, q_ref,
    xi_ref, q0, xi0).  The path is integrated in float64 on the host CPU,
    so every process and device builds the same problem."""
    rng = np.random.default_rng(seed)
    w0 = np.array([0.0, 0.0, 1.0])
    v0 = np.array([2.0, 0.0, 0.2])
    amp = rng.uniform(0.2, 0.6, size=(2, 6))     # (sin, cos) amplitudes
    freq = rng.uniform(0.5, 2.0, size=6)         # Hz
    base = np.concatenate([w0, v0])

    def twist(i):
        t = i * DT
        ph = 2.0 * np.pi * freq * t
        return base + amp[0] * np.sin(ph) + amp[1] * (np.cos(ph) - 1.0)

    try:
        host = jax.devices("cpu")[0]
    except RuntimeError:  # a process restricted to the accelerator
        host = None
    with jax.enable_x64(True), jax.default_device(host):
        q_ref, xi_ref = generate_reference(np.eye(4), twist, horizon, DT)
        dq = np.concatenate([rng.normal(0.0, 0.1, 3), rng.normal(0.0, 0.1, 3)])
        q0 = np.asarray(SE3.normalize(jnp.asarray(q_ref[0])
                                      @ SE3.exp(jnp.asarray(dq))), np.float64)
    xi0 = xi_ref[0] + rng.normal(0.0, 0.1, 6)
    Q = np.diag([25.0] * 3 + [10.0] * 3 + [1.0] * 6)
    return dict(J=_inertia(), dt=DT, Q=Q, R=1e-5 * np.eye(6), P=10.0 * Q,
                q_ref=np.asarray(q_ref, np.float64),
                xi_ref=np.asarray(xi_ref, np.float64), q0=q0, xi0=xi0)


def build_problem(dtype, horizon=HORIZON):
    """Returns (model, params {dyn, cost}, q0, xi0, q_ref, xi_ref) in
    ``dtype``, ready for the solvers."""
    prob = problem_np64(horizon)
    dyn = dynamics.se3_dynamics()
    dp = dynamics.se3_params(jnp.asarray(prob["J"], dtype),
                             jnp.asarray(prob["dt"], dtype))
    cd = costs.tracking_cost(SE3, 6)
    cp = costs.tracking_cost_params(
        SE3, jnp.asarray(prob["Q"], dtype), jnp.asarray(prob["R"], dtype),
        jnp.asarray(prob["P"], dtype), jnp.asarray(prob["q_ref"], dtype),
        jnp.asarray(prob["xi_ref"], dtype))
    model, params = make_model(dyn, cd, dp, cp)
    return (model, params, jnp.asarray(prob["q0"], dtype),
            jnp.asarray(prob["xi0"], dtype), prob["q_ref"], prob["xi_ref"])


def build_problem_np64(horizon=HORIZON):
    """Host-side float64 numpy params {dyn, cost} — the double-f32 polish's
    split input (full precision must survive without x64 on the device;
    see solvers/df_pipeline.split_pytree)."""
    from trajectory_optimization_matrix_lie_groups.models.costs import (
        TrackingCostParams,
    )
    from trajectory_optimization_matrix_lie_groups.models.dynamics import (
        SE3Params,
    )

    prob = problem_np64(horizon)
    J, Q, R, P = prob["J"], prob["Q"], prob["R"], prob["P"]
    q_ref, xi_ref = prob["q_ref"], prob["xi_ref"]
    q_ref_inv = np.swapaxes(q_ref, -1, -2).copy()
    q_ref_inv[..., :3, 3] = -np.einsum(
        "nji,nj->ni", q_ref[..., :3, :3], q_ref[..., :3, 3])
    q_ref_inv[..., 3, :3] = 0.0
    Rr, pr = q_ref[..., :3, :3], q_ref[..., :3, 3]
    hat = np.zeros(pr.shape[:-1] + (3, 3))
    hat[..., 0, 1], hat[..., 0, 2] = -pr[..., 2], pr[..., 1]
    hat[..., 1, 0], hat[..., 1, 2] = pr[..., 2], -pr[..., 0]
    hat[..., 2, 0], hat[..., 2, 1] = -pr[..., 1], pr[..., 0]
    Ad = np.zeros((horizon + 1, 6, 6))
    Ad[..., :3, :3] = Rr
    Ad[..., 3:, 3:] = Rr
    Ad[..., 3:, :3] = hat @ Rr
    dp64 = SE3Params(J=J, Jinv=np.linalg.inv(J), Ib=J[:3, :3],
                     m=np.float64(J[4, 4]), dt=np.float64(prob["dt"]),
                     ref_coad_swap=np.asarray(True))
    cp64 = TrackingCostParams(
        Q1=Q[:6, :6], Q2=Q[6:, 6:], R=R, P1=P[:6, :6], P2=P[6:, 6:],
        q_ref=q_ref, q_ref_inv=q_ref_inv, Ad_ref=Ad, xi_ref=xi_ref)
    return {"dyn": dp64, "cost": cp64}


def load_golden():
    """(q0, xi0, us) of the committed f64 golden solve."""
    ld = lambda s: np.load(os.path.join(GOLDEN_DIR, f"bench_se3_n200_{s}.npy"))
    return ld("q0"), ld("xi0"), ld("us")


def al_box():
    """(lb, ub) of the bench's input box: +-AL_BOX_FRACTION x the golden's
    largest |u| per component.

    The AL's first outer penalizes every constraint (Imu = mu0 everywhere,
    as the reference does), which pulls the controls — flat in the cost
    under R = 1e-5 — toward 0.  So only a box well inside the unconstrained
    optimum binds: at 0.25 it is active at the solution and lane 0 takes 12
    outers; at 0.3 the first outer already lands strictly inside it."""
    box = AL_BOX_FRACTION * np.abs(load_golden()[2]).max(axis=0)
    return -box, box


def al_summary(res, lb, ub, tol=1e-2):
    """Statistics of an input-box AL solve (`ALPipelineSolver.solve`), and
    the checks that it did constrained work: more than one outer, the box
    active at the solution, lane 0 and at least AL_MIN_CONVERGED of the
    lanes within ``tol``, every control finite.  Raises AssertionError."""
    mv = np.asarray(res.max_violation)
    us = np.asarray(res.us)
    at_box = (us <= lb + 1e-3) | (us >= ub - 1e-3)
    stats = dict(outers=int(res.outer_iterations),
                 lanes_converged_frac=float((mv < tol).mean()),
                 lane0_violation=float(mv[0]),
                 max_violation_max=float(mv.max()),
                 active_frac=float(at_box.mean()),
                 all_finite=bool(np.isfinite(us).all()))
    assert stats["all_finite"], "non-finite AL lanes"
    assert stats["outers"] > 1, f"the box did not bind: {stats}"
    assert stats["active_frac"] > 0, f"no control at the box: {stats}"
    assert stats["lane0_violation"] < tol, f"lane 0 infeasible: {stats}"
    assert stats["lanes_converged_frac"] >= AL_MIN_CONVERGED, \
        f"too few lanes converged: {stats}"
    return stats
