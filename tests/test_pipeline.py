"""Lane-layout pipeline: same iterates as FastBatchSolver; the generated
stage-recursion kernels (`ops/lanewise.py`, host build on the CPU) against
the `lax.scan` over the same stage functions; the kernel-target choice."""

import functools
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models import costs, dynamics
from trajectory_optimization_matrix_lie_groups.models.base import make_model
from trajectory_optimization_matrix_lie_groups.ops import lanewise
from trajectory_optimization_matrix_lie_groups.ops import lie_lane as ll
from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.solvers import pipeline
from trajectory_optimization_matrix_lie_groups.solvers.batched import FastBatchSolver
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups.tasks import se3_bench
from trajectory_optimization_matrix_lie_groups.utils import platform

def _problem(H, gravity=False, dtype=jnp.float32):
    """The bench problem cut to H stages; ``gravity``: the same path
    tracked by the gravity/drone family (rigid body + 6x4 projection)."""
    prob = se3_bench.problem_np64(H)
    if gravity:
        dyn = dynamics.drone_dynamics()
        dp = dynamics.drone_params(jnp.asarray(prob["J"], dtype),
                                   jnp.asarray(prob["dt"], dtype))
        nu, R = 4, 1e-2 * np.eye(4)
    else:
        dyn = dynamics.se3_dynamics()
        dp = dynamics.se3_params(jnp.asarray(prob["J"], dtype),
                                 jnp.asarray(prob["dt"], dtype))
        nu, R = 6, prob["R"]
    cp = costs.tracking_cost_params(
        SE3, jnp.asarray(prob["Q"], dtype), jnp.asarray(R, dtype),
        jnp.asarray(prob["P"], dtype), jnp.asarray(prob["q_ref"], dtype),
        jnp.asarray(prob["xi_ref"], dtype))
    model, params = make_model(dyn, costs.tracking_cost(SE3, nu), dp, cp)
    return model, params, jnp.asarray(prob["q0"], dtype), \
        jnp.asarray(prob["xi0"], dtype), nu


def _batch(q0, xi0, B, H, nu, seed=0):
    dq = 0.05 * jax.random.normal(jax.random.PRNGKey(seed), (B, 6),
                                  dtype=q0.dtype)
    return (SE3.normalize(q0[None] @ SE3.exp(dq)),
            jnp.broadcast_to(xi0, (B, 6)), jnp.zeros((B, H, nu), q0.dtype))


def test_pipeline_matches_fast_batch():
    H, B, ITERS = 30, 3, 4
    model, params, q0, xi0, nu = _problem(H)
    cp, dp = params["cost"], params["dyn"]
    q0s, xi0s, us0s = _batch(q0, xi0, B, H, nu)

    fast = FastBatchSolver(model, N=H, iterations=ITERS)
    ref = fast.solve(params, q0s, xi0s, us0s, cp.q_ref, cp.xi_ref)
    pipe = PipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt))
    out = pipe.solve(dp, cp, q0s, xi0s, us0s)

    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us),
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out.J_opt), np.asarray(ref.J_opt),
                               rtol=1e-4)


def test_pipeline_drone_gravity():
    """The gravity/drone family (nu = 4) through the pipeline reproduces
    the generic engine's iterates."""
    H, B, ITERS = 20, 3, 3
    model, params, q0, xi0, nu = _problem(H, gravity=True)
    cp, dp = params["cost"], params["dyn"]
    q0s, xi0s, us0s = _batch(q0, xi0, B, H, nu, seed=3)
    ref = FastBatchSolver(model, N=H, iterations=ITERS).solve(
        params, q0s, xi0s, us0s, cp.q_ref, cp.xi_ref)
    out = PipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt),
                               gravity=True).solve(dp, cp, q0s, xi0s, us0s)
    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us),
                               atol=5e-4, rtol=1e-4)


def _lane_inputs(H, B, gravity):
    """One iteration's lane-layout inputs for the two recursions."""
    _, params, q0, xi0, nu = _problem(H, gravity=gravity)
    cp, dp = params["cost"], params["dyn"]
    q0s, xi0s, us0s = _batch(q0, xi0, B, H, nu, seed=1)
    us0s = us0s + 0.1
    pipe = PipelineSolver(N=H, iterations=1, dt=float(dp.dt),
                                gravity=gravity)
    qR, qp, xi, us, refs, consts, term_refs = pipe._prepare(
        dp, cp, q0s, xi0s, us0s)
    lin = pipe._linearize_lane(qR, qp, xi, us, refs, consts)
    lu = 2.0 * jnp.einsum("ij,njb->nib", cp.R, us)
    term = (qR[-1], qp[-1], xi[-1]) + term_refs
    return pipe, (qR, qp, xi, us, refs, consts, lin, lu, term)


def _both(pipe, fn):
    """fn evaluated with the kernels and with the scans."""
    outs = []
    for kernels in (True, False):
        pipe.kernels = kernels
        outs.append(jax.tree.map(np.asarray, fn(pipe)))
    return outs


# B = 37: the lane count is a multiple of nothing (the CUDA launch rounds
# the grid up and masks the tail lanes)
@pytest.mark.parametrize("gravity", [False, True])
def test_backward_kernel_matches_scan(gravity):
    pipe, (_, _, _, _, _, consts, lin, lu, term) = _lane_inputs(8, 37,
                                                                gravity)
    got, ref = _both(pipe, lambda p: p._backward_lane(lin, lu, term, consts))
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("gravity", [False, True])
def test_rollout_kernel_matches_scan(gravity):
    pipe, (qR, qp, xi, us, refs, consts, lin, lu, term) = _lane_inputs(
        8, 37, gravity)
    pipe.kernels = False
    k, K, _, _ = pipe._backward_lane(lin, lu, term, consts)
    got, ref = _both(pipe, lambda p: p._rollout_linearize_lane(
        qR, qp, xi, us, k, K, lin, refs, consts))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.shape == b.shape
        # the post-rollout defect is rounding noise: scale by the state
        scale = max(np.abs(b).max(), np.abs(np.asarray(xi)).max())
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-5 * scale)


def _bad_lanes(a):
    """Lanes (trailing axis) holding any non-finite entry."""
    a = np.asarray(a)
    return np.flatnonzero(~np.isfinite(a.reshape(-1, a.shape[-1])).all(0))


@pytest.mark.parametrize("gravity", [False, True])
def test_kernels_match_scans_on_a_nan_lane(gravity):
    """A NaN input poisons the same lanes in the kernel as in the scan (the
    kernel folds 0*x to 0, so single entries may differ, not lanes), and
    leaves every other lane as the scan computes it."""
    B = 37
    pipe, (qR, qp, xi, us, refs, consts, lin, lu, term) = _lane_inputs(
        8, B, gravity)
    lin_nan = dict(lin, lx=lin["lx"].at[3, 2, 5].set(jnp.nan))
    got_b, ref_b = _both(pipe, lambda p: p._backward_lane(
        lin_nan, lu, term, consts))
    pipe.kernels = False
    k, K, _, _ = pipe._backward_lane(lin, lu, term, consts)
    us_nan = us.at[2, 1, 9].set(jnp.nan)
    got_r, ref_r = _both(pipe, lambda p: p._rollout_linearize_lane(
        qR, qp, xi, us_nan, k, K, lin, refs, consts))
    for got, ref, lane in ((got_b, ref_b, 5), (got_r, ref_r, 9)):
        assert any(_bad_lanes(b).size for b in jax.tree.leaves(ref))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(_bad_lanes(a), _bad_lanes(b))
            assert set(_bad_lanes(b)) <= {lane}
            keep = np.arange(B) != lane
            np.testing.assert_allclose(
                a[..., keep], b[..., keep], rtol=1e-5,
                atol=2e-5 * max(np.abs(b[..., keep]).max(),
                                np.abs(np.asarray(xi)).max()))


def test_pipeline_kernels_match_scans():
    """Whole solves: generated kernels vs scans, AL terms included."""
    H, B, ITERS = 10, 5, 3
    _, params, q0, xi0, nu = _problem(H)
    cp, dp = params["cost"], params["dyn"]
    q0s, xi0s, us0s = _batch(q0, xi0, B, H, nu, seed=2)
    al = (-np.full(6, 20.0), np.full(6, 20.0),
          np.zeros((B, H + 1, 12)), np.full((B, H + 1, 12), 1e-2))
    outs = [PipelineSolver(H, ITERS, float(dp.dt), kernels=k).solve(
        dp, cp, q0s, xi0s, us0s, al=al) for k in (True, False)]
    np.testing.assert_allclose(np.asarray(outs[0].us),
                               np.asarray(outs[1].us), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(outs[0].J_opt),
                               np.asarray(outs[1].J_opt), rtol=1e-5)


def test_kernel_source_folds_constants():
    """Identity and zero blocks cost nothing in the generated code: a step
    multiplying by the identity emits no multiply, and a structurally zero
    output is stored as a literal."""
    B, N = 4, 3

    def init(c):
        return c["x0"], ()

    def step(c, carry, x):
        eye = ll._eye3(carry.dtype, carry.shape[2:])
        nxt = ll.matmul3(eye, carry) + x["dR"]
        return nxt, dict(R=nxt, zero=0.0 * nxt)

    consts = dict(x0=jnp.ones((3, 3, B), jnp.float32))
    xs = dict(dR=jnp.ones((N, 3, 3, B), jnp.float32))
    src = lanewise.kernel_source("t", step, init, consts, xs)[0]
    body = src[src.index("for (long long i"):src.index("#ifdef __CUDACC__\n__global__")]
    assert not re.search(r"\bv\d+ \* |\* v\d+\b", body)
    assert body.count("= (float)0x0.0p+0f;") == 9
    ys, _ = lanewise.lane_scan(step, init, consts, xs, kernel=True)
    ref, _ = lanewise.lane_scan(step, init, consts, xs)
    np.testing.assert_array_equal(np.asarray(ys["R"]), np.asarray(ref["R"]))
    np.testing.assert_array_equal(np.asarray(ys["zero"]), 0.0)


def test_kernel_source_rejects_lane_mixing():
    """Values must keep the batch on the trailing axis."""
    def init(c):
        return c["x"], ()

    def step(c, carry, x):
        return carry, dict(s=jnp.sum(carry, axis=-1, keepdims=True)
                           + 0.0 * carry)

    with pytest.raises(NotImplementedError, match="lane axis"):
        lanewise.kernel_source(
            "t", step, init, dict(x=jnp.ones((2, 4))),
            dict(y=jnp.ones((3, 2, 4))))


def test_kernel_target_choice(monkeypatch):
    assert platform.kernel_platform() == "cpu"
    assert not PipelineSolver(4, 1, 0.01).kernels
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert platform.kernel_platform() == "cuda"
    assert PipelineSolver(4, 1, 0.01).kernels
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="no kernel target"):
        platform.kernel_platform()


def test_bench_problem_matches_golden():
    """The in-repo bench problem at f64 converges to the committed golden
    (scripts/gen_bench_golden.py) through the batched engine."""
    model, params, q0, xi0, q_ref, xi_ref = se3_bench.build_problem(
        jnp.float64)
    gq0, gxi0, gus = se3_bench.load_golden()
    np.testing.assert_array_equal(np.asarray(q0), gq0)
    np.testing.assert_array_equal(np.asarray(xi0), gxi0)
    N = se3_bench.HORIZON
    out = FastBatchSolver(model, N=N, iterations=12).solve(
        params, q0[None], xi0[None], jnp.zeros((1, N, 6)),
        jnp.asarray(q_ref), jnp.asarray(xi_ref))
    assert float(out.grad_norm[0]) < 1e-8
    np.testing.assert_allclose(np.asarray(out.us[0]), gus, atol=1e-6)


def test_backward_step_is_riccati_stage():
    """The recursion step is `riccati_stage` with the constant Fu block."""
    _, (_, _, _, _, _, consts, lin, lu, term) = _lane_inputs(6, 5, False)
    c = dict(zip(("qRN", "qpN", "xiN", "RbiRN", "RbipN", "AdbN", "xibN",
                  "W1N", "W2N"), term), Fu=consts["Fu"], Luu=consts["Luu"])
    (Vx, Vxx), lN = pipeline.backward_init(c)
    x = {k: v[-1] for k, v in dict(Fx=lin["Fx"], d=lin["d"], lx=lin["lx"],
                                   lu=lu, lxx=lin["lxx"]).items()}
    _, y = functools.partial(pipeline.backward_step, nu=6, glow=False)(
        c, (Vx, Vxx), x)
    fu2 = consts["Fu"][6:]
    k, K, Qu, _, _ = pipeline.riccati_stage(
        x["Fx"], x["d"], x["lx"], x["lu"], x["lxx"], fu2,
        ll.transpose(fu2), consts["Luu"], Vx, Vxx, nu=6, glow=False)
    np.testing.assert_array_equal(np.asarray(y["k"]), np.asarray(k))
    np.testing.assert_array_equal(np.asarray(y["K"]), np.asarray(K))
    np.testing.assert_array_equal(np.asarray(y["gvec"]), np.asarray(Qu))
