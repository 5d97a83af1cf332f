"""Mesh-sharded front end for the lane-layout pipeline solver.

The headline engine (`solvers/pipeline.PipelineSolver`) is a
single-device program: its kernels put the problem batch on the lanes, so
XLA cannot auto-partition them.  This wrapper scales the same workload
across a device mesh with `shard_map`: the batch axis is split over devices
and every device runs the full iteration loop on its local shard.
Problems are independent (the reference's `joblib` sweep semantics,
`visualization/perturb_all_compute.py:245`), so no collectives are needed
inside the solve — communication is confined to the initial shard
placement and the final (sharded) result.
"""

from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    PipelineSolver,
)


class ShardedPipelineSolver:
    """`PipelineSolver.solve` over a device mesh.

    The global batch B must divide by the mesh size.  Dynamics/cost params are replicated; problem inputs and all outputs are
    sharded on ``axis``.
    """

    def __init__(self, solver: PipelineSolver, mesh: Mesh,
                 axis: str = "batch"):
        self.solver = solver
        self.mesh = mesh
        self.axis = axis
        rep, shard = P(), P(axis)

        def _solve(dyn, cost, q0s, xi0s, us0):
            return solver._solve(dyn, cost, q0s, xi0s, us0)

        sm = shard_map(_solve, mesh=mesh,
                       in_specs=(rep, rep, shard, shard, shard),
                       out_specs=shard, check_vma=False)
        self._solve_jit = jax.jit(sm)
        self._shard = NamedSharding(mesh, shard)

    def solve(self, dyn, cost, q0s, xi0s, us0):
        n_dev = self.mesh.devices.size
        B = q0s.shape[0]
        if B % n_dev:
            raise ValueError(f"batch {B} not divisible by mesh size {n_dev}")
        put = lambda x: jax.device_put(jnp.asarray(x), self._shard)
        return self._solve_jit(dyn, cost, put(q0s), put(xi0s), put(us0))


def make_sharded_pipeline(N: int, iterations: int, dt: float,
                          mesh: Optional[Mesh] = None, axis: str = "batch",
                          **solver_kwargs) -> ShardedPipelineSolver:
    """Build a PipelineSolver and wrap it over ``mesh`` (defaults to
    all local devices on a 1-d batch mesh)."""
    if mesh is None:
        from trajectory_optimization_matrix_lie_groups.parallel.batch import (
            make_batch_mesh,
        )
        mesh = make_batch_mesh(axis=axis)
    solver = PipelineSolver(N=N, iterations=iterations, dt=dt,
                                  **solver_kwargs)
    return ShardedPipelineSolver(solver, mesh, axis=axis)
