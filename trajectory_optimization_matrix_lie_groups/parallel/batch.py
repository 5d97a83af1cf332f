"""Batched / sharded trajectory optimization over a device mesh.

The reference's only multi-worker path is `joblib.Parallel` process fan-out
over independent solves (`visualization/perturb_all_compute.py:245`).  Here
the same workload — thousands of perturbed initial conditions, MPC instances,
parameter-sweep points — is a single SPMD program: `vmap` over the problem
batch inside one jitted solve loop, sharded over the mesh `batch` axis with
`jax.sharding.NamedSharding` so XLA partitions every op and inserts ICI
collectives only for the (tiny) cross-problem reductions.

State per problem is KBs, so scaling comes from packing many problems per
chip (amortizing the serial scan latency of the backward pass across the
batch) and never letting DCN see anything but scalar result gathers.
"""

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import LieILQR


def make_batch_mesh(n_devices: Optional[int] = None, axis: str = "batch") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


class BatchSolver:
    """vmap-over-problems front end for a LieILQR solver, mesh-shardable.

    `solve_batch(params, x0s, us_inits)` runs B independent solves to the
    solver's convergence/iteration budget in one jitted while_loop (batched
    lanes keep stepping until every lane converged or hit the cap — the
    standard masked-lane formulation of the per-problem loop).
    """

    def __init__(self, solver: LieILQR, mesh: Optional[Mesh] = None,
                 axis: str = "batch"):
        self.solver = solver
        self.mesh = mesh
        self.axis = axis

        def _solve_one(params, q0, xi0, us0, q_ref, xi_ref):
            state = solver._init_state_ms(q0, xi0, us0, q_ref, xi_ref) \
                if solver.cfg.multiple_shooting \
                else solver._init_state_ss(params, q0, xi0, us0)
            return solver._solve_loop(params, state)

        batched = jax.vmap(_solve_one, in_axes=(None, 0, 0, 0, None, None))

        if mesh is not None:
            shard = NamedSharding(mesh, P(axis))
            rep = NamedSharding(mesh, P())
            self._solve_batch = jax.jit(
                batched,
                in_shardings=(rep, shard, shard, shard, rep, rep),
                out_shardings=shard,
            )
        else:
            self._solve_batch = jax.jit(batched)

    def solve_batch(self, params, q0s, xi0s, us_inits, q_ref=None, xi_ref=None):
        if q_ref is None:
            q_ref = params["cost"].q_ref
            xi_ref = params["cost"].xi_ref
        return self._solve_batch(params, jnp.asarray(q0s), jnp.asarray(xi0s),
                                 jnp.asarray(us_inits), jnp.asarray(q_ref),
                                 jnp.asarray(xi_ref))
