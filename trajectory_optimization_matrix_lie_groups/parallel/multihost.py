"""Multi-host (multi-process) runtime: `jax.distributed`.

The reference is strictly single-process (SURVEY §2.6: its only fan-out is
`joblib.Parallel` OS forks, `visualization/perturb_all_compute.py:245`).
The JAX equivalent for >1 host is the `jax.distributed` runtime: all
hosts initialize against a coordinator, `jax.devices()` becomes the global
device list, and the batch mesh spans hosts so the SPMD batch solve runs
unchanged — problems are independent, so cross-host traffic is confined to
initial shard placement and result gathers.

Usage (same program on every host):

    from trajectory_optimization_matrix_lie_groups import parallel
    parallel.initialize_multihost(coordinator, num_processes, process_id)
    mesh = parallel.global_batch_mesh()
    q0s = parallel.distribute_batch(local_q0s, mesh)       # per-host shards
    solver = parallel.make_sharded_pipeline(..., mesh=mesh)
    out = solver.solve(dyn, cost, q0s, xi0s, us0)          # global arrays

Tested without accelerators by `tests/test_multihost.py`: two local CPU
processes with 4 virtual devices each form an 8-device global mesh and
reproduce the single-process solve exactly.
"""

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int,
                         local_device_ids: Optional[Sequence[int]] = None):
    """Join the jax.distributed runtime (idempotent per process).

    After this returns, `jax.devices()` lists every device in the job and
    `jax.local_devices()` this host's; all hosts must call it with the same
    coordinator before any other jax API touches a backend.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_batch_mesh(axis: str = "batch") -> Mesh:
    """1-d mesh over every device in the job (all hosts).

    Device order groups each host's devices contiguously, so a batch axis
    sharded over this mesh keeps each problem's data on one host and the
    cross-host (DCN) cut is between shard blocks, never inside one.
    """
    return Mesh(np.asarray(jax.devices()), (axis,))


def distribute_batch(local_batch, mesh: Mesh, axis: str = "batch"):
    """Build a global batch array from per-process local shards.

    Every process passes its own (B_local, ...) block; the result is a
    global (num_processes * B_local, ...) jax.Array sharded over ``axis``
    without any cross-host copy.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding,
                                                  np.asarray(local_batch))


def gather_to_all(x):
    """All-gather a (possibly sharded) array to every process as numpy.

    Result collection only — the one DCN collective in the workflow.
    """
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
