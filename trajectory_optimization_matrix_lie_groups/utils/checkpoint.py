"""Solver-state checkpoint/resume (orbax-backed).

The reference persists only *results* (benchmark pickles, sweep pickles,
`.npy` trajectories — SURVEY §5.4); `fit` is resumable only through object
attributes.  Long-running batched MPC streams and sweeps here are pure
pytree programs, so checkpointing is generic: any solver state (`ESState`,
`FastBatchState`, `PipelineState`, AL params, warm-start controls) is a
pytree of arrays and round-trips through one orbax call.

    from trajectory_optimization_matrix_lie_groups.utils import checkpoint
    checkpoint.save(path, {"us": us, "al": al_params, "step": k})
    state = checkpoint.restore(path, template)   # template = like-shaped pytree
"""

import os

import jax
import numpy as np


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.PyTreeCheckpointer()


def save(path: str, state) -> str:
    """Write a pytree checkpoint (atomic directory) at ``path``.

    Device arrays are fetched to host first; sharded arrays must be
    addressable (gather with `parallel.gather_to_all` before saving on
    multi-host).
    """
    path = os.path.abspath(path)
    state = jax.tree.map(
        lambda x: np.asarray(x) if hasattr(x, "dtype") else x, state)
    _checkpointer().save(path, state, force=True)
    return path


def restore(path: str, template=None):
    """Load a checkpoint; ``template`` (a like-structured pytree) restores
    NamedTuple/custom-node structure instead of raw nested dicts."""
    path = os.path.abspath(path)
    if template is None:
        return _checkpointer().restore(path)
    template = jax.tree.map(
        lambda x: np.asarray(x) if hasattr(x, "dtype") else x, template)
    return _checkpointer().restore(path, item=template)
