"""Benchmark metrics mirroring the reference's correctness oracles.

- manifold-constraint violation ||R^T R - I|| per stage
  (`benchmark_SE3_tracking.py:414-418`)
- dynamics violation via one-step re-simulation (`err_dyn`, `:95-103,453-457`)
- tracking error via the cost's `_err` (`:832-848`)
- quaternion norm violation (the embedded baselines' drift)
"""

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models.costs import tracking_error


def orthogonality_violation(qs):
    """||R^T R - I||_F per stage for (N+1, m, m) group matrices."""
    R = qs[..., :3, :3]
    eye = jnp.eye(3, dtype=qs.dtype)
    return jnp.linalg.norm(
        jnp.swapaxes(R, -1, -2) @ R - eye, axis=(-2, -1))


def dynamics_violation(model, params, qs, xis, us):
    """||f(x_k, u_k) (-) x_{k+1}|| per stage (one-step re-simulation)."""
    idx = jnp.arange(us.shape[0])
    fq, fxi = model.step(params, qs[:-1], xis[:-1], us, idx)
    d_q = model.group.rminus(fq, qs[1:])
    d_xi = fxi - xis[1:]
    return jnp.linalg.norm(jnp.concatenate([d_q, d_xi], axis=-1), axis=-1)


def tracking_errors(group, cost_params, qs, xis):
    """(pose-error norm, velocity-error norm) per stage vs the reference."""
    idx = jnp.arange(qs.shape[0])
    e, ev = tracking_error(group, cost_params, qs, xis, idx)
    return jnp.linalg.norm(e, axis=-1), jnp.linalg.norm(ev, axis=-1)


def quat_norm_violation(xs_embedded):
    """|1 - ||q||| per stage for embedded R^13 states (..., 13)."""
    return jnp.abs(1.0 - jnp.linalg.norm(xs_embedded[..., :4], axis=-1))
