"""Initial-condition perturbation sweeps as one sharded SPMD program.

Replaces `visualization/perturb_all_compute.py`: the reference fans out one
OS process per (parameter, value) pair with `joblib.Parallel`
(`perturb_all_compute.py:245`), each running a full serial SE(3) iLQR solve.
Here the entire sweep — 12 parameters x O(100) values, each a full solve —
is a single vmapped, mesh-sharded computation: the only cross-device traffic
is the result gather.

Parameter semantics mirror the reference (`perturb_all_compute.py:44-110`):
each sweep point perturbs exactly one component of the initial state —
Euler angles of the initial attitude (th_z/th_y/th_x, degrees), angular
velocity (w_*), position (p_*), or linear velocity (v_*).
"""

from typing import Dict, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops import se3, so3
from trajectory_optimization_matrix_lie_groups.parallel.batch import BatchSolver

PARAM_NAMES = ("th_z", "th_y", "th_x", "w_x", "w_y", "w_z",
               "p_x", "p_y", "p_z", "v_x", "v_y", "v_z")


class SweepResult(NamedTuple):
    param: str
    values: np.ndarray
    J_opt: np.ndarray       # (n_values,)
    grad_norm: np.ndarray
    converged: np.ndarray
    us: np.ndarray          # (n_values, N, nu)


def _euler_zyx_matrix(th_z, th_y, th_x):
    """Intrinsic z-y-x Euler rotation (degrees), batched."""
    rz = jnp.deg2rad(th_z)
    ry = jnp.deg2rad(th_y)
    rx = jnp.deg2rad(th_x)
    Rz = so3.exp(jnp.stack([jnp.zeros_like(rz), jnp.zeros_like(rz), rz], axis=-1))
    Ry = so3.exp(jnp.stack([jnp.zeros_like(ry), ry, jnp.zeros_like(ry)], axis=-1))
    Rx = so3.exp(jnp.stack([rx, jnp.zeros_like(rx), jnp.zeros_like(rx)], axis=-1))
    return Rz @ Ry @ Rx


def build_x0_batch(param: str, values, base_q0, base_xi0):
    """Batch of initial states perturbing one parameter (others at base)."""
    values = jnp.asarray(values)
    B = values.shape[0]
    q0 = jnp.broadcast_to(jnp.asarray(base_q0), (B, 4, 4))
    xi0 = jnp.broadcast_to(jnp.asarray(base_xi0), (B, 6))
    if param.startswith("th_"):
        zeros = jnp.zeros_like(values)
        ang = {a: zeros for a in ("th_z", "th_y", "th_x")}
        ang[param] = values
        R = _euler_zyx_matrix(ang["th_z"], ang["th_y"], ang["th_x"])
        q0 = jax.vmap(se3.from_rotation_translation)(R, se3.translation(q0))
    else:
        idx = {"w_x": 0, "w_y": 1, "w_z": 2, "v_x": 3, "v_y": 4, "v_z": 5}
        if param in ("w_x", "w_y", "w_z", "v_x", "v_y", "v_z"):
            xi0 = xi0.at[:, idx[param]].set(values)
        elif param in ("p_x", "p_y", "p_z"):
            j = {"p_x": 0, "p_y": 1, "p_z": 2}[param]
            p = se3.translation(q0).at[:, j].set(values)
            q0 = jax.vmap(se3.from_rotation_translation)(se3.rotation(q0), p)
        else:
            raise ValueError(param)
    return q0, xi0


def run_sweep(batch_solver: BatchSolver, params, parameter_ranges: Dict,
              base_q0, base_xi0, nu=6):
    """Run all parameter sweeps; each range is one sharded batch solve."""
    N = batch_solver.solver.cfg.N
    out = {}
    for name, values in parameter_ranges.items():
        q0s, xi0s = build_x0_batch(name, values, base_q0, base_xi0)
        us0 = jnp.zeros((q0s.shape[0], N, nu), dtype=xi0s.dtype)
        st = batch_solver.solve_batch(params, q0s, xi0s, us0)
        out[name] = SweepResult(
            param=name, values=np.asarray(values),
            J_opt=np.asarray(st.J_opt), grad_norm=np.asarray(st.grad_norm),
            converged=np.asarray(st.converged), us=np.asarray(st.us),
        )
    return out


class RolloutSweepResult(NamedTuple):
    param: str
    values: np.ndarray
    qs: np.ndarray   # (n_values, N+1, 4, 4) open-loop poses
    xis: np.ndarray  # (n_values, N+1, 6)


def run_rollout_sweep(dyn, dp, parameter_ranges: Dict, base_q0, base_xi0,
                      N: int, nu: int = 6, mesh=None):
    """Open-loop rollout sweeps (ref `visualization/rollout_all_compute.py`):
    each sweep point rolls the dynamics N steps with zero controls from its
    perturbed initial state.  The reference forks one joblib process per
    point (`rollout_all_compute.py:224`, serial Python time loops inside);
    here each parameter's whole batch is one jitted `lax.scan` with a
    batched carry (the model step functions broadcast over the batch dim),
    optionally sharded over a device mesh.
    """
    import functools

    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec

    @functools.partial(jax.jit, static_argnums=(3,))
    def rollout(q0s, xi0s, dp_, N_):
        zeros_u = jnp.zeros((q0s.shape[0], nu), xi0s.dtype)

        def step(carry, i):
            q, xi = carry
            qn, xin = dyn.step(dp_, q, xi, zeros_u, i)
            return (qn, xin), (qn, xin)

        (_, _), (qs_t, xis_t) = lax.scan(step, (q0s, xi0s), jnp.arange(N_))
        qs = jnp.concatenate([q0s[:, None], jnp.swapaxes(qs_t, 0, 1)], axis=1)
        xis = jnp.concatenate([xi0s[:, None], jnp.swapaxes(xis_t, 0, 1)],
                              axis=1)
        return qs, xis

    out = {}
    for name, values in parameter_ranges.items():
        q0s, xi0s = build_x0_batch(name, values, base_q0, base_xi0)
        if mesh is not None:
            shard = NamedSharding(mesh, PartitionSpec("batch"))
            q0s = jax.device_put(q0s, shard)
            xi0s = jax.device_put(xi0s, shard)
        qs, xis = rollout(q0s, xi0s, dp, N)
        out[name] = RolloutSweepResult(
            param=name, values=np.asarray(values),
            qs=np.asarray(qs), xis=np.asarray(xis),
        )
    return out
