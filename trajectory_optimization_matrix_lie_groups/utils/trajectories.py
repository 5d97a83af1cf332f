"""Reference-trajectory and benchmark-artifact IO.

Keeps the reference's on-disk formats for comparability:

- `.npy` triples ``(q_ref, xi_ref, dt)`` written back-to-back into one file
  (format defined by `visualization/convert_path_to_reference.ipynb`, read
  as in `benchmark_SE3_tracking.py:164-168`);
- benchmark result pickles with a `prob` dict carrying the full problem spec
  (J, dt, q_ref, xi_ref, x0, Q, P, R) plus per-solver solutions/histories
  (writer: `benchmark_SE3_tracking.py:272-345`).
"""

import pickle

import numpy as np


def load_reference_triple(path):
    """Load (q_ref, xi_ref, dt) from a reference .npy file."""
    with open(path, "rb") as f:
        q_ref = np.load(f)
        xi_ref = np.load(f)
        dt = np.load(f)
    return q_ref, xi_ref, float(dt)


def save_reference_triple(path, q_ref, xi_ref, dt):
    with open(path, "wb") as f:
        np.save(f, np.asarray(q_ref))
        np.save(f, np.asarray(xi_ref))
        np.save(f, np.asarray(dt))


def load_benchmark_pickle(path):
    """Load a reference benchmark results pickle (problem spec + solutions)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_benchmark_pickle(path, prob, solvers):
    """Write a benchmark results pickle in the REFERENCE's schema
    (`benchmark_SE3_tracking.py:272-345`): a dict with a 'prob' entry
    (problem spec: J, dt, q_ref, xi_ref, x0, Q, P, R) and one entry per
    solver holding (xs, us, J_hist, grad_hist[, defect_hist]) — so future
    runs (of this framework or the reference's own `load_results_pickle`)
    can cross-compare against today's solutions.

    ``prob``: mapping with the spec keys (arrays converted to numpy).
    ``solvers``: {name: {xs|qs/xis, us, J_hist, grad_hist, defect_hist?}}.
    The Lie solvers' state is stored as {'qs': (N+1,m,m), 'xis': (N+1,d)}
    under 'xs' (the reference stores per-stage [q, xi] object pairs;
    the array pair carries the same information losslessly).
    """
    def conv(v):
        if hasattr(v, "shape"):
            return np.asarray(v)
        if isinstance(v, (list, tuple)):
            return type(v)(conv(e) for e in v)
        if isinstance(v, dict):
            return {k: conv(e) for k, e in v.items()}
        return v

    data = {"prob": {k: conv(v) for k, v in prob.items()}}
    for name, rec in solvers.items():
        data[name] = {k: conv(v) for k, v in rec.items()}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def generate_reference(q0, xi_of_i, N, dt):
    """Generate a reference trajectory by twist integration.

    The reference creates its `.npy` paths by integrating a (possibly
    time-varying) twist (`convert_path_to_reference.ipynb`;
    `perturb_all_compute.py:135-154`): q_{i+1} = q_i Exp(xi_i dt).

    Args:
      q0: (4, 4) or (3, 3) initial pose.
      xi_of_i: callable i -> twist, or a constant twist array.
      N: number of steps (returns N+1 poses).
      dt: step.

    Returns (q_ref (N+1, m, m), xi_ref (N+1, d)).
    """
    import jax.numpy as jnp

    from trajectory_optimization_matrix_lie_groups.ops import se3, so3

    q0 = jnp.asarray(q0)
    group = se3 if q0.shape[-1] == 4 else so3
    xis = [jnp.asarray(xi_of_i(i) if callable(xi_of_i) else xi_of_i)
           for i in range(N + 1)]
    qs = [q0]
    for i in range(N):
        qs.append(group.normalize(qs[-1] @ group.exp(xis[i] * dt)))
    return np.asarray(jnp.stack(qs)), np.asarray(jnp.stack(xis))
