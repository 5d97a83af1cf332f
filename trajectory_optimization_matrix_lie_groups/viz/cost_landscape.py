"""SE(3) cost-landscape grids (the reference's `visual_cost_*` scripts).

`visualization/visual_cost_{2d,3d_fixed,3d_slider,3d_anime}.py` sweep the
initial attitude over a (theta_z, theta_y) grid and plot the tracking-cost
landscape.  Here the whole grid is one batched cost evaluation (every grid
point is a lane), and optionally a full batched SOLVE per grid point via
parallel.BatchSolver.
"""

import numpy as np

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops import se3, so3


def pose_error_grid(q_ref0, th_z_deg, th_y_deg, Q1, left=True):
    """Cost landscape ||Log(X Xref^-1)||^2_Q1 over an attitude grid.

    Args:
      q_ref0: (4, 4) reference pose the grid perturbs around.
      th_z_deg, th_y_deg: 1-D arrays of angles (degrees).
      Q1: (6, 6) pose-error weight.
      left: left-error Log(X Xref^-1) (reference default) vs right-error.

    Returns (Z, TH_Z, TH_Y) with Z[i, j] the cost at (th_z[i], th_y[j]).
    """
    tz = jnp.deg2rad(jnp.asarray(th_z_deg))
    ty = jnp.deg2rad(jnp.asarray(th_y_deg))
    TZ, TY = jnp.meshgrid(tz, ty, indexing="ij")
    z = jnp.zeros_like(TZ)
    w = jnp.stack([z, TY, TZ], axis=-1).reshape(-1, 3)  # rotate about y then z
    R = so3.exp(jnp.stack([z, z, TZ], axis=-1).reshape(-1, 3)) @ so3.exp(
        jnp.stack([z, TY, z], axis=-1).reshape(-1, 3))
    q0 = jnp.asarray(q_ref0)
    X = jnp.broadcast_to(q0, (R.shape[0], 4, 4))
    X = jax.vmap(se3.from_rotation_translation)(R @ se3.rotation(q0), se3.translation(X))
    if left:
        e = se3.log(X @ se3.inverse(q0))
    else:
        e = se3.log(se3.inverse(q0) @ X)
    J = jnp.einsum("ni,ij,nj->n", e, jnp.asarray(Q1), e)
    return (np.asarray(J).reshape(len(th_z_deg), len(th_y_deg)),
            np.asarray(TZ), np.asarray(TY))


def plot_landscape(Z, th_z_deg, th_y_deg, path, title="SE(3) cost landscape"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5.5, 4.4))
    im = ax.pcolormesh(th_y_deg, th_z_deg, Z, shading="auto")
    fig.colorbar(im, ax=ax, label="cost")
    ax.set_xlabel("theta_y [deg]")
    ax.set_ylabel("theta_z [deg]")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
