"""Cartpole swing-up with autodiff dynamics/cost + Euclidean iLQR/DDP.

Replicates the reference task `main_ddp.py`: RK4-discretized underactuated
cartpole (`main_ddp.py:37-66`), quadratic goal cost (`:71-86`), N=400,
dt=0.01, x0=[9,0,0,0], goal=[10,0,pi,0] (`:104-117`).
"""

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models.autodiff import (
    autodiff_model,
    rk4,
)
from trajectory_optimization_matrix_lie_groups.solvers.ilqr import ILQR, ILQRConfig


def cartpole_fc(x, u):
    mc, mp, l, g = 1.0, 1.0, 1.0, 9.8
    x1, x2, x3, x4 = x[0], x[1], x[2], x[3]
    uu = u[0]
    s, c = jnp.sin(x3), jnp.cos(x3)
    dx2 = (uu + mp * s * (l * x4**2 + g * c)) / (mc + mp * s**2)
    dx4 = (-uu * c - mp * l * x4**2 * c * s - (mc + mp) * g * s) / (
        l * mc + l * mp * s**2
    )
    return jnp.stack([x2, dx2, x4, dx4])


def build(N=400, dt=0.01, x_goal=None, hessians=False):
    if x_goal is None:
        x_goal = jnp.array([10.0, 0.0, jnp.pi, 0.0])
    Q = jnp.diag(jnp.array([100.0, 100.0, 10000.0, 100.0]))
    R = 200.0

    def l(x, u, i):
        xd = x - x_goal
        return 0.5 * u[0] * R * u[0] + 0.5 * xd @ Q @ xd

    def l_terminal(x, i):
        xd = x - x_goal
        return 0.5 * xd @ Q @ xd

    model = autodiff_model(rk4(cartpole_fc, dt), l, l_terminal, 4, 1,
                           hessians=hessians)
    cfg = ILQRConfig(N=N, use_hessians=hessians, tol_grad_norm=1e-3,
                     max_iterations=200)
    return ILQR(model, cfg)


def run(n_iterations=200):
    solver = build()
    x0 = jnp.array([9.0, 0.0, 0.0, 0.0])
    us0 = jnp.zeros((solver.cfg.N, 1))
    return solver.fit(x0, us0, n_iterations=n_iterations)
