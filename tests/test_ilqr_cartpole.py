"""Euclidean iLQR/DDP tests: analytic LQR agreement + cartpole swing-up."""

import jax.numpy as jnp
import numpy as np

from trajectory_optimization_matrix_lie_groups.models.autodiff import autodiff_model
from trajectory_optimization_matrix_lie_groups.solvers.ilqr import ILQR, ILQRConfig
from trajectory_optimization_matrix_lie_groups.tasks import cartpole


def test_lqr_matches_riccati():
    """On an LTI-quadratic problem, one iLQR backward pass must reproduce the
    finite-horizon discrete Riccati solution."""
    N = 30
    A = jnp.array([[1.0, 0.1], [0.0, 1.0]])
    B = jnp.array([[0.0], [0.1]])
    Q = jnp.diag(jnp.array([1.0, 0.1]))
    Rm = jnp.array([[0.01]])

    def f(x, u, i):
        return A @ x + B @ u

    def l(x, u, i):
        return 0.5 * (x @ Q @ x + u @ Rm @ u)

    def lN(x, i):
        return 0.5 * x @ Q @ x

    model = autodiff_model(f, l, lN, 2, 1)
    cfg = ILQRConfig(N=N, mu_init=0.0, tol_grad_norm=1e-10, max_iterations=3)
    solver = ILQR(model, cfg)
    x0 = jnp.array([1.0, -0.5])
    xs, us, J_hist, grad_hist, state = solver.fit(x0, jnp.zeros((N, 1)))

    # dense Riccati recursion ground truth
    P = np.asarray(Q)
    Ks = []
    for _ in range(N):
        An, Bn, Qn, Rn = map(np.asarray, (A, B, Q, Rm))
        K = np.linalg.solve(Rn + Bn.T @ P @ Bn, Bn.T @ P @ An)
        P = Qn + An.T @ P @ An - An.T @ P @ Bn @ K
        Ks.append(K)
    Ks = Ks[::-1]
    x = np.asarray(x0)
    us_ref = []
    for i in range(N):
        u = -Ks[i] @ x
        us_ref.append(u)
        x = np.asarray(A) @ x + np.asarray(B) @ u
    np.testing.assert_allclose(np.asarray(us).squeeze(-1),
                               np.asarray(us_ref).squeeze(-1), atol=1e-6)


def test_cartpole_stabilization_converges():
    """Pole starting near upright: iLQR must descend and stabilize."""
    solver = cartpole.build(N=200)
    x0 = jnp.array([9.5, 0.0, 2.8, 0.0])
    xs, us, J_hist, grad_hist, state = solver.fit(
        x0, jnp.zeros((200, 1)), n_iterations=60)
    assert J_hist[-1] < J_hist[0]
    assert abs(float(xs[-1, 2]) - np.pi) < 0.2


import pytest


@pytest.mark.parity
def test_cartpole_swingup_full():
    """Full reference config (main_ddp.py: N=400, x0=[9,0,0,0]): the solver
    must swing the pole up to pi within the 200-iteration budget."""
    xs, us, J_hist, grad_hist, state = cartpole.run(n_iterations=200)
    assert abs(float(xs[-1, 2]) - np.pi) < 0.2
    assert J_hist[-1] < 0.5 * J_hist[0]


def test_cartpole_ddp_hessians_run():
    solver = cartpole.build(N=60, hessians=True)
    x0 = jnp.array([9.5, 0.0, 2.5, 0.0])
    xs, us, J_hist, grad_hist, state = solver.fit(
        x0, jnp.zeros((60, 1)), n_iterations=25)
    assert np.isfinite(J_hist[-1])
    assert J_hist[-1] <= J_hist[0]
