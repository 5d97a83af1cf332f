"""High-precision MPC solves: f32 pipeline + native f64 polish iterations.

The f32 pipeline converges to a ~1e-3 neighbourhood of the f64 fixed point:
f32 rounding noise (relative ~6e-8) is injected at every stage and amplified
~5e4x through the near-flat directions of the trajectory Hessian
(sigma_min(Quu) ~ 2R = 2e-5 while cost curvature terms are O(1)).
Running any single stage in
higher precision does not help — but iLQR is locally contractive, so a short
*polish* phase rerun entirely in f64 from the f32-converged iterate
re-converges into the flat valley of the true optimum:

    12 f32 iters                       max|us - golden| ~ 4e-4
    12 f32 iters + 2 f64 polish iters  max|us - golden| ~ 3e-6  (< 1e-4 gate)
    (the bench problem, tasks/se3_bench.py; chip_smoke.py checks both on
     the GPU)

The polish phase runs in native float64 through the FastBatchSolver XLA
path (a plain jitted scan program).  Cost: the polish adds `polish_iters`
f64 iterations on top of `iterations` f32 pipeline iterations.
`solvers/df_mixed.MixedDFPipelineSolver` reaches the same gate with
double-f32 arithmetic instead; which of the two is faster on the GPU is
an open measurement (ROADMAP 1.5).

Reference context: the reference solver stack is float64 end-to-end
(`main_SE3ddp_tracking_exact_ms.py:36` enables x64; SURVEY.md §7 hard
part 5).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from trajectory_optimization_matrix_lie_groups.models.base import LieModel
from trajectory_optimization_matrix_lie_groups.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (
    PipelineSolver,
)


class PolishedState(NamedTuple):
    qs: jnp.ndarray       # (B, N+1, 4, 4) float64
    xis: jnp.ndarray      # (B, N+1, 6)    float64
    us: jnp.ndarray       # (B, N, nu)     float64
    J_opt: jnp.ndarray    # (B,)
    grad_norm: jnp.ndarray  # (B,)


def _to_dtype(tree, dtype):
    return jax.tree.map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
        tree)


class HighPrecisionSolver:
    """`precision='high'` pipeline: f32 kernels + f64 polish.

    Parameters
    ----------
    model : LieModel
        The (dynamics, cost) model pair; used by the f64 polish phase
        (the generic XLA path — works for every dynamics family the
        pipeline kernels support, se3 free body / rigid body / drone).
    N, iterations, dt :
        Forwarded to `PipelineSolver` (the f32 phase).
    polish_iters : int
        Number of f64 MS-iLQR iterations warm-started from the f32 result.
        2 is the knee of the accuracy curve (probe above); more buys
        nothing because the remaining error is flat-direction indeterminacy.
    **pipeline_kwargs :
        Extra `PipelineSolver` options (gravity, kernels, tile, ...).
    """

    def __init__(self, model: LieModel, N: int, iterations: int, dt: float,
                 polish_iters: int = 2, **pipeline_kwargs):
        if not jax.config.jax_enable_x64:
            raise RuntimeError(
                "HighPrecisionSolver needs x64: call "
                "jax.config.update('jax_enable_x64', True) first")
        self.pipeline = PipelineSolver(N=N, iterations=iterations,
                                             dt=dt, **pipeline_kwargs)
        self.fast = FastBatchSolver(model, N=N, iterations=polish_iters)
        self.polish_iters = polish_iters
        self._polish_jit = jax.jit(self._polish)

    def _polish(self, params64, qs, xis, us):
        def body(_, carry):
            qs, xis, us, J, g = carry
            return self.fast._iteration(params64, qs, xis, us)

        B = us.shape[0]
        init = (qs, xis, us, jnp.full((B,), jnp.inf, jnp.float64),
                jnp.full((B,), jnp.inf, jnp.float64))
        qs, xis, us, J, g = lax.fori_loop(0, self.polish_iters, body, init)
        return PolishedState(qs=qs, xis=xis, us=us, J_opt=J, grad_norm=g)

    def solve(self, params, q0s, xi0s, us0):
        """params: {'dyn': ..., 'cost': ...} in any float dtype."""
        p32 = _to_dtype(params, jnp.float32)
        # Trace the f32 phase with x64 OFF, so its index arithmetic stays
        # int32 like the rest of the phase.  The flag is part of jit's
        # cache key, so toggling it per-call is cheap after the first
        # trace.
        jax.config.update("jax_enable_x64", False)
        try:
            out = self.pipeline.solve(
                p32["dyn"], p32["cost"],
                jnp.asarray(q0s, jnp.float32), jnp.asarray(xi0s, jnp.float32),
                jnp.asarray(us0, jnp.float32))
        finally:
            jax.config.update("jax_enable_x64", True)
        p64 = _to_dtype(params, jnp.float64)
        return self._polish_jit(p64, out.qs.astype(jnp.float64),
                                out.xis.astype(jnp.float64),
                                out.us.astype(jnp.float64))
