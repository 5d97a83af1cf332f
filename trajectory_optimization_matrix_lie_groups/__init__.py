"""Batched trajectory optimization on matrix Lie groups.

A ground-up JAX/XLA re-design of the capabilities of
``chenghuailin/trajectory_optimization_matrix_lie_groups``: iLQR/DDP trajectory
optimization directly on SO(3)/SE(3), with

- a first-party batched Lie-group kernel suite (``ops``) replacing the C++
  `manif` bindings the reference leans on,
- pure-functional dynamics/cost/constraint models (``models``),
- scan/vmap-structured single- and multiple-shooting iLQR solvers with
  augmented-Lagrangian constraint handling (``solvers``),
- device-mesh batch solving and sweeps (``parallel``),
- task/benchmark entry points mirroring the reference's main scripts
  (``tasks``).

Twist convention: tangent vectors are ordered ``[omega, v]`` (angular first),
matching the reference library convention (reference ``traoptlibrary/
traopt_utilis.py:43-92``). All kernels are shape-polymorphic over leading batch
dimensions and dtype-polymorphic (f32/f64 follows the inputs).
"""

__version__ = "0.1.0"

import jax as _jax

# iLQR on 6-12 dim systems is small dense linear algebra whose Riccati
# recursion is ill-conditioned (sigma_min(Quu) ~ 2R = 2e-5): reduced-
# precision matmul passes — TF32 on the GPU, which keeps about three
# decimal digits — destroy it.  Full f32 precision costs nothing at these
# sizes.
_jax.config.update("jax_default_matmul_precision", "highest")

from trajectory_optimization_matrix_lie_groups import ops  # noqa: F401
