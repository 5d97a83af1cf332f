"""Trajectory-optimization solvers (scan/vmap-structured, jit-compiled)."""

from trajectory_optimization_matrix_lie_groups.solvers.lie_ilqr import (  # noqa: F401
    LieILQR,
    SolverConfig,
    SolverState,
)

from trajectory_optimization_matrix_lie_groups.solvers.al_ilqr import ALILQR  # noqa: F401
from trajectory_optimization_matrix_lie_groups.solvers.al_pipeline import (  # noqa: F401
    ALPipelineSolver,
    al_polish,
)
from trajectory_optimization_matrix_lie_groups.solvers.df_mixed import MixedDFPipelineSolver  # noqa: F401
from trajectory_optimization_matrix_lie_groups.solvers.df_pipeline import DFPipelineSolver  # noqa: F401
from trajectory_optimization_matrix_lie_groups.solvers.batched import FastBatchSolver  # noqa: F401
from trajectory_optimization_matrix_lie_groups.solvers.ilqr import ILQR, ILQRConfig  # noqa: F401
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import PipelineSolver  # noqa: F401
from trajectory_optimization_matrix_lie_groups.solvers.polish import HighPrecisionSolver  # noqa: F401
