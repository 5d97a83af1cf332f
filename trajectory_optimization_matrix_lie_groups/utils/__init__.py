"""Shared utilities: artifact IO, configs, metrics."""

from trajectory_optimization_matrix_lie_groups.utils.trajectories import (  # noqa: F401
    load_benchmark_pickle,
    load_reference_triple,
    save_benchmark_pickle,
)
