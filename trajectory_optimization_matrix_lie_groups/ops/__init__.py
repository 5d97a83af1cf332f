"""Lie-group kernel suite (first-party replacement for manif/manifpy)."""

from trajectory_optimization_matrix_lie_groups.ops import se3, so3  # noqa: F401
from trajectory_optimization_matrix_lie_groups.ops.group import SE3, SO3, Group  # noqa: F401
