"""Problem-definition layer: dynamics, costs, constraints (pure functions)."""

from trajectory_optimization_matrix_lie_groups.models.base import LieModel, make_model  # noqa: F401
from trajectory_optimization_matrix_lie_groups.models import (  # noqa: F401
    autodiff,
    constraints,
    costs,
    dynamics,
    errorstate,
)
