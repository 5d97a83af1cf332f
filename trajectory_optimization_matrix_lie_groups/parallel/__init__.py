"""Device-mesh batch solving (the framework's primary scaling axis)."""

from trajectory_optimization_matrix_lie_groups.parallel.batch import (  # noqa: F401
    BatchSolver,
    make_batch_mesh,
)
from trajectory_optimization_matrix_lie_groups.parallel.pipeline_sharded import (  # noqa: F401
    ShardedPipelineSolver,
    make_sharded_pipeline,
)
from trajectory_optimization_matrix_lie_groups.parallel.multihost import (  # noqa: F401
    distribute_batch,
    gather_to_all,
    global_batch_mesh,
    initialize_multihost,
)
