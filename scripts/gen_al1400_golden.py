"""Generate the f64 CPU golden for the N=1400 AL-constrained problem.

Solves `tasks/al_bench.build_al1400` (the reference's
main_SE3ddp_tracking_exact_al_ms.py workload) with the line-searched AL
engine at float64 and writes the converged controls + the solve metadata
to tasks/golden/al1400_us.npy — the lane-0 accuracy anchor of the N=1400
constrained problem.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.models import (
    constraints as cs,
    costs,
    dynamics,
)
from trajectory_optimization_matrix_lie_groups.models.base import make_model
from trajectory_optimization_matrix_lie_groups.ops.group import SE3
from trajectory_optimization_matrix_lie_groups.solvers.al_fast import (
    ALFastSolver,
)
from trajectory_optimization_matrix_lie_groups.solvers.batched import (
    FastBatchSolver,
)
from trajectory_optimization_matrix_lie_groups.tasks.al_bench import (
    build_al1400,
)

H = int(os.environ.get("H", "1400"))
params, lb, ub, q0, xi0, q_ref, xi_ref = build_al1400(jnp.float64, H)

dyn_def = dynamics.se3_dynamics()
cost_def = costs.tracking_cost(SE3, 6)
constr = cs.input_box(12, 6)
constr_p = cs.input_box_params(lb, ub, 6)
al_cd = costs.al_cost(cost_def, constr)
model, _ = make_model(dyn_def, al_cd, params["dyn"], None)
alp = costs.al_init_params(params["cost"], constr_p, H, constr.constr_size,
                           mu0=1e-2, dtype=jnp.float64)  # reference-hardcoded mu0 (traopt_controller.py:3182)

# Fixed-budget (alpha = 1) inner: on this problem the merit line search
# stalls (60 LS iterations end at J ~ 8.5e5 vs the fixed-budget inner's
# clean convergence to grad ~ 1e-16 in <= 16 iterations — the
# unconstrained optimum needs |u| ~ 104, so the box MUST bind and the AL
# outers do the work).
inner = FastBatchSolver(model, N=H, iterations=40)
al = ALFastSolver(inner, constr)

res = al.solve({"dyn": params["dyn"], "cost": alp},
               q0[None], xi0[None], jnp.zeros((1, H, 6), jnp.float64),
               q_ref=q_ref, xi_ref=xi_ref, n_al_iters=20)
us = np.asarray(res.us[0], np.float64)
meta = dict(H=H, J=float(res.J_opt[0]),
            max_violation=float(res.max_violation[0]),
            outer_iterations=int(res.outer_iterations),
            converged=bool(res.constr_converged),
            us_min=float(us.min()), us_max=float(us.max()),
            n_active=int((np.abs(np.abs(us) - 10.0) < 1e-6).sum()))
print(json.dumps(meta))
assert meta["converged"], meta
gd = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                  "trajectory_optimization_matrix_lie_groups", "tasks",
                  "golden")
np.save(os.path.join(gd, f"al{H}_us.npy"), us)
with open(os.path.join(gd, f"al{H}_meta.json"), "w") as f:
    json.dump(meta, f)
print("written", os.path.join(gd, f"al{H}_us.npy"))
