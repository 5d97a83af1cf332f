#!/usr/bin/env python
"""Headline benchmark: SE(3) tracking MPC solves/s on one NVIDIA GPU.

Workload: multiple-shooting SE(3) tracking iLQR at an N=200 horizon
(`tasks/se3_bench.py`: the reference's MS tracking weights and step, a
seeded in-repo reference path), solved for a batch of perturbed initial
conditions — the reference's `perturb_all_compute.py` sweep workload — as
one jitted f32 program, fixed 12-iteration budget.

Accuracy anchor: lane 0 solves the canonical unperturbed problem and is
compared against the committed f64 golden control sequence
(`tasks/golden/bench_se3_n200_us.npy`, made by
scripts/gen_bench_golden.py with the CPU f64 reference-exact engine).

Baseline (`vs_baseline`): the serial-numpy mirror of the reference's
execution model (`baselines/numpy_serial.py`, per-stage Python loops over
small numpy ops), timed on the same problem and iteration budget on the
host CPU.

Sections: the f32 pipeline (B=32768); the <=1e-4 control-fidelity gate
(BASELINE.md) through the mixed double-f32 polish (f32x7 + df2, B=16384);
the input-box constrained AL pipeline (B=4096, cold and warm-started).
Each emits the cumulative record as one flushed JSON line; every record
names the device and the card's power limit.  A failing section fails the
run.  Without a GPU the run fails at once.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

import jax

from trajectory_optimization_matrix_lie_groups.utils.platform import (
    setup_compile_cache,
)

setup_compile_cache()

import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_matrix_lie_groups.baselines.numpy_serial import (  # noqa: E402
    SerialSE3MSiLQR,
)
from trajectory_optimization_matrix_lie_groups.ops.group import SE3  # noqa: E402
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (  # noqa: E402
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups.tasks import se3_bench  # noqa: E402

HORIZON = se3_bench.HORIZON
ITERS = 12
BATCH = 32768
BATCH_GATE = 16384
BATCH_AL = 4096
REPS = 3
DTYPE = jnp.float32

build_problem = se3_bench.build_problem
build_problem_np64 = se3_bench.build_problem_np64


def _device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: no GPU (platform {dev.platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return dict(platform=dev.platform, device_kind=dev.device_kind,
                device_count=len(jax.devices()), card=card)


def _emit(record):
    print(json.dumps(record), flush=True)


def _perturbed(q0, B, seed):
    """B initial poses around q0; lane 0 is q0 itself (the golden)."""
    dq = 0.05 * jax.random.normal(jax.random.PRNGKey(seed), (B, 6), DTYPE)
    return SE3.normalize(q0[None] @ SE3.exp(dq)).at[0].set(q0)


def _time(fn, batches):
    """Warm-up on batches[0], then one timed run per remaining batch;
    every run ends in `block_until_ready`."""
    out = jax.block_until_ready(fn(batches[0]))
    times = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(b))
        times.append(time.perf_counter() - t0)
    return out, times


def main():
    t_start = time.perf_counter()
    device = _device()
    _, params, q0, xi0, _, _ = build_problem(DTYPE)
    dp, cp = params["dyn"], params["cost"]
    N = HORIZON
    _, _, us_golden = se3_bench.load_golden()

    # reference-execution-model baseline (serial numpy, host CPU)
    prob = se3_bench.problem_np64()
    ser = SerialSE3MSiLQR(prob["J"], prob["dt"], prob["Q"], prob["R"],
                          prob["P"], prob["q_ref"], prob["xi_ref"])
    t0 = time.perf_counter()
    ser.fit(prob["q0"], prob["xi0"], np.zeros((N, 6)), n_iterations=2)
    ref_solves_per_s = 1.0 / ((time.perf_counter() - t0) / 2 * ITERS)

    # f32 pipeline
    solver = PipelineSolver(N=N, iterations=ITERS, dt=se3_bench.DT)
    xi0s = jnp.broadcast_to(xi0, (BATCH, 6))
    us0 = jnp.zeros((BATCH, N, 6), DTYPE)
    batches = [_perturbed(q0, BATCH, s) for s in range(REPS + 1)]
    out, times = _time(lambda b: solver.solve(dp, cp, b, xi0s, us0), batches)
    dt = min(times)
    gn = np.asarray(out.grad_norm, np.float64)
    record = {
        "metric": ("SE3 tracking MS-iLQR MPC solves/s (N=200, 12 iters, "
                   f"batch={BATCH}, f32 pipeline, generated CUDA kernels)"),
        "value": round(BATCH / dt, 1),
        "unit": "solves/s",
        "vs_baseline": round(BATCH / dt / ref_solves_per_s, 2),
        "rep_solve_s": times,
        "baseline_serial_cpu_solves_per_s": round(ref_solves_per_s, 4),
        "f32_vs_f64_golden_us_max_err": float(np.max(np.abs(
            np.asarray(out.us[0], np.float64) - us_golden))),
        "grad_norm_p50": float(np.percentile(gn, 50)),
        "grad_norm_p95": float(np.percentile(gn, 95)),
        "grad_norm_max": float(gn.max()),
        **device,
    }
    _emit(record)

    # the <=1e-4 gate: f32 pipeline + mixed-precision double-f32 polish
    from trajectory_optimization_matrix_lie_groups.solvers.df_mixed import (
        MixedDFPipelineSolver,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.df_pipeline import (
        join_us,
    )

    params64 = build_problem_np64(N)
    mx = MixedDFPipelineSolver(N=N, dt=se3_bench.DT, f32_iterations=7,
                               df_iterations=2)
    xi0h = jnp.broadcast_to(xi0, (BATCH_GATE, 6))
    us0h = jnp.zeros((BATCH_GATE, N, 6), DTYPE)
    hb = [_perturbed(q0, BATCH_GATE, 10 + s) for s in range(REPS + 1)]
    out_h, times_h = _time(lambda b: mx.solve(params64, b, xi0h, us0h), hb)
    gn = np.asarray(out_h.grad_norm, np.float64)
    record.update({
        "highprec_us_max_err": float(np.max(np.abs(
            join_us(out_h)[0] - us_golden))),
        "highprec_solves_per_s": round(BATCH_GATE / min(times_h), 1),
        "highprec_rep_solve_s": times_h,
        "highprec_mode": "MixedDFPipelineSolver(f32x7+df2)",
        "highprec_grad_norm_p50": float(np.percentile(gn, 50)),
        "highprec_grad_norm_p95": float(np.percentile(gn, 95)),
        "highprec_grad_norm_max": float(gn.max()),
    })
    _emit(record)

    # constrained (augmented-Lagrangian) throughput: the ALPipelineSolver
    # outer loop around the same pipeline
    from trajectory_optimization_matrix_lie_groups.solvers.al_pipeline import (
        ALPipelineSolver,
    )

    lb, ub = se3_bench.al_box()
    al = ALPipelineSolver(solver, lb=lb, ub=ub)
    xi0a = jnp.broadcast_to(xi0, (BATCH_AL, 6))
    us0a = jnp.zeros((BATCH_AL, N, 6), DTYPE)
    ab = [_perturbed(q0, BATCH_AL, 20 + s) for s in range(REPS + 1)]
    for warm in (False, True):
        res, times_a = _time(
            lambda b: al.solve(dp, cp, b, xi0a, us0a, n_al_iters=14,
                               warm_start=warm), ab)
        key = "al_warm" if warm else "al"
        record[f"{key}_solves_per_s"] = round(BATCH_AL / min(times_a), 1)
        record.update({f"{key}_{k}": v for k, v in
                       se3_bench.al_summary(res, lb, ub).items()})
    record["bench_wall_s"] = round(time.perf_counter() - t_start, 1)
    _emit(record)


if __name__ == "__main__":
    main()
