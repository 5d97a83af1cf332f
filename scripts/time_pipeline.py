"""Time the f32 pipeline solve with the generated CUDA kernels against the
same solve with the stage recursions as XLA scans, end to end, on one GPU.

    python scripts/time_pipeline.py [--batch 32768] [--reps 3]

Each configuration is compiled first (compile seconds printed), then the
timed reps run in turns (kernel, scan, scan, kernel, ...) on fresh input
batches, each rep ending in `block_until_ready`.  Prints one JSON line per
configuration with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

import jax

from trajectory_optimization_matrix_lie_groups.utils.platform import (
    setup_compile_cache,
)

setup_compile_cache()

import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_matrix_lie_groups.ops.group import SE3  # noqa: E402
from trajectory_optimization_matrix_lie_groups.solvers.pipeline import (  # noqa: E402
    PipelineSolver,
)
from trajectory_optimization_matrix_lie_groups.tasks import se3_bench  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-scan", action="store_true")
    ap.add_argument("--trace", default=None,
                    help="directory: trace one more rep of each "
                         "configuration and print device time per op")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("time_pipeline: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    N, B = se3_bench.HORIZON, args.batch
    _, params, q0, xi0, _, _ = se3_bench.build_problem(jnp.float32)
    dp, cp = params["dyn"], params["cost"]
    _, _, us_golden = se3_bench.load_golden()

    def inputs(seed):
        dq = 0.05 * jax.random.normal(jax.random.PRNGKey(seed), (B, 6))
        q0s = SE3.normalize(q0[None] @ SE3.exp(dq)).at[0].set(q0)
        return jax.block_until_ready(
            (q0s, jnp.broadcast_to(xi0, (B, 6)), jnp.zeros((B, N, 6))))

    configs = [dict(kernels=True)]
    if not args.no_scan:
        configs.append(dict(kernels=False))
    runs = []
    for cfg in configs:
        s = PipelineSolver(N, args.iters, se3_bench.DT, **cfg)
        x = inputs(0)
        t = time.perf_counter()
        fn = s._solve_jit.lower(dp, cp, *x).compile()
        t_c = time.perf_counter() - t
        out = jax.block_until_ready(fn(dp, cp, *x))
        err = float(np.max(np.abs(np.asarray(out.us[0], np.float64)
                                  - us_golden)))
        print(f"compiled {cfg} in {t_c:.1f} s, lane-0 error {err:.3e}",
              file=sys.stderr, flush=True)
        mem = jax.devices()[0].memory_stats() or {}
        runs.append(dict(cfg=cfg, fn=fn, compile_s=t_c, times=[],
                         lane0_err=err,
                         peak_gib=mem.get("peak_bytes_in_use", 0) / 2**30))
    order = list(range(len(runs)))
    for r in range(args.reps):
        for i in (order if r % 2 == 0 else order[::-1]):
            x = inputs(1 + r)
            t = time.perf_counter()
            jax.block_until_ready(runs[i]["fn"](dp, cp, *x))
            runs[i]["times"].append(time.perf_counter() - t)
    for run in runs:
        if args.trace:
            from trajectory_optimization_matrix_lie_groups.utils.profiling import (
                device_time_by_op, trace,
            )
            d = os.path.join(args.trace, "kernels" if run["cfg"]["kernels"]
                             else "scan")
            x = inputs(100)
            with trace(d):
                jax.block_until_ready(run["fn"](dp, cp, *x))
            total, busy, window, rows = device_time_by_op(d)
            run["trace"] = dict(
                busy_s=busy * 1e-9, window_s=window * 1e-9,
                idle_share=1 - busy / window if window else None,
                top=[(n[:80], round(t * 1e-9, 5), c) for n, t, c in rows[:12]])
        ts = run["times"]
        print(json.dumps(dict(
            card=card, batch=B, N=N, iterations=args.iters, **run["cfg"],
            compile_s=round(run["compile_s"], 2), solve_s=ts,
            median_solve_s=float(np.median(ts)),
            solves_per_s=round(B / float(np.median(ts)), 1),
            lane0_err=run["lane0_err"],
            peak_gib_so_far=round(run["peak_gib"], 2),
            **({"trace": run["trace"]} if "trace" in run else {}))),
            flush=True)


if __name__ == "__main__":
    main()
