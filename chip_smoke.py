#!/usr/bin/env python
"""Smoke run of the batched SE(3) MS-iLQR main path on one NVIDIA GPU.

    python chip_smoke.py            # every single-card phase
    python chip_smoke.py --four     # only the 4-card sharded path

Phases (one result line each; any failure raises and exits non-zero):

  1. device: platform, device kind, count, card name and power limit;
  2. the f32 pipeline at full size (N=200, 12 iterations, B=32768) with the
     compiled kernels: lane 0 against the f64 golden, every lane finite;
  3. each kernel against the plain `lax.scan` over the same stage
     functions, on identical inputs at N=200, B=32768;
  4. double-f32 error-free transforms (dfx add/mul) against numpy f64;
  5. one input-box constrained solve (ALPipelineSolver, B=4096, 14 outers)
     with a box that binds (`se3_bench.al_box`);
  6. the <=1e-4 control-fidelity gate: the mixed double-f32 polish
     (f32x7 + df2, B=16384) and the native-f64 polish (B=16384).

The last line is one JSON object: {"ok": true, "device": {...}}.  There is
no CPU mode: without a GPU the script fails at once.
"""

import argparse
import json
import resource
import subprocess
import sys
import time

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

N = se3_bench.HORIZON
ITERS = 12
B_MAIN = 32768
B_GATE = 16384
B_AL = 4096
F32_GATE = 2e-3      # lane-0 |us - golden| of the f32 pipeline
FIDELITY_GATE = 1e-4  # BASELINE.md control-fidelity gate
# kernel vs scan: same operations in the same order per entry, but the GPU
# contracts mul+add into FMAs differently in the two programs and the
# Cholesky solve for k, K amplifies last-bit differences by Quu's
# conditioning.  Each output is compared entrywise with rtol + atol_rel x
# its largest |entry|.  On an H100 the worst max|diff| / max|ref| is 1.4e-6
# (K) in the backward outputs and 6.4e-6 (lxx) in the rollout's, except lx
# at 1.8e-5: its Jr^-1 series is taken at rollout states that already
# differ by ~5e-6.  The bounds leave a margin of 3-7x.
KERNEL_RTOL = 1e-5
KERNEL_ATOL_REL = 2e-5
KERNEL_ATOL_REL_LX = 5e-5


T0 = time.perf_counter()


def line(phase, **kw):
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps({"phase": phase, **kw,
                      "wall_s": round(time.perf_counter() - T0, 1),
                      "host_peak_gib": round(peak, 2)}),
          flush=True)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def batch(q0, xi0, B, seed, scale=0.05):
    """B perturbed initial poses; lane 0 is the golden problem's."""
    dq = scale * jax.random.normal(jax.random.PRNGKey(seed), (B, 6),
                                   jnp.float32)
    q0s = SE3.normalize(q0[None] @ SE3.exp(dq)).at[0].set(q0)
    return (q0s, jnp.broadcast_to(xi0, (B, 6)),
            jnp.zeros((B, N, 6), jnp.float32))


def timed(fn, *args):
    t = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t


def phase_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (platform {dev.platform!r})")
    line("device", platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()), card=card())
    return dev


def phase_f32(dp, cp, q0, xi0, us_golden):
    solver = PipelineSolver(N, ITERS, se3_bench.DT)
    assert solver.kernels
    q0s, xi0s, us0 = batch(q0, xi0, B_MAIN, 1)
    t = time.perf_counter()
    compiled = solver._solve_jit.lower(dp, cp, q0s, xi0s, us0).compile()
    t_compile = time.perf_counter() - t
    out, t_first = timed(compiled, dp, cp, q0s, xi0s, us0)
    q0s, xi0s, us0 = batch(q0, xi0, B_MAIN, 2)
    out, t_solve = timed(compiled, dp, cp, q0s, xi0s, us0)
    us = np.asarray(out.us)
    gn = np.asarray(out.grad_norm, np.float64)
    err = float(np.max(np.abs(us[0].astype(np.float64) - us_golden)))
    finite = bool(np.isfinite(us).all() and np.isfinite(gn).all())
    line("f32_pipeline", N=N, iterations=ITERS, batch=B_MAIN,
         kernels=solver.kernels,
         compile_s=round(t_compile, 2), first_solve_s=round(t_first, 3),
         solve_s=round(t_solve, 4), solves_per_s=round(B_MAIN / t_solve, 1),
         lane0_err=err, all_finite=finite,
         grad_norm_p50=float(np.percentile(gn, 50)),
         grad_norm_p95=float(np.percentile(gn, 95)),
         grad_norm_max=float(gn.max()))
    assert finite, "non-finite lanes"
    assert err <= F32_GATE, f"lane-0 error {err} > {F32_GATE}"


@jax.jit
def _close(a, b, scale, atol_rel):
    """(max |a - b| / scale, number of entries outside the tolerance),
    computed on the device (the compared arrays are gigabytes)."""
    d = jnp.abs(a - b)
    bad = d > KERNEL_RTOL * jnp.abs(b) + atol_rel * scale
    return jnp.max(d) / scale, jnp.sum(bad)


def phase_kernels(dp, cp, q0, xi0):
    """Backward and rollout+linearize kernels vs the scan, same inputs."""
    ker = PipelineSolver(N, ITERS, se3_bench.DT, kernels=True)
    ref = PipelineSolver(N, ITERS, se3_bench.DT, kernels=False)
    q0s, xi0s, us0 = batch(q0, xi0, B_MAIN, 3)

    def inputs(dp, cp, q0s, xi0s, us0):
        qR, qp, xi, us, refs, consts, term_refs = ker._prepare(
            dp, cp, q0s, xi0s, us0)
        lin = ker._linearize_lane(qR, qp, xi, us, refs, consts)
        lu = 2.0 * jnp.einsum("ij,njb->nib", cp.R, us)
        term = (qR[-1], qp[-1], xi[-1]) + term_refs
        return qR, qp, xi, us, refs, consts, lin, lu, term

    ins = jax.block_until_ready(jax.jit(inputs)(dp, cp, q0s, xi0s, us0))
    qR, qp, xi, us, refs, consts, lin, lu, term = ins

    def compare(part, fn, args, names):
        # the compared inputs are jit ARGUMENTS: a closure would embed
        # gigabytes of them in the executable as constants
        fn = jax.jit(fn, static_argnums=0)
        t = time.perf_counter()
        a = jax.block_until_ready(fn(ker, *args))
        t_ker = time.perf_counter() - t
        b = jax.block_until_ready(fn(ref, *args))
        errs, bad = {}, []
        for n in names:
            # the defect after a gap-closing rollout is rounding noise of a
            # difference of states: scale it by the twist it is taken from
            scale = jnp.max(jnp.abs(b["fxi" if n == "d" else n]))
            atol = KERNEL_ATOL_REL_LX if n == "lx" else KERNEL_ATOL_REL
            e, nbad = _close(a[n], b[n], jnp.maximum(scale, 1e-30), atol)
            errs[n] = float(e)
            if int(nbad):
                bad.append((n, errs[n], int(nbad)))
        line("kernel_vs_scan", kernel=part, N=N, batch=B_MAIN,
             first_call_s=round(t_ker, 2), max_err_rel_to_max=errs,
             rtol=KERNEL_RTOL, atol_rel=KERNEL_ATOL_REL,
             atol_rel_lx=KERNEL_ATOL_REL_LX)
        return bad, b

    def backward(s, lin, lu, term, consts):
        k, K, gvec, _ = s._backward_lane(lin, lu, term, consts)
        return dict(k=k, K=K, gvec=gvec)

    bad, ref_bw = compare("backward", backward, (lin, lu, term, consts),
                          ("k", "K", "gvec"))

    def rollout(s, qR, qp, xi, us, k, K, lin, refs, consts):
        qR2, qp2, xi2, us2, lin2 = s._rollout_linearize_lane(
            qR, qp, xi, us, k, K, lin, refs, consts)
        return dict(qR=qR2, qp=qp2, xi=xi2, us=us2, **lin2)

    bad += compare("rollout_linearize", rollout,
                   (qR, qp, xi, us, ref_bw["k"], ref_bw["K"], lin, refs,
                    consts),
                   ("qR", "qp", "xi", "us", "fqR", "fqp", "fxi", "d", "Fx",
                    "lx", "lxx", "l"))[0]
    assert not bad, f"kernel outside tolerance: {bad}"


def phase_gate(q0, xi0, us_golden):
    from trajectory_optimization_matrix_lie_groups.solvers.df_mixed import (
        MixedDFPipelineSolver,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.df_pipeline import (
        join_us,
    )
    from trajectory_optimization_matrix_lie_groups.solvers.polish import (
        HighPrecisionSolver,
    )

    params64 = se3_bench.build_problem_np64()
    q0s, xi0s, us0 = batch(q0, xi0, B_GATE, 4)
    mx = MixedDFPipelineSolver(N=N, dt=se3_bench.DT, f32_iterations=7,
                               df_iterations=2)
    out, t_first = timed(mx.solve, params64, q0s, xi0s, us0)
    q0s, xi0s, us0 = batch(q0, xi0, B_GATE, 5)
    out, t_solve = timed(mx.solve, params64, q0s, xi0s, us0)
    err = float(np.max(np.abs(join_us(out)[0] - us_golden)))
    gn = np.asarray(out.grad_norm, np.float64)
    line("gate_mixed_df", mode="f32x7+df2", batch=B_GATE,
         first_solve_s=round(t_first, 2), solve_s=round(t_solve, 4),
         lane0_err=err, grad_norm_p50=float(np.percentile(gn, 50)),
         grad_norm_max=float(gn.max()))
    assert err <= FIDELITY_GATE, f"mixed-DF lane-0 error {err}"

    jax.config.update("jax_enable_x64", True)
    try:
        model64, p64, *_ = se3_bench.build_problem(jnp.float64)
        hp = HighPrecisionSolver(model64, N=N, iterations=ITERS,
                                 dt=se3_bench.DT, polish_iters=2)
        out, t_first = timed(hp.solve, p64, q0s, xi0s, us0)
        err = float(np.max(np.abs(np.asarray(out.us[0]) - us_golden)))
        gn = np.asarray(out.grad_norm, np.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    line("gate_native_f64", mode="f32x12+f64x2", batch=B_GATE,
         first_solve_s=round(t_first, 2), lane0_err=err,
         grad_norm_p50=float(np.percentile(gn, 50)),
         grad_norm_max=float(gn.max()))
    assert err <= FIDELITY_GATE, f"native-f64 lane-0 error {err}"


def phase_dfx():
    from trajectory_optimization_matrix_lie_groups.ops import dfx

    rng = np.random.default_rng(0)
    a = rng.uniform(-1e3, 1e3, 1 << 20) * np.exp(rng.uniform(-5, 5, 1 << 20))
    b = rng.uniform(-1e3, 1e3, 1 << 20) * np.exp(rng.uniform(-5, 5, 1 << 20))
    split = lambda x: (x.astype(np.float32),
                       (x - x.astype(np.float32).astype(np.float64))
                       .astype(np.float32))

    @jax.jit
    def ops(ah, al, bh, bl):
        x, y = dfx.DF(ah, al), dfx.DF(bh, bl)
        s, p = x + y, x * y
        return s.hi, s.lo, p.hi, p.lo

    outs = [np.asarray(o, np.float64) for o in ops(*split(a), *split(b))]
    # reference: the exact sum/product of the f32-split operands
    a2 = sum(np.asarray(v, np.float64) for v in split(a))
    b2 = sum(np.asarray(v, np.float64) for v in split(b))
    # relative to the operands' size (a sum may cancel), and to the product
    e_add = float(np.max(np.abs(outs[0] + outs[1] - (a2 + b2))
                         / (np.abs(a2) + np.abs(b2))))
    e_mul = float(np.max(np.abs(outs[2] + outs[3] - a2 * b2)
                         / np.abs(a2 * b2)))
    line("dfx_eft", n=int(a.size), add_rel_err=e_add, mul_rel_err=e_mul,
         bound=1e-12)
    assert e_add <= 1e-12 and e_mul <= 1e-12, (e_add, e_mul)


def phase_al(dp, cp, q0, xi0):
    from trajectory_optimization_matrix_lie_groups.solvers.al_pipeline import (
        ALPipelineSolver,
    )

    lb, ub = se3_bench.al_box()
    al = ALPipelineSolver(PipelineSolver(N, ITERS, se3_bench.DT), lb=lb, ub=ub)
    q0s, xi0s, us0 = batch(q0, xi0, B_AL, 6)
    t = time.perf_counter()
    res = al.solve(dp, cp, q0s, xi0s, us0, n_al_iters=14)
    jax.block_until_ready(res.us)
    wall = time.perf_counter() - t
    # raises unless the box binds and the outer loop converges
    stats = se3_bench.al_summary(res, lb, ub)
    line("al_pipeline", batch=B_AL, box_fraction=se3_bench.AL_BOX_FRACTION,
         wall_s_with_compile=round(wall, 2), **stats)


def phase_four(dp, cp, q0, xi0):
    """The 4-card batch mesh vs single-card solves of the same problems."""
    from trajectory_optimization_matrix_lie_groups.parallel.batch import (
        make_batch_mesh,
    )
    from trajectory_optimization_matrix_lie_groups.parallel.pipeline_sharded import (
        ShardedPipelineSolver,
    )

    n = len(jax.devices())
    assert n == 4, f"--four needs 4 cards, found {n}"
    solver = PipelineSolver(N, ITERS, se3_bench.DT)
    sharded = ShardedPipelineSolver(solver, make_batch_mesh(4))
    q0s, xi0s, us0 = batch(q0, xi0, 4 * B_MAIN, 7)
    out, t_first = timed(sharded.solve, dp, cp, q0s, xi0s, us0)
    q0s, xi0s, us0 = batch(q0, xi0, 4 * B_MAIN, 8)
    out, t_solve = timed(sharded.solve, dp, cp, q0s, xi0s, us0)
    us4 = np.asarray(out.us)
    worst = 0.0
    for d in range(4):
        # each card's shard, solved again on card 0 alone (one executable)
        sl = slice(d * B_MAIN, (d + 1) * B_MAIN)
        one = solver.solve(dp, cp, q0s[sl], xi0s[sl], us0[sl])
        worst = max(worst, float(np.max(np.abs(np.asarray(one.us) - us4[sl]))))
    line("four_card_sharded", batch=4 * B_MAIN, per_card=B_MAIN,
         first_solve_s=round(t_first, 2), solve_s=round(t_solve, 4),
         solves_per_s=round(4 * B_MAIN / t_solve, 1),
         max_diff_vs_single_card=worst,
         all_finite=bool(np.isfinite(us4).all()))
    assert np.isfinite(us4).all(), "non-finite lanes"
    assert worst <= KERNEL_ATOL_REL * float(np.abs(us4).max()), worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded path")
    args = ap.parse_args()
    dev = phase_device()
    _, params, q0, xi0, _, _ = se3_bench.build_problem(jnp.float32)
    dp, cp = params["dyn"], params["cost"]
    _, _, us_golden = se3_bench.load_golden()
    if args.four:
        phase_four(dp, cp, q0, xi0)
    else:
        phase_f32(dp, cp, q0, xi0, us_golden)
        phase_kernels(dp, cp, q0, xi0)
        phase_dfx()
        phase_al(dp, cp, q0, xi0)
        phase_gate(q0, xi0, us_golden)
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
