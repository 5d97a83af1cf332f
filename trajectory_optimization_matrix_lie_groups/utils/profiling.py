"""Profiling helpers — the analog of the reference's `run_profiler.py`
(cProfile wrapper) and per-phase `perf_counter` prints
(`traopt_controller.py:135-137,641-660`).
"""

import collections
import contextlib
import glob
import os
import time

import jax


@contextlib.contextmanager
def trace(log_dir):
    """Capture a jax.profiler device trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_time_by_op(log_dir):
    """Sum device-side event durations by name over the newest trace in
    ``log_dir`` (a `trace` output).  Returns (total_ns, busy_ns, window_ns,
    [(name, ns, count)] sorted by time): busy is the union of the event
    intervals on the device lines, window their first start to last
    end."""
    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")),
        key=os.path.getmtime)
    pd = ProfileData.from_file(files[-1])
    per = collections.defaultdict(lambda: [0, 0])
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                per[ev.name][0] += ev.duration_ns
                per[ev.name][1] += 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    rows = sorted(((k, v[0], v[1]) for k, v in per.items()),
                  key=lambda r: -r[1])
    return sum(r[1] for r in rows), busy, window, rows


class PhaseTimer:
    """Wall-clock phase timer with device sync (replaces the reference's
    inline perf_counter prints with structured records)."""

    def __init__(self):
        self.records = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        yield
        # block on any outstanding device work so phases are attributable
        jax.effects_barrier()
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self):
        return {
            k: dict(n=len(v), total=sum(v), mean=sum(v) / len(v))
            for k, v in self.records.items()
        }
