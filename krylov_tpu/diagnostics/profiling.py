"""Profiling hooks: device-level traces and phase micro-timing.

The reference's instrumentation is wall-clock around the whole loop plus a
single hand-rolled basis-phase timer (reference: v1/processes/common.py:21-26,
returned as ``krylov_base_times`` at v1/processes/adaptivekskipmrr.py:381).
On an accelerator the idiomatic equivalents are:

- :func:`trace_solve` — wrap a solve in a ``jax.profiler`` trace; the
  resulting TensorBoard/Perfetto trace attributes time to every fused
  kernel, collective, and transfer (far beyond the reference's one timer).
- :func:`phase_times` — coarse host-side phase timing (setup / solve /
  fetch) for quick regressions without a trace viewer.
- :func:`device_events` + :func:`per_iteration` — the reduction from a
  trace to per-iteration device numbers: device time, kernels, copies and
  the idle share of the traced window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager: capture a device profile into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def trace_solve(A, b, log_dir: str, **solve_kwargs):
    """Run ``krylov_tpu.solve`` under a profiler trace; returns (x, info)."""
    from krylov_tpu.api import solve

    with trace(log_dir):
        out = solve(A, b, **solve_kwargs)
    return out


def phase_times(A, b, **solve_kwargs) -> dict:
    """Host-side phase breakdown: compile (first call), solve (device
    completion, second call), fetch (host materialization)."""
    import numpy as np

    from krylov_tpu.api import solve_device

    t0 = time.perf_counter()
    res = solve_device(A, b, **solve_kwargs)
    jax.block_until_ready(res)
    compile_and_first = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = solve_device(A, b, **solve_kwargs)
    jax.block_until_ready(res)
    solve_t = time.perf_counter() - t0

    t0 = time.perf_counter()
    np.asarray(res.x)
    np.asarray(res.residual_trace)
    fetch_t = time.perf_counter() - t0

    return {
        "compile_plus_first_solve_s": compile_and_first,
        "solve_s": solve_t,
        "fetch_s": fetch_t,
        "iterations": int(res.iterations),
        "converged": bool(res.converged),
    }


# Device-plane lines that aggregate other events (module / op / step
# summaries) rather than record what ran on a stream.
_SUMMARY_LINES = ("XLA Modules", "XLA Ops", "XLA TraceMe", "Steps", "Framework")


def device_events(trace_dir: str) -> dict:
    """``{"<plane> | <line>": [(name, start_ns, duration_ns), ...]}`` for
    every stream line of every accelerator plane in the newest trace under
    ``trace_dir`` (empty when the trace holds no device plane, as on CPU)."""
    import glob
    import os

    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            if line.name.startswith(_SUMMARY_LINES):
                continue
            events = [(e.name, int(e.start_ns), int(e.duration_ns)) for e in line.events]
            if events:
                out[f"{plane.name} | {line.name}"] = events
    return out


def _is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def per_iteration(events, iterations: int) -> dict:
    """Reduce device events of a traced window to per-iteration numbers.

    ``events`` is an iterable of ``(name, start_ns, duration_ns)`` from one
    device.  Busy time is the union of the event intervals; the window runs
    from the first event's start to the last event's end, and the idle share
    is the part of that window in which nothing ran.  Copies and memsets
    (e.g. a loop predicate fetched to the host each trip) are counted apart
    from kernels."""
    ev = sorted((int(s), int(s) + int(d), n) for n, s, d in events)
    if not ev or iterations <= 0:
        raise ValueError("need device events and a positive iteration count")
    busy = 0
    cur_s, cur_e = ev[0][0], ev[0][1]
    for s, e, _ in ev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e, _ in ev) - ev[0][0]
    copies = sum(1 for *_, n in ev if _is_copy(n))
    return {
        "iterations": int(iterations),
        "events": len(ev),
        "kernels_per_iter": (len(ev) - copies) / iterations,
        "copies_per_iter": copies / iterations,
        "busy_us_per_iter": busy / iterations / 1e3,
        "window_us_per_iter": window / iterations / 1e3,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
    }
