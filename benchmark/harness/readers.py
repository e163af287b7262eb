"""What the per-metric readers in ``benchmark/metrics`` share.

Each reader is ``read(run) -> value or None``: None where the run holds
nothing to read (the metric is then left out of the result line), and
never 0 for a share of a roofline.
"""

from __future__ import annotations

from . import roofline
from .core import quantile


def seconds_per_job(run):
    """The window over the jobs it completed: all the work and all the
    time of the window."""
    return run.window_s / len(run.jobs) if run.jobs else None


def job_p95_ms(run):
    """95th percentile of every job's latency in the window, in ms."""
    return 1e3 * quantile([b - a for a, b in run.jobs], 0.95) \
        if run.jobs else None


def span_device_ms(run, span):
    """Device ms per ``span`` of the benchmark's own, from the trace."""
    if run.trace is None:
        return None
    total, n = run.trace.span_device_s("bench." + span)
    return 1e3 * total / n if n and total > 0 else None


def span_wall_ms(run, *spans):
    """Wall ms of the named spans per job."""
    if not run.jobs or not any(run.spans.get(s) for s in spans):
        return None
    return 1e3 * sum(run.span_total_s(s) for s in spans) / len(run.jobs)


def port_span_s(run, *names):
    """Seconds per job of the port's own trace ranges ``names``."""
    if run.trace is None or not run.jobs:
        return None
    total = sum(e - s for s, e, n in run.trace.ranges if n in names)
    return total * 1e-9 / len(run.jobs) if total > 0 else None


def kernel_roofline(run):
    """Sum of the bounds of the hand kernels' launches in the window over
    their summed device time, in %."""
    if run.trace is None:
        return None
    bounds = roofline.launch_bounds_s(run.launch_shapes.get("warp", {}),
                                      run.launch_shapes.get("hist", {}))
    return roofline.kernel_share(bounds, run.trace.kernel_s())


def device_idle(run):
    """1 - busy / window, in %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
