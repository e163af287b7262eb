"""The port's own spans in a traced window, and what ran under them.

The port marks its stages with profiler ranges named
``mia.<layer>.<stage>`` (``medicalimageanalysis_torch/telemetry.trace``),
on the clock the trace gives the device's activities. These functions
read a :class:`harness.tracing.Trace` by those ranges, beside what
``Trace`` reads itself (``span_device_s``, the device time launched under
a range): the activities launched under a range, the time inside a range
in which the device ran nothing, and the copies by the innermost range
around their launch. Each returns None where the trace holds no range of
the name, so a program without the span reads nothing; with the span it
reads what is there, 0 included.

The copies' total is taken under the benchmark's own ``bench.*`` ranges
(its calls into the port), which the program under test cannot move;
the split by the port's ``mia.*`` ranges is a breakdown of it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from .tracing import merged

PORT = "mia."          # the prefix of every span of the port
BENCH = "bench."       # the prefix of the benchmark's spans around its calls
COPY = "Memcpy"        # the profiler's name of a copy's device activity


def _intervals(trace, name):
    """The ranges called ``name``, clipped to the window and merged (a
    range inside another of its name counts once), or None."""
    if trace is None:
        return None
    w0, w1 = trace.window
    spans = [(max(s, w0), min(e, w1)) for s, e, n in trace.ranges
             if n == name and e > w0 and s < w1]
    return merged(spans) if spans else None


def launches(trace, name):
    """The number of device activities whose launch lies inside a range
    called ``name``; None without one."""
    spans = _intervals(trace, name)
    if spans is None:
        return None
    starts = [s for s, _ in spans]
    n = 0
    for _, _, _, at in trace.device:
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        n += i >= 0 and at <= spans[i][1]
    return n


def idle_s(trace, name):
    """Seconds inside the ranges called ``name`` in which the device ran
    nothing, whoever launched what it ran (work launched before the
    range and still running inside it keeps the device busy)."""
    spans = _intervals(trace, name)
    if spans is None:
        return None
    busy = merged(trace.clipped())
    idle, j = 0, 0
    for s, e in spans:
        covered = 0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += (e - s) - covered
    return idle * 1e-9


def innermost(trace, times, prefix=PORT):
    """For each time in ``times``, the name of the innermost range (the
    latest to start) whose name starts with ``prefix`` and that holds
    the time, or None; the ranges of one thread nest, so a stack of the
    open ones finds it."""
    ranges = sorted(((s, -e, n) for s, e, n in trace.ranges
                     if n.startswith(prefix)))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    stack, r = [], 0
    for i in order:
        t = times[i]
        while r < len(ranges) and ranges[r][0] <= t:
            s, neg_e, n = ranges[r]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((-neg_e, n))
            r += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        if stack:
            out[i] = stack[-1][1]
    return out


def copies_by_range(trace, prefix=PORT):
    """{(innermost ``prefix`` range of the launch or None, copy name):
    device seconds} of every copy in the window; None where the trace
    holds no range with the prefix."""
    if trace is None or not any(n.startswith(prefix)
                                for _, _, n in trace.ranges):
        return None
    copies = [a for a in trace.device
              if a[2].startswith(COPY) and a[3] is not None]
    owners = innermost(trace, [a[3] for a in copies], prefix)
    out = defaultdict(float)
    for (s, e, name, _), owner in zip(copies, owners):
        out[(owner, name)] += (e - s) * 1e-9
    return dict(out)


def copy_s(trace, prefix=BENCH):
    """Device seconds of the copies launched under any ``prefix`` range."""
    by = copies_by_range(trace, prefix)
    return None if by is None else sum(
        v for (owner, _), v in by.items() if owner is not None)


def per_job(run, value, scale=1.0):
    """``value`` times ``scale`` over the jobs of the window; None where
    there is no value or no job."""
    if value is None or not run.jobs:
        return None
    return scale * value / len(run.jobs)
