"""The traced window: torch.profiler's timeline, reduced once.

:class:`Trace` holds, on the profiler's own clock, every device activity
(kernels, copies, fills) in the window, the host ranges (the benchmark's
``bench.*`` spans and the port's ``mia.*`` spans), and for each device
activity the host time of the runtime call that launched it. The
per-layer readers in ``benchmark/metrics`` take their numbers from it:
device time under a span, a kernel's device time by name, the busy share.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

# the port's hand kernels by device-event name (the profiler's kernel
# names of csrc/warp.cu, hist.cu and lane_interp.cu), as the wrapper
# counters of ops/warp.py, ops/hist.py and ops/lane_interp.py name them
_WARP_MODES = {"0": "warp_coords", "1": "warp_affine", "2": "warp_disp",
               "3": "warp_affine_shear"}


def kernel_of(name):
    """The wrapper a device event answers to, or None. A histogram call
    launches two kernels; its main pass ``dose_hist_count`` answers, and
    its finish is counted with it in :meth:`Trace.kernel_s`."""
    if "dose_hist" in name:
        return "dose_hist"
    if "lane_interp_kernel" in name:
        return "lane_interp"
    if "axis_kernel" in name:
        return "warp_affine_axis"
    mode = re.search(r"(?:warp|affine)_kernel<\(\(anonymous namespace\)"
                     r"::Mode\)(\d)", name)
    return _WARP_MODES[mode.group(1)] if mode else None


def merged(intervals):
    """(start, end) intervals merged where they overlap, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device activities and host ranges of one traced window, in
    nanoseconds on one clock.

    device: list of (start, end, name, launch time or None)
    ranges: list of (start, end, name) host ranges (user annotations)
    window: (start, end) of the ``bench.window`` range
    """

    def __init__(self, device, ranges, window):
        self.window = window
        w0, w1 = window
        self.device = [d for d in device if d[1] > w0 and d[0] < w1]
        self.ranges = ranges

    @classmethod
    def from_profiler(cls, prof):
        """Reduce a finished ``torch.profiler.profile``."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = prof.profiler.kineto_results.events()
        launch_at, device, ranges, window = {}, [], [], None
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            name, on_device = e.name(), e.device_type() == cuda
            if e.is_user_annotation() or name.startswith(("bench.", "mia.")):
                if on_device:
                    continue     # the profiler's device-side copy of a range
                if name == "bench.window":
                    window = (start, end)
                else:
                    ranges.append((start, end, name))
            elif on_device:
                device.append((start, end, name, e.correlation_id()))
            elif name.startswith("cu"):
                launch_at[e.correlation_id()] = start
        if window is None:
            raise RuntimeError("the trace holds no bench.window range")
        device = [(s, e, n, launch_at.get(c)) for s, e, n, c in device]
        return cls(device, ranges, window)

    # -- the numbers the readers take ----------------------------------
    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-9

    def clipped(self):
        w0, w1 = self.window
        return [(max(s, w0), min(e, w1)) for s, e, _, _ in self.device]

    @property
    def busy_s(self):
        """Seconds of the window in which some operation ran on the
        device (the union of the activities' intervals)."""
        return sum(e - s for s, e in merged(self.clipped())) * 1e-9

    def kernel_s(self):
        """Device seconds of the port's hand kernels by wrapper name."""
        out = defaultdict(float)
        for s, e, name, _ in self.device:
            k = kernel_of(name)
            if k is not None:
                out[k] += (e - s) * 1e-9
        return dict(out)

    def span_device_s(self, name):
        """(device seconds of the activities launched inside the host
        ranges called ``name``, number of such ranges)."""
        spans = sorted((s, e) for s, e, n in self.ranges if n == name)
        if not spans:
            return None, 0
        starts = [s for s, _ in spans]
        total = 0
        for s, e, _, at in self.device:
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                total += e - s
        return total * 1e-9, len(spans)

    def top_ops(self, n=10):
        """The n device operations that took most time: [name, s]."""
        by = defaultdict(int)
        for s, e, name, _ in self.device:
            by[name[:120]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]

    def idle_gaps(self, n=10, min_gap_ns=20_000):
        """The device's idle time in the window by what the host was
        doing: each gap of at least ``min_gap_ns`` goes to the innermost
        host range (latest start) that covers its middle, else to
        'no span'; [name, s] for the n largest sums."""
        w0, w1 = self.window
        busy = merged(self.clipped())
        gaps, prev = [], w0
        for s, e in busy:
            if s - prev >= min_gap_ns:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 - prev >= min_gap_ns:
            gaps.append((prev, w1))
        if not gaps:
            return []
        mids = [(a + b) / 2 for a, b in gaps]
        owner = [None] * len(gaps)
        owner_start = [-1] * len(gaps)
        for s, e, name in self.ranges:
            lo = bisect.bisect_left(mids, s)
            hi = bisect.bisect_right(mids, e)
            for i in range(lo, hi):
                if s > owner_start[i]:
                    owner[i], owner_start[i] = name, s
        by = defaultdict(int)
        for (a, b), name in zip(gaps, owner):
            by[name or "no span"] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]
