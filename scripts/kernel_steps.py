#!/usr/bin/env python3
"""Time builds of the port's histogram and lane_interp kernels side by
side on one CUDA card, in one process.

    python3 scripts/kernel_steps.py LABEL=DIR LABEL=DIR [...]

Each DIR holds a ``hist.cu`` and a ``lane_interp.cu`` with the port's C
interfaces; a LABEL ending in ``@v1`` marks a ``hist.cu`` with the first
design's interface (unsorted thresholds, counts zeroed by the caller,
no scratch), as in a checkout of that design. The first build is A;
every other build B is timed against it in the order A, B, B, A (CUDA
events, chip_smoke.cuda_ms), each build's output first checked bit-equal
to the plain twin:

- at the histogram's cases (chip_smoke.hist_cases, at full size);
- then in one whole run of chip_smoke.main (every phase and check of
  the smoke run): at each (N, bins) the dose-QA path launched, on the
  path's own tensors, with each build's ms lost over the path's
  launches; and at the lane_interp passes the view path ran. The run's
  chip_smoke.hist_path_lost and chip_smoke.phase_lane_interp, which are
  handed the path's calls and passes, are wrapped for this.

One JSON line per kernel, case and build B: ms of A and B, the
function's bound and each build's share of it; then a line with every
build's ms lost on the dose-QA path. Prints the card's name and power
limit first; chip_smoke's own lines follow its run.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def ab_ms(fn_a, fn_b, reps=10):
    """cs.cuda_ms of two functions timed in turn, A, B, B, A: (mean A,
    mean B)."""
    a1, b1, b2, a2 = (cs.cuda_ms(f, reps) for f in (fn_a, fn_b, fn_b, fn_a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def load_build(csrc, v1=False):
    """hist and lane_interp callables on CUDA tensors for the build in
    ``csrc``, built like the port's own (the wrappers' calls, without
    their checks); ``v1``: its hist.cu has the first design's C
    interface."""
    from medicalimageanalysis_torch.ops import _build
    from medicalimageanalysis_torch.ops.hist import sort_thresholds

    own, _build.CSRC = _build.CSRC, Path(csrc).resolve()
    try:
        hist_lib = ctypes.CDLL(str(_build.build_library("hist")[0]))
        lane_lib = ctypes.CDLL(str(_build.build_library("lane_interp")[0]))
    finally:
        _build.CSRC = own
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    hist_lib.mia_dose_hist.restype = i
    hist_lib.mia_dose_hist.argtypes = (
        [p, p, i64, p, i, p, p] if v1 else [p, p, i64, p, p, i, p, p, p])
    lane_lib.mia_lane_interp.restype = i
    lane_lib.mia_lane_interp.argtypes = [p, p, i64, i, i, p, p]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def hist(dose, valid, thr):
        n = thr.numel()
        if v1:
            counts = torch.zeros(n, dtype=torch.int64, device=dose.device)
            args = (thr.data_ptr(), n, counts.data_ptr())
        else:
            srt, perm = sort_thresholds(thr)
            interval = torch.zeros(n, dtype=torch.int64, device=dose.device)
            counts = torch.empty(n, dtype=torch.int64, device=dose.device)
            args = (srt.data_ptr(), perm.data_ptr(), n, interval.data_ptr(),
                    counts.data_ptr())
        assert hist_lib.mia_dose_hist(dose.data_ptr(), valid.data_ptr(),
                                      dose.numel(), *args, stream()) == 0
        return counts

    def lane(data, pos):
        out = torch.empty(pos.shape, dtype=torch.float32, device=pos.device)
        assert lane_lib.mia_lane_interp(
            data.data_ptr(), pos.data_ptr(), data.shape[0], data.shape[1],
            pos.shape[1], out.data_ptr(), stream()) == 0
        return out

    return {"dose_hist": hist, "lane_interp": lane}


def main(argv):
    from medicalimageanalysis_torch.ops.hist import _hist_plain
    from medicalimageanalysis_torch.ops.lane_interp import lane_interp_plain

    if not torch.cuda.is_available() or len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    print(cs.nvidia_smi(), flush=True)
    builds = {}
    for arg in argv:
        label, csrc = arg.split("=", 1)
        builds[label] = load_build(csrc, v1=label.endswith("@v1"))
    labels = list(builds)
    a = labels[0]

    def compare(kernel, case, args, plain, bound_ms):
        """Every build bit-equal to ``plain`` on ``args``, then each B
        against A: {label: ms}, A's the mean over its pairs."""
        want = plain(*args)
        for label in labels:
            got = builds[label][kernel](*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{label} {kernel} {case}"
        ms = {a: []}
        for label in labels[1:]:
            ms_a, ms[label] = ab_ms(lambda: builds[a][kernel](*args),
                                    lambda: builds[label][kernel](*args))
            ms[a].append(ms_a)
            print(json.dumps(dict(kernel=kernel, case=case, a=a, b=label,
                                  ms_a=ms_a, ms_b=ms[label],
                                  bound_ms=bound_ms,
                                  share_a=bound_ms / ms_a,
                                  share_b=bound_ms / ms[label])), flush=True)
        ms[a] = sum(ms[a]) / len(ms[a])
        return ms

    for case, dose, valid, thr in cs.hist_cases(gen, dev):
        compare("dose_hist", case, (dose, valid, thr), _hist_plain,
                cs.hist_bound(dose.numel(), thr.numel())[0])
        del dose, valid, thr
        torch.cuda.empty_cache()

    smoke_hist_path, smoke_lane = cs.hist_path_lost, cs.phase_lane_interp

    def hist_path_lost(calls, shapes):
        lost = dict.fromkeys(labels, 0.0)
        for (n, n_bins), count in sorted(shapes.items()):
            bound_ms = cs.hist_bound(n, n_bins)[0]
            ms = compare("dose_hist", f"dose_qa_path_n{n}_{n_bins}_x{count}",
                         calls[(n, n_bins)][0], _hist_plain, bound_ms)
            for label in labels:
                lost[label] += count * (ms[label] - bound_ms)
        print(json.dumps(dict(kernel="dose_hist", case="dose_qa_path",
                              launches=sum(shapes.values()), ms_lost=lost)),
              flush=True)
        return smoke_hist_path(calls, shapes)

    def phase_lane_interp(smoke_gen, dev, passes):
        for name, (R, Xs, Xd) in passes.items():
            args = cs.lane_case(gen, R, Xs, Xd, dev)
            compare("lane_interp", f"{name}_{R}x{Xs}x{Xd}", args,
                    lane_interp_plain, cs.lane_bound(R, Xs, Xd)[0])
            del args
            torch.cuda.empty_cache()
        return smoke_lane(smoke_gen, dev, passes)

    cs.hist_path_lost, cs.phase_lane_interp = hist_path_lost, phase_lane_interp
    try:
        return cs.main()
    finally:
        cs.hist_path_lost, cs.phase_lane_interp = smoke_hist_path, smoke_lane


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main(sys.argv[1:]))
