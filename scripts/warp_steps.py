#!/usr/bin/env python3
"""Time builds of the port's warp kernel (csrc/warp.cu) side by side on
one CUDA card, in one process: the design steps of its ``affine`` and
``affine_shear`` modes.

    python3 scripts/warp_steps.py LABEL=DIR LABEL=DIR [...]

Each DIR holds a ``warp.cu`` with the port's C interface
(``mia_warp_affine``, ``mia_warp_affine_shear``, ``mia_warp_coords``,
``mia_warp_disp``). A build that also has ``mia_warp_affine_axis`` takes
it for a map whose off-diagonal coefficients are 0, as the wrapper does
(``ops/warp.affine_path``); one with ``mia_warp_affine_axis_ratio`` is
also timed with each of its two branches forced (ratio 0: every tile
gathers its taps; 1e30: every tile that fits stages its x-lerped rows).
Put each DIR under ``build/`` (git-ignored, copied to the card), e.g.
``git show HEAD~1:medicalimageanalysis_torch/csrc/warp.cu >
build/steps/parent/warp.cu``.

Per build: its ptxas report and the SASS instruction count of each
affine, axis and shear kernel (``cuobjdump -sass``). Then at every case
every build's output is held bit-equal to the plain twin, and each build
B is timed against the first build A in the order A, B, B, A (CUDA
events, ``chip_smoke.cuda_ms``). The cases, at the shapes the paths give
the kernel: the ``affine`` maps of chip_smoke's ``warp_affine`` phase on
(128, 512, 512), a 3° Rigid reslice onto a 128 x 538 x 538 grid, gamma's
fine grids (103 x 165 x 165 at 2.5 mm onto 323 x 509 x 509 at 3 mm, and
onto 423 x 671 x 671 at 2 mm, the evaluated dose 1 mm away), the CT onto
the dose grid and back, a flip and a 1:1 sub-voxel translation; the
``affine_shear`` maps of its ``warp_affine_shear`` phase; ``coords`` B=1
with gradients and ``disp`` B=4 at (128, 512, 512). One JSON line per
case and build B: ms of A and B, the bound and each build's share of it.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

def ab_ms(fn_a, fn_b, reps=10):
    """cs.cuda_ms of two functions timed in turn, A, B, B, A: (mean A,
    mean B)."""
    a1, b1, b2, a2 = (cs.cuda_ms(f, reps) for f in (fn_a, fn_b, fn_b, fn_a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def sass_counts(lib_path, dump=None):
    """{kernel: SASS instructions} of the affine, axis and shear kernels
    in a built library, or a note where cuobjdump is missing; with
    ``dump`` the SASS itself is written there."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return {"note": "cuobjdump not found"}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    if dump:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text(text)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/\s+\S", line):
            counts[name] += 1
    filt = shutil.which("c++filt")
    if filt:
        names = subprocess.run([filt], input="\n".join(counts),
                               capture_output=True, text=True).stdout
        counts = dict(zip(names.splitlines(), counts.values()))
    keep = ("affine_kernel", "axis_kernel", "Mode)1", "Mode)3", "ModeE1",
            "ModeE3")
    return {k: v for k, v in counts.items() if any(s in k for s in keep)}


def load_build(csrc, label):
    """The build in ``csrc``: callables on CUDA tensors calling its entry
    points as the port's wrappers do (without their checks), its ptxas
    report and SASS counts (the SASS in build/warp_sass/LABEL.txt)."""
    from medicalimageanalysis_torch.ops import _build
    from medicalimageanalysis_torch.ops.warp import affine_path

    own, _build.CSRC = _build.CSRC, Path(csrc).resolve()
    try:
        path, ptxas = _build.build_library("warp")
    finally:
        _build.CSRC = own
    lib = _build.bind_warp_library(ctypes.CDLL(str(path)))
    axis = getattr(lib, "mia_warp_affine_axis", None)
    ratio_entry = getattr(lib, "mia_warp_affine_axis_ratio", None)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def affine(vol, coef, shape, bg, ratio=None):
        out = torch.empty((vol.shape[0],) + tuple(shape), device=vol.device)
        c12 = (ctypes.c_float * 12)(*coef)
        args = (vol.data_ptr(), vol.shape[0], *vol.shape[1:], c12, *shape,
                bg, out.data_ptr())
        if ratio is not None:
            err = ratio_entry(*args, ratio, stream())
        elif axis is not None and affine_path(coef) == "warp_affine_axis":
            err = axis(*args, stream())
        else:
            err = lib.mia_warp_affine(*args, stream())
        assert err == 0, f"affine launch failed: {err}"
        return out

    def shear(v2, coef16, dims, shape, bg):
        out = torch.empty((1,) + tuple(shape), device=v2.device)
        c16 = (ctypes.c_float * 16)(*coef16)
        err = lib.mia_warp_affine_shear(
            v2.data_ptr(), 1, *v2.shape[1:3], v2.shape[3], dims[0], dims[1],
            c16, *shape, bg, out.data_ptr(), stream())
        assert err == 0, f"affine_shear launch failed: {err}"
        return out

    def coords(vol, cz, cy, cx, bg):
        outs = [torch.empty((vol.shape[0],) + tuple(cz.shape),
                            device=vol.device) for _ in range(4)]
        err = lib.mia_warp_coords(
            vol.data_ptr(), vol.shape[0], *vol.shape[1:], cz.data_ptr(),
            cy.data_ptr(), cx.data_ptr(), *cz.shape, bg,
            *[o.data_ptr() for o in outs], 1, stream())
        assert err == 0, f"coords launch failed: {err}"
        return outs

    def disp(vol, d, bg):
        out = torch.empty((vol.shape[0],) + tuple(d.shape[1:]),
                          device=vol.device)
        err = lib.mia_warp_disp(vol.data_ptr(), vol.shape[0], *vol.shape[1:],
                                d.data_ptr(), *d.shape[1:], bg,
                                out.data_ptr(), None, None, None, 0,
                                stream())
        assert err == 0, f"disp launch failed: {err}"
        return [out]

    report = [ln.strip() for ln in ptxas.splitlines()
              if "registers" in ln or "spill" in ln or "Function" in ln]
    return dict(affine=affine, shear=shear, coords=coords, disp=disp,
                has_axis=axis is not None, has_ratio=ratio_entry is not None,
                ptxas=report, sass=sass_counts(
                    path, ROOT / "build" / "warp_sass" / f"{label}.txt"))


def about_center(R, shape_in, shape_out, t=(0.0, 0.0, 0.0)):
    """Output pixel (x, y, z) -> input pixel map rotating by R about the
    centres of the two grids, float32."""
    ci = (np.array(shape_in[::-1], float) - 1) / 2
    co = (np.array(shape_out[::-1], float) - 1) / 2
    A = np.eye(4)
    A[:3, :3] = R
    A[:3, 3] = ci + np.asarray(t) - R @ co
    return A.astype(np.float32)


def affine_cases():
    """name -> (input dims, 4x4 map, output dims): chip_smoke's affine
    maps, a 3° Rigid reslice grid and a 1:1 sub-voxel translation."""
    S = cs.SHAPE
    out = cs.affine_cases()
    th = np.deg2rad(3.0)
    Rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                   [0, 0, 1]])
    out["rigid_grid_538"] = (S, about_center(Rz, S, (128, 538, 538),
                                             (0.4, -0.3, 0.2)),
                             (128, 538, 538))
    shift = np.eye(4)
    shift[:3, 3] = [0.31, -0.47, 0.23]
    out["translation"] = (S, shift.astype(np.float32), S)
    return out


def write_probes(builds, gen, dev, bg=-3001.0):
    """Each build at gamma's fine grids with every sample outside the
    volume (a translation of -1e6 voxels in x), so a launch only stores
    ``bg``: its store pattern's own time, through the separable entry
    and (a 1e-30 off-diagonal) the general one, beside torch's fill_ of
    the same output and the write bound. One JSON line per grid."""
    cases = cs.affine_cases()
    for case in ("gamma_3mm", "gamma_2mm"):
        shape_in, A, shape = cases[case]
        vol = torch.randn((1,) + tuple(shape_in), generator=gen, device=dev)
        coef = [float(v) for v in np.float32(A[:3]).reshape(-1)]
        coef[3] = -1e6
        general = list(coef)
        general[1] = 1e-30
        out = torch.empty((1,) + tuple(shape), device=dev)
        n = out.numel()
        row = dict(case=f"probe_outside_{case}", shape_out=list(shape),
                   fill_ms=cs.cuda_ms(lambda: out.fill_(bg)),
                   write_bound_ms=cs.bound(4 * n, 0)[0])
        for label, b in builds.items():
            got = b["affine"](vol, coef, shape, bg)
            torch.cuda.synchronize()
            assert bool((got == bg).all()), (label, case)
            del got
            row[label] = cs.cuda_ms(lambda: b["affine"](vol, coef, shape, bg))
            row[f"{label}:general"] = cs.cuda_ms(
                lambda: b["affine"](vol, general, shape, bg))
        print(json.dumps(row), flush=True)
        del vol, out
        torch.cuda.empty_cache()


def main(argv):
    from medicalimageanalysis_torch.ops.warp import (affine_path,
                                                     warp_affine_plain,
                                                     warp_affine_shear_plain,
                                                     warp_coords_plain,
                                                     warp_disp_plain)

    if not torch.cuda.is_available() or len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    print(cs.nvidia_smi(), flush=True)
    builds = {}
    for arg in argv:
        label, csrc = arg.split("=", 1)
        builds[label] = load_build(csrc, label)
        print(json.dumps(dict(build=label, ptxas=builds[label]["ptxas"],
                              sass=builds[label]["sass"])), flush=True)
    labels = list(builds)
    a = labels[0]
    bg = -3001.0

    def compare(case, variants, plain, bound_ms, extra=None):
        """``variants``: {label: fn} with ``a`` first; each bit-equal to
        ``plain()``, then each timed against ``a``."""
        want = plain()
        want = want if isinstance(want, list) else [want]
        for label, fn in variants.items():
            got = fn()
            got = got if isinstance(got, list) else [got]
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                f"{label} {case}: kernel != plain"
        del want
        for label, fn in variants.items():
            if label == a:
                continue
            ms_a, ms_b = ab_ms(variants[a], fn)
            print(json.dumps(dict(case=case, a=a, b=label, ms_a=ms_a,
                                  ms_b=ms_b, bound_ms=bound_ms,
                                  share_a=bound_ms / ms_a,
                                  share_b=bound_ms / ms_b, **(extra or {}))),
                  flush=True)

    for case, (shape_in, A, shape_out) in affine_cases().items():
        vol = torch.randn((1,) + tuple(shape_in), generator=gen,
                          device=dev) * 500
        coef = [float(v) for v in np.float32(A[:3]).reshape(-1)]
        path = affine_path(coef)
        variants = {label: (lambda b=b: b["affine"](vol, coef, shape_out, bg))
                    for label, b in builds.items()}
        for label, b in builds.items():
            if b["has_ratio"] and path == "warp_affine_axis":
                for branch, ratio in (("gather", 0.0), ("stage", 1e30)):
                    variants[f"{label}:{branch}"] = (
                        lambda b=b, r=ratio: b["affine"](vol, coef, shape_out,
                                                         bg, ratio=r))
        compare(f"affine_{case}", variants,
                lambda: warp_affine_plain(vol, coef, shape_out, bg),
                cs.affine_bound(vol, coef, shape_out)[0],
                dict(path=path, shape_in=list(shape_in),
                     shape_out=list(shape_out)))
        del vol
        torch.cuda.empty_cache()

    write_probes(builds, gen, dev)

    vol = torch.randn(cs.SHAPE, generator=gen, device=dev) * 500
    for case, A in cs.oblique_cases().items():
        from medicalimageanalysis_torch.ops.warp import (oblique_plan,
                                                         oblique_v2)

        _, _, A2, volr = cs.relayout(vol, A)
        plan = oblique_plan(A2, tuple(volr.shape))
        coef = [float(v) for v in np.float32(A2[:3]).reshape(-1)] + [
            float(np.float32(plan[k])) for k in ("ky", "kz", "oy", "oz")]
        v2 = oblique_v2(volr, plan)[None]
        dims = list(volr.shape)
        n_out = int(np.prod(cs.SHAPE))
        compare(f"affine_shear_{case}",
                {label: (lambda b=b: b["shear"](v2, coef, dims, cs.SHAPE, bg))
                 for label, b in builds.items()},
                lambda: warp_affine_shear_plain(v2, coef, dims, cs.SHAPE, bg),
                cs.bound(4 * (volr.numel() + n_out), 30 * n_out)[0])
        del v2, volr
        torch.cuda.empty_cache()
    del vol

    cz, cy, cx = cs.smooth_warp(gen, cs.SHAPE, dev)
    vol = torch.randn((1,) + cs.SHAPE, generator=gen, device=dev) * 500
    compare("coords_B1_grad1",
            {label: (lambda b=b: b["coords"](vol, cz, cy, cx, bg))
             for label, b in builds.items()},
            lambda: warp_coords_plain(vol, cz, cy, cx, bg, True),
            cs.warp_bound(vol.numel(), cz.numel(), 1, 3, True)[0])
    del cz, cy, cx, vol
    d = cs.smooth_disp(gen, cs.SHAPE, dev)
    vol = torch.randn((4,) + cs.SHAPE, generator=gen, device=dev) * 500
    compare("disp_B4",
            {label: (lambda b=b: b["disp"](vol, d, 0.0))
             for label, b in builds.items()},
            lambda: warp_disp_plain(vol, d, 0.0, False),
            cs.warp_bound(vol[0].numel(), d[0].numel(), 4, 3, False)[0])
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main(sys.argv[1:]))
