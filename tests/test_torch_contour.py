"""The port's border tracer (native/contour_trace.cpp) against the JAX
package's cv2 path: ``native.trace_external`` against
``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``,
``MaskToContour`` and ``contours_from_mask`` against the JAX package's,
contour for contour and point for point (int32 pixels; positions to
1e-9 mm), on discs and annuli, islands in holes, masks touching each edge
of the frame, diagonal-only chains, one- and two-pixel components, random
masks, and all three planes. A mask -> contour -> mask round trip equals
the JAX package's bit for bit and reaches its fixed point after one pass.
The port's modules and ``chip_smoke.py`` import, and trace, without cv2.
"""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.native import trace_external
from medicalimageanalysis_torch.utils.convert import contour as tcontour
from medicalimageanalysis_torch.utils.roi.contour import (
    contours_from_mask as t_contours_from_mask)
from medicalimageanalysis_tpu.utils.convert import contour as jcontour
from medicalimageanalysis_tpu.utils.roi.contour import (
    contours_from_mask as j_contours_from_mask)

ROOT = Path(__file__).resolve().parents[1]
PLANES = ("Axial", "Coronal", "Sagittal")
SPACING = [0.9, 1.1, 2.5]
ORIGIN = [-10.0, 4.0, -30.0]
MATRIX = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])


@pytest.fixture(autouse=True)
def torch_env():
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    set_default_device(None)


def disc(shape, cy, cx, r):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def slices():
    """Named 2-D masks (H, W) uint8 covering where cv2 surprises."""
    H, W = 24, 30
    out = {}
    out["disc"] = disc((H, W), 11, 14, 8)
    out["annulus"] = disc((H, W), 12, 15, 10) & ~disc((H, W), 12, 15, 4)
    island = out["annulus"].copy()
    island[11:14, 14:17] = True                # an island in the hole
    out["island_in_hole"] = island
    nested = disc((H, W), 12, 15, 11) & ~disc((H, W), 12, 15, 8)
    nested |= disc((H, W), 12, 15, 6) & ~disc((H, W), 12, 15, 3)
    nested[12, 15] = True                      # ring, ring, dot
    out["nested_rings"] = nested
    edges = np.zeros((H, W), bool)
    edges[0, 3:9] = True                       # top row
    edges[H - 1, 10:20] = True                 # bottom row
    edges[4:12, 0] = True                      # left column
    edges[6:20, W - 1] = True                  # right column
    edges[0:3, W - 3:] = True                  # a corner block
    out["frame_edges"] = edges
    out["full"] = np.ones((H, W), bool)
    diag = np.zeros((H, W), bool)
    for k in range(8):
        diag[2 + k, 3 + k] = True              # a diagonal chain
        diag[2 + k, 20 - k] = True             # and an anti-diagonal
    diag[15, 4] = diag[16, 5] = diag[15, 6] = True   # a 'v' of 3 pixels
    out["diagonal_only"] = diag
    small = np.zeros((H, W), bool)
    small[3, 3] = True                         # one pixel
    small[3, 8:10] = True                      # two, horizontal
    small[8:10, 3] = True                      # two, vertical
    small[12, 12] = small[13, 13] = True       # two, diagonal
    small[20, 25] = small[19, 26] = True       # two, anti-diagonal
    small[0, 0] = True                         # one, in the corner
    out["one_and_two_pixel"] = small
    comb = np.zeros((H, W), bool)
    comb[2:20, 2:26:3] = True
    comb[2, 2:26] = True                       # a comb: long thin teeth
    out["comb"] = comb
    return {k: v.astype(np.uint8) for k, v in out.items()}


def cv2_external(m):
    found, _ = cv2.findContours(np.ascontiguousarray(m, np.uint8),
                                cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    return [c.reshape(-1, 2) for c in found]


def same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == np.int32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", list(slices()))
@pytest.mark.parametrize("value", [1, 255])
def test_tracer_equals_cv2_on_the_hard_cases(name, value):
    m = slices()[name] * np.uint8(value)
    same(trace_external(m), cv2_external(m))
    # the transposed and flipped slices, so every edge of the frame and
    # every direction of the chains is met
    for view in (m.T, m[::-1], m[:, ::-1]):
        v = np.ascontiguousarray(view)
        same(trace_external(v), cv2_external(v))


@pytest.mark.parametrize("seed", range(6))
def test_tracer_equals_cv2_on_random_masks(seed):
    r = np.random.default_rng(seed)
    stack = []
    for _ in range(40):
        H, W = r.integers(1, 26, size=2)
        p = r.uniform(0.1, 0.9)
        stack.append((r.random((H, W)) < p).astype(np.uint8))
        same(trace_external(stack[-1]), cv2_external(stack[-1]))
    # one call over a stack of equal slices
    block = (r.random((12, 31, 17)) < 0.45).astype(np.uint8)
    for got, m in zip(trace_external(block), block):
        same(got, cv2_external(m))


def test_tracer_handles_empty_and_degenerate_shapes():
    assert trace_external(np.zeros((5, 7), np.uint8)) == []
    assert trace_external(np.zeros((0, 4, 4), np.uint8)) == []
    for shape in ((1, 1), (1, 9), (9, 1)):
        m = np.ones(shape, np.uint8)
        same(trace_external(m), cv2_external(m))
    with pytest.raises(ValueError):
        trace_external(np.zeros((2, 2, 2, 2), np.uint8))


def volume_of(names, axis):
    """The named slices stacked along ``axis`` of a (Z, Y, X) mask, with
    an empty slice between each pair."""
    sl = slices()
    layers = []
    for n in names:
        layers += [sl[n], np.zeros_like(sl[n])]
    return np.moveaxis(np.stack(layers), 0, axis)


CASES = {"discs_annuli": ("disc", "annulus", "nested_rings"),
         "holes_islands": ("island_in_hole", "comb", "full"),
         "edges_small": ("frame_edges", "diagonal_only",
                         "one_and_two_pixel")}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("plane", PLANES)
def test_mask_to_contour_matches_jax(case, plane):
    axis = {"Axial": 0, "Coronal": 1, "Sagittal": 2}[plane]
    mask = volume_of(CASES[case], axis)
    t = tcontour.MaskToContour(mask, spacing=SPACING, origin=ORIGIN,
                               matrix=MATRIX, plane=plane.lower())
    j = jcontour.MaskToContour(mask, spacing=SPACING, origin=ORIGIN,
                               matrix=MATRIX, plane=plane.lower())
    t_pix, t_pos = t.create_contours()
    j_pix, j_pos = j.create_contours()
    same(t_pix, j_pix)
    assert len(t_pos) == len(j_pos) == len(t_pix) > 0
    for a, b in zip(t_pos, j_pos):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    # contours_from_mask: RETR_EXTERNAL on the mask as it is
    t_c = t_contours_from_mask(mask, plane=plane)
    j_c = j_contours_from_mask(mask, plane=plane)
    assert len(t_c) == len(j_c) > 0
    for a, b in zip(t_c, j_c):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


def round_trip(module, mask, plane):
    _, pos = module.MaskToContour(mask, spacing=SPACING, origin=ORIGIN,
                                  matrix=MATRIX,
                                  plane=plane.lower()).create_contours()
    return np.asarray(module.ContourToMask(
        contour_position=pos, spacing=SPACING, origin=ORIGIN,
        matrix=MATRIX, dimensions=list(mask.shape),
        plane=plane).create_mask())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("plane", PLANES)
def test_round_trip_equals_jax_and_reaches_a_fixed_point(case, plane):
    axis = {"Axial": 0, "Coronal": 1, "Sagittal": 2}[plane]
    mask = volume_of(CASES[case], axis)
    first = round_trip(tcontour, mask, plane)
    np.testing.assert_array_equal(first, round_trip(jcontour, mask, plane))
    second = round_trip(tcontour, first, plane)
    np.testing.assert_array_equal(second, first)       # fixed point
    # the XOR rasterizer keeps the annulus's hole through the trip
    if case == "discs_annuli":
        annulus = np.moveaxis(first, axis, 0)[2]
        assert annulus[12, 15] == 0 and annulus[12, 22] == 1


NO_CV2 = r"""
import importlib, pkgutil, sys
sys.modules["cv2"] = None                 # any 'import cv2' now fails
import numpy as np
import medicalimageanalysis_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.utils.convert.contour import MaskToContour
from medicalimageanalysis_torch.utils.roi.contour import contours_from_mask
set_default_device("cpu")
m = np.zeros((2, 9, 9), np.uint8)
m[0, 1:8, 1:8] = 1
m[0, 3:6, 3:6] = 0
pix, pos = MaskToContour(m, [1, 1, 1], [0, 0, 0], np.eye(3)).create_contours()
assert len(pix) == 2 and len(contours_from_mask(m)) == 1
print("ok")
"""


def test_port_traces_without_cv2():
    proc = subprocess.run([sys.executable, "-c", NO_CV2], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
