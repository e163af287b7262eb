"""The dose model's ROI gather from the mask crop kept on the device
(``Image._roi_mask_device``, ``Dose._roi_dose``) on the CPU, against the
whole-mask gather it replaced: the mask rebuilt on the host by
``roi.compute_mask()``, uploaded whole and used to index the whole
resampled dose. ``compute_roi_dose_array``'s values and coverage,
``compute_dvh_curve`` and ``evaluate_constraints`` are bit-equal for every
form a mask cache entry takes (pooled, a host entry, a non-binary raw
crop, an empty ROI, a mesh-only ROI, a ROI not registered under its name,
a ROI whose contours are rebound) on both coverage paths; the coverage
also equals a float64 count of every voxel on the host. Tolerance 0
throughout: the same resampled values are gathered, in the same order.
"""

import warnings

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.resample import (affine_resample,
                                                     compose_pixel_matrix)
from medicalimageanalysis_torch.structure import dose as tdose
from medicalimageanalysis_torch.structure import image as timage
from medicalimageanalysis_torch.structure.dose import Dose
from medicalimageanalysis_torch.structure.image import Image
from medicalimageanalysis_torch.structure.roi import Roi

SHAPE = (10, 32, 36)                   # CT (z, y, x)
ORIGIN = (-18.0, -16.0, -10.0)
SPACING = (1.0, 1.0, 2.0)
GOALS = ["Dmax <= 62Gy", "Dmin >= 10Gy", "Dmean >= 30Gy",
         "Dmedian <= 70Gy", "D95% >= 20Gy", "D50% >= 40Gy",
         "D0.05cc <= 61Gy", "D2cc <= 80Gy", "V20.5Gy <= 35%",
         "V40.3Gy >= 0.1cc"]
BOX_FACES = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                      [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                      [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])


def rot_z(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])


# (dose grid (Z, Y, X), spacing, origin, orientation; the coverage path):
# both grids leave part of every ROI outside
GRIDS = {
    "axis": ((10, 32, 36), (1.0, 1.0, 2.0), (-18.0, -16.0, -2.0),
             np.eye(3)),
    "general": ((10, 24, 24), (1.0, 1.0, 2.0), (-14.0, -10.0, -10.0),
                rot_z(30.0)),
}
CASES = ("pooled", "host", "raw", "empty", "mesh", "unregistered",
         "rebound")


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def circle(s, cx, cy, r, n=24):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a),
                     np.full(n, ORIGIN[2] + s * SPACING[2])], axis=1)


def box(lo, hi):
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    return np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0],
                     [x0, y1, z0], [x0, y0, z1], [x1, y0, z1],
                     [x1, y1, z1], [x0, y1, z1]], np.float64)


def plan_case(path):
    """A CT with three contoured ROIs (one with a hole) and the grid's
    dose, a smooth falloff from 60 Gy."""
    image = interop.image_from_arrays(np.zeros(SHAPE, np.int16), SPACING,
                                      ORIGIN, np.eye(3), "CT", "CT")
    interop.rois_from_numpy(image, {
        "PTV": [circle(s, 1.3, 2.1, 4.0 + s % 3) for s in range(3, 8)],
        "Ring": [circle(s, -2.0, 0.5, 11.0) for s in range(2, 7)]
        + [circle(s, -2.0, 0.5, 5.5, n=16) for s in range(2, 7)],
        "Cord": [circle(s, 6.0, -6.0, 2.6, n=12) for s in range(0, 9)],
    })
    shape, spacing, origin, matrix = GRIDS[path]
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    r2 = ((xx - shape[2] / 2) ** 2 + (yy - shape[1] / 2) ** 2
          + (2 * (zz - shape[0] / 2)) ** 2)
    gy = (5.0 + 55.0 * np.exp(-r2 / (2 * 7.0 ** 2))).astype(np.float32)
    dose = interop.dose_from_numpy(gy, spacing, origin, matrix, name="plan")
    return image, dose


def old_roi_dose(self, image_name, roi_name, device):
    """The gather before the mask crop: the whole mask rebuilt on the
    host, uploaded and used to index the whole resampled dose."""
    image = TData.image[image_name]
    A = compose_pixel_matrix(self.matrix, self.spacing, self.origin,
                             image.matrix, image.spacing, image.origin)
    resampled = affine_resample(np.asarray(self.array, np.float32), A,
                                image.array.shape, background=0.0,
                                device=device)
    inside = torch.as_tensor(image.rois[roi_name].compute_mask()) > 0
    Z, Y, X = inside.shape
    return resampled[inside], A, ((0, Z, 0, Y, 0, X), inside)


def host_coverage(dose, image, mask):
    """The share of the mask's voxels whose centre lies in the dose grid,
    each coordinate in float64 on the host."""
    A = compose_pixel_matrix(dose.matrix, dose.spacing, dose.origin,
                             image.matrix, image.spacing, image.origin)
    A = np.asarray(A, np.float64)
    zyx = np.argwhere(mask > 0).astype(np.float64)
    if not len(zyx):
        return 1.0
    x, y, z = zyx[:, 2], zyx[:, 1], zyx[:, 0]
    hi = np.asarray(dose.dimensions, np.float64)[::-1] - 0.5
    ok = np.ones(len(zyx), bool)
    for r in range(3):
        p = x * A[r, 0] + y * A[r, 1] + z * A[r, 2] + A[r, 3]
        ok &= (p >= -0.5) & (p <= hi[r])
    return ok.sum() / len(zyx)


def answers(dose, name):
    """compute_roi_dose_array's values and coverage, compute_dvh_curve and
    evaluate_constraints for one ROI."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # partial coverage
        values, coverage = dose.compute_roi_dose_array(
            "CT", name, return_coverage=True)
        curve = dose.compute_dvh_curve("CT", name)
        goals = dose.evaluate_constraints({name: GOALS}, image_name="CT")
    return values, coverage, curve, goals


def assert_equal_answers(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.float32
    assert type(got[1]) is float and got[1] == want[1]
    for g, w in zip(got[2], want[2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_equal(got[3], want[3])


def prepare(case, image):
    """The case's ROI and its cache entry; returns the ROI's key in
    ``image.rois``."""
    if case in ("pooled", "rebound"):
        image.compute_roi_masks()
        return "PTV" if case == "pooled" else "Ring"
    if case in ("host", "raw"):
        roi = image.rois["Ring"]
        mask = roi._compute_mask_impl()
        image._roi_mask_cache_put("Ring", roi,
                                  mask * (3 if case == "raw" else 1))
        assert image._roi_mask_cache["Ring"][4] is (case == "host")
        return "Ring"
    if case == "empty":
        # contours wholly off the grid: a contoured ROI with no voxel
        interop.rois_from_numpy(image, {"Off": [circle(s, 60.0, 60.0, 3.0)
                                                for s in range(2, 5)]})
        return "Off"
    if case == "mesh":
        interop.meshes_from_numpy(image, {"Shell": (
            box((-6.3, -7.2, -5.1), (5.7, 4.6, 3.3)), BOX_FACES)})
        assert image.rois["Shell"].contour_pixel is None
        return "Shell"
    # unregistered: the ROI under "Alias" is named after no ROI
    position = image.rois["PTV"].contour_position
    image.rois["Alias"] = Roi(image, position=position, name="PTV copy",
                              plane="Axial")
    return "Alias"


@pytest.mark.parametrize("path", sorted(GRIDS))
@pytest.mark.parametrize("case", CASES)
def test_crop_gather_equals_the_whole_mask_gather(case, path, monkeypatch):
    image, dose = plan_case(path)
    name = prepare(case, image)
    roi = image.rois[name]
    if case == "rebound":
        first = answers(dose, name)
        roi.contour_pixel = roi.contour_pixel[:3]
    before, cov_before = dict(timage.MASKS), dict(tdose.COVERAGE)
    got = answers(dose, name)
    moved = {k: timage.MASKS[k] - before[k]
             for k in ("device_gets", "payload_uploads")}
    covered = {k: tdose.COVERAGE[k] - cov_before[k] for k in cov_before}
    mask = roi.compute_mask()
    monkeypatch.setattr(Dose, "_roi_dose", old_roi_dose)
    want = answers(dose, name)
    assert_equal_answers(got, want)
    assert got[1] == host_coverage(dose, image, mask)

    if case == "empty":
        assert not mask.any() and got[0].size == 0 and got[1] == 1.0
        assert covered == {"axis": 0, "general": 0}
    else:
        assert mask.any() and 0.0 < got[1] < 1.0
        # compute_roi_dose_array's and evaluate_constraints' evaluations
        assert covered == {"axis": 0, "general": 0, path: 2}
    # three gathers: the values, the curve and the goals
    assert moved == {"pooled": {"device_gets": 3, "payload_uploads": 0},
                     "host": {"device_gets": 2, "payload_uploads": 1},
                     "raw": {"device_gets": 2, "payload_uploads": 1},
                     "empty": {"device_gets": 0, "payload_uploads": 0},
                     "mesh": {"device_gets": 2, "payload_uploads": 1},
                     "unregistered": {"device_gets": 0,
                                      "payload_uploads": 0},
                     "rebound": {"device_gets": 2,
                                 "payload_uploads": 1}}[case]
    if case == "unregistered":
        assert "Alias" not in image._roi_mask_cache
    if case == "rebound":
        # the rebound contours' mask, not the pooled entry's
        assert got[0].size < first[0].size


def test_device_mask_returns_the_entry_bbox_and_crop():
    """The accessor's (bbox, crop) is the whole mask's box and its
    contents, for a pooled entry and a host entry alike, and the crop
    lives on the asked device."""
    image, _ = plan_case("axis")
    image.compute_roi_masks()
    for name, roi in image.rois.items():
        mask = roi.compute_mask()
        zs, ys, xs = (np.flatnonzero(mask.any(axis=a))
                      for a in ((1, 2), (0, 2), (0, 1)))
        box_ = (zs[0], zs[-1] + 1, ys[0], ys[-1] + 1, xs[0], xs[-1] + 1)
        for entry in ("pooled", "host"):
            if entry == "host":
                image._roi_mask_cache_put(name, roi, mask)
            bbox, crop = image._roi_mask_device(name, roi, "cpu")
            assert bbox == box_ and crop.dtype == torch.bool
            assert crop.device.type == "cpu"
            z0, z1, y0, y1, x0, x1 = bbox
            np.testing.assert_array_equal(crop.numpy(),
                                          mask[z0:z1, y0:y1, x0:x1] > 0)
            assert not mask[:z0].any() and not mask[z1:].any()


def test_pooled_goals_and_curves_never_rebuild_a_host_mask(monkeypatch):
    """A pooled structure set's goals and curves take every mask from the
    crop kept on the device: no host rebuild (``_roi_mask_cache_get``
    with ``reconstruct``) and no ``np.unpackbits`` run, two device gets a
    ROI and no upload."""
    image, dose = plan_case("axis")
    image.compute_roi_masks()
    real_get = Image._roi_mask_cache_get

    def no_rebuild(self, name, roi, reconstruct=True):
        if reconstruct:
            raise AssertionError(f"host rebuild of {name}'s mask")
        return real_get(self, name, roi, reconstruct=False)

    def refuse(*args, **kwargs):
        raise AssertionError("np.unpackbits on the host")

    monkeypatch.setattr(Image, "_roi_mask_cache_get", no_rebuild)
    monkeypatch.setattr(np, "unpackbits", refuse)
    before = dict(timage.MASKS)
    names = list(image.rois)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # partial coverage
        goals = dose.evaluate_constraints({n: GOALS for n in names},
                                          image_name="CT")
    curves = {n: dose.compute_dvh_curve("CT", n) for n in names}
    assert len(goals) == len(GOALS) * len(names)
    assert all(curves[n][1].shape == (300,) for n in names)
    assert timage.MASKS["device_gets"] - before["device_gets"] == \
        2 * len(names)
    assert timage.MASKS["payload_uploads"] == before["payload_uploads"]
