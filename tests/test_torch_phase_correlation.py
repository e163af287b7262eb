"""FFT phase correlation, ``Rigid.compute_phase_correlation`` and
``Rigid.auto_register`` through both packages, on the CPU, on the
fixtures of tests/test_phase_correlation.py.

Tolerances:
- Unwindowed, one pass: the shift is exact in both (1e-5 voxel), the
  response within 1e-3 (float32 rounding of a peak near 1).
- Windowed and iterated: within 0.03 voxel of the JAX package's shift,
  the response within 0.03. The normalised cross-power divides every
  frequency by its own magnitude, so frequencies where the smooth
  fixtures carry almost no energy keep unit weight and the last bits of
  the FFT decide them: the JAX package's own shift moves by 2.3e-3 voxel
  when one input moves by 1 ulp, and ``torch.fft`` and XLA's FFT differ
  by far more than 1 ulp (the largest difference measured on these
  fixtures is 0.027 voxel; ROADMAP.md queue 3). Both stay within the JAX
  tests' own accuracy bounds to the true shift.
- ``auto_register``: both meet tests/test_phase_correlation.py's bounds
  (1 degree, 1 mm at the centre) and agree with each other within 0.2 mm
  at the centre and 0.1 degree (float32 descents of 125 steps).
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.registration.phase_correlation import (
    phase_correlation as tpc)
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.ops.registration.phase_correlation import (
    phase_correlation as jpc)

SHIFT_TOL_VOX = 0.03
RESPONSE_TOL = 0.03


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    JData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    JData.clear()
    set_default_device(None)


def smooth_volume(shape=(16, 32, 32), seed=0):
    from medicalimageanalysis_tpu.ops.filters import gaussian_filter
    rng = np.random.default_rng(seed)
    return np.asarray(gaussian_filter(
        rng.normal(0, 100, shape).astype(np.float32), 2.0))


def blob(cz, cy, cx):
    zz, yy, xx = np.mgrid[0:20, 0:32, 0:32].astype(np.float64)
    return np.exp(-(((zz - cz) / 2.5) ** 2 + ((yy - cy) / 4.0) ** 2
                    + ((xx - cx) / 3.0) ** 2)).astype(np.float32)


def _roll(seed, shift):
    f = smooth_volume(seed=seed)
    return f, np.roll(f, shift, axis=(0, 1, 2)), np.asarray(shift, float)


# (fixed, moving, true shift (z, y, x) voxels, kwargs, accuracy to truth)
PC_CASES = {
    "roll_windowed": lambda: (*_roll(0, (5, -7, 3)), {}, 0.05),
    "roll_unwindowed": lambda: (*_roll(0, (5, -7, 3)),
                                {"window": False}, 0.01),
    "roll_one_pass": lambda: (*_roll(2, (2, 4, -6)), {"iterations": 1},
                              1.5),
    "roll_ten_passes": lambda: (*_roll(2, (2, 4, -6)), {"iterations": 10},
                                0.05),
    "subvoxel_blob": lambda: (blob(10.0, 15.0, 16.0),
                              blob(10.4, 14.7, 16.25),
                              np.array([0.4, -0.3, 0.25]), {}, 0.1),
}


@pytest.mark.parametrize("case", sorted(PC_CASES))
def test_phase_correlation_matches_jax(case):
    fixed, moving, truth, kw, accuracy = PC_CASES[case]()
    got, response = tpc(fixed, moving, device="cpu", **kw)
    ref, jresponse = jpc(fixed, moving, **kw)
    exact = kw.get("window", True) is False
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 if exact else SHIFT_TOL_VOX)
    assert abs(response - jresponse) <= (1e-3 if exact else RESPONSE_TOL)
    np.testing.assert_allclose(got, truth, atol=accuracy)
    assert got.dtype == np.float64 and isinstance(response, float)


def test_phase_correlation_spacing_scales_to_mm():
    fixed, moving, truth = _roll(2, (2, 4, -6))
    sp = [0.5, 1.0, 2.5]
    got, _ = tpc(fixed, moving, spacing_xyz=sp, device="cpu")
    ref, _ = jpc(fixed, moving, spacing_xyz=sp)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=SHIFT_TOL_VOX * max(sp))
    np.testing.assert_allclose(got, truth * np.asarray(sp[::-1]), atol=0.2)


def test_phase_correlation_validates_shapes():
    for a, b in ((np.zeros((4, 4, 4)), np.zeros((4, 4, 5))),
                 (np.zeros((4, 4)), np.zeros((4, 4)))):
        with pytest.raises(ValueError, match="matching"):
            tpc(a, b, device="cpu")
        with pytest.raises(ValueError, match="matching"):
            jpc(a, b)


def bump_base(rng, shape):
    Z, Y, X = shape
    base = np.zeros(shape, np.float32)
    zz, yy, xx = np.mgrid[0:Z, 0:Y, 0:X]
    base += 900 * np.exp(-(((zz - Z / 2) / (Z / 4)) ** 2
                           + ((yy - 0.42 * Y) / (Y / 6)) ** 2
                           + ((xx - 0.54 * X) / (X / 8)) ** 2))
    base += 300 * np.exp(-(((zz - 5) / 2.0) ** 2 + ((yy - 0.67 * Y) / 4.0)
                           ** 2 + ((xx - 0.3 * X) / 4.0) ** 2))
    return base + rng.normal(0, 5, shape)


def read_pair(tmp_path, base, moved, thickness):
    write_ct_series(tmp_path / "a", base.astype(np.int16), spacing=(1, 1),
                    thickness=thickness)
    write_ct_series(tmp_path / "b", moved.astype(np.int16), spacing=(1, 1),
                    thickness=thickness, modality="MR")
    jmia.read_dicoms(folder_path=str(tmp_path), clear=True)
    tmia.read_dicoms(folder_path=str(tmp_path), clear=True, device="cpu")
    ct = [n for n in JData.image_list if JData.image[n].modality == "CT"][0]
    mr = [n for n in JData.image_list if JData.image[n].modality == "MR"][0]
    return ct, mr


@pytest.mark.parametrize("shift_vox", [(2, 5, -6), (-1, -4, 7)])
def test_rigid_compute_phase_correlation_matches_jax(tmp_path, shift_vox):
    rng = np.random.default_rng(1234)
    base = bump_base(rng, (12, 32, 32))
    ct, mr = read_pair(tmp_path, base, np.roll(base, shift_vox, (0, 1, 2)),
                       2.0)
    t, j = tmia.Rigid(ct, mr), jmia.Rigid(ct, mr)
    info, jinfo = t.compute_phase_correlation(), j.compute_phase_correlation()
    sp = np.array([1.0, 1.0, 2.0])
    np.testing.assert_allclose(info["shift_mm"], jinfo["shift_mm"], rtol=0,
                               atol=SHIFT_TOL_VOX * sp.max())
    assert abs(info["response"] - jinfo["response"]) <= RESPONSE_TOL
    expected = np.asarray(shift_vox[::-1], float) * sp
    np.testing.assert_allclose(info["shift_mm"], expected, atol=0.3)
    np.testing.assert_allclose(t.matrix, j.matrix, rtol=0,
                               atol=SHIFT_TOL_VOX * sp.max())
    np.testing.assert_allclose(t.matrix[:3, :3], np.eye(3), atol=1e-12)
    assert t.misc["phase_correlation"] == info
    # update=False leaves the matrix alone
    t2 = tmia.Rigid(ct, mr)
    before = t2.matrix.copy()
    again = t2.compute_phase_correlation(update=False)
    np.testing.assert_array_equal(t2.matrix, before)
    np.testing.assert_allclose(again["shift_mm"], info["shift_mm"],
                               atol=1e-12)


def moved_pair(tmp_path, pose):
    """tests/test_phase_correlation.py's pair: the reference bumps and the
    same volume moved by ``pose(center)`` (reference -> moving, given the
    volume centre), written as a CT and an MR on one grid. Returns
    ((ct, mr) names, centre, the 4x4)."""
    from medicalimageanalysis_tpu.ops.resample import (
        affine_resample, compose_pixel_matrix)

    rng = np.random.default_rng(1234)
    base = bump_base(rng, (16, 48, 48))
    write_ct_series(tmp_path / "a", base.astype(np.int16), spacing=(1, 1),
                    thickness=1.0)
    jmia.read_dicoms(folder_path=str(tmp_path / "a"))
    ref = JData.image[JData.image_list[0]]
    center = np.asarray(ref.compute_center(), np.float64)
    M_true = pose(center)
    A = compose_pixel_matrix(ref.matrix, ref.spacing, ref.origin,
                             ref.matrix, ref.spacing, ref.origin,
                             phys_transform=np.linalg.inv(M_true))
    moved = np.asarray(affine_resample(base, A, base.shape, background=0.0))
    return read_pair(tmp_path, base, moved, 1.0), center, M_true


def centre_and_angle(got, want, center):
    c = np.append(center, 1.0)
    err_mm = np.linalg.norm((got @ c)[:3] - (want @ c)[:3])
    ang = np.rad2deg(np.arccos(np.clip(
        (np.trace(got[:3, :3] @ want[:3, :3].T) - 1) / 2, -1, 1)))
    return err_mm, ang


def test_auto_register_ladder_matches_jax(tmp_path):
    """4 degrees about the volume centre and (12, -9, 4) mm: beyond the
    plain descent's capture range."""
    from scipy.spatial.transform import Rotation

    def pose(center):
        M = np.eye(4)
        M[:3, :3] = Rotation.from_euler("z", 4, degrees=True).as_matrix()
        M[:3, 3] = center - M[:3, :3] @ center + [12.0, -9.0, 4.0]
        return M

    (ct, mr), center, M_true = moved_pair(tmp_path, pose)
    t, j = tmia.Rigid(ct, mr), jmia.Rigid(ct, mr)
    t.auto_register(metric="mse")
    j.auto_register(metric="mse")
    assert set(t.misc["auto_register"]) >= set(j.misc["auto_register"])
    assert t.misc["auto_register"]["metric"] == "mse"
    np.testing.assert_allclose(t.misc["auto_register"]["center"],
                               j.misc["auto_register"]["center"], atol=1e-9)
    for got in (t.matrix, j.matrix):
        err_mm, ang = centre_and_angle(got, M_true, center)
        assert err_mm < 1.0 and ang < 1.0
    err_mm, ang = centre_and_angle(t.matrix, j.matrix, center)
    assert err_mm < 0.2 and ang < 0.1


def test_auto_register_nonrigid_warm_start_matches_jax(tmp_path):
    """A prior scaled fit seeds the descent through its nearest rotation,
    with a warning, in both packages."""
    def pose(center):
        M = np.eye(4)
        M[:3, 3] = [14.0, -10.0, 4.0]
        return M

    (ct, mr), center, M_true = moved_pair(tmp_path, pose)
    M0 = np.eye(4)
    M0[:3, :3] *= 1.04
    M0[:3, 3] = M_true[:3, 3]
    results = []
    for rigid in (tmia.Rigid(ct, mr), jmia.Rigid(ct, mr)):
        rigid.matrix = M0.copy()
        with pytest.warns(UserWarning, match="not rigid"):
            rigid.auto_register(metric="mse", use_phase_correlation=False)
        err_mm, _ = centre_and_angle(rigid.matrix, M_true, center)
        assert err_mm < 1.0
        results.append(rigid.matrix)
    err_mm, ang = centre_and_angle(results[0], results[1], center)
    assert err_mm < 0.2 and ang < 0.1
