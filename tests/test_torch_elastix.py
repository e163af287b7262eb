"""The elastix-parity B-spline (``elastix_registration``: the level
pyramid warm-started by ``base_mm``; ``_elastix_staged``: linear stages
seeded by phase correlation, then the B-spline) and
``DeformableTorch.elastix`` through both packages, on the CPU, on the
fixtures of tests/test_deformable_dose.py.

Tolerances (ROADMAP.md's watch list: compare residuals, not fields):
- the residual ratio (mean |warped - fixed| over mean |moving - fixed|
  inside the band the JAX test scores) within 0.02 of the JAX
  package's, and each at least as good as the JAX test demands;
- for mean squares, whose fit does not fork: losses within 1e-4
  relative on the first level and the field within 0.05 mm, the bounds
  of tests/test_torch_bspline.py.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter as _gf
from scipy.ndimage import map_coordinates as _mc

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.registration import bspline as tbspline
from medicalimageanalysis_torch.utils.deformable.torch_backend import (
    DeformableTorch)
from medicalimageanalysis_tpu.ops.registration import bspline as jbspline
from medicalimageanalysis_tpu.ops.registration.dvf import warp_volume
from medicalimageanalysis_tpu.utils.deformable.jax_backend import (
    DeformableJAX)
from test_deformable_dose import make_blob

RATIO_TOL = 0.02


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def textured(seed):
    anat = _gf(np.random.default_rng(seed).normal(size=(16, 48, 48)),
               (1.5, 3, 3)).astype(np.float32)
    return (anat - anat.min()) / (anat.max() - anat.min()) * 1000


def ratio(dvf, moving, fixed, inner):
    warped = np.asarray(warp_volume(moving, dvf, (1, 1, 1)))
    return float(np.abs(warped - fixed)[inner].mean()
                 / np.abs(moving - fixed)[inner].mean())


def both(*args, **kw):
    dvf_t, loss_t = tbspline.elastix_registration(*args, device="cpu", **kw)
    dvf_j, loss_j = jbspline.elastix_registration(*args, **kw)
    assert dvf_t.shape == np.asarray(dvf_j).shape and dvf_t.dtype == \
        np.float32
    assert loss_t.shape == np.asarray(loss_j).shape
    return dvf_t, loss_t, np.asarray(dvf_j), np.asarray(loss_j)


def test_elastix_mi_cross_modality_matches_jax():
    """An inverted-contrast 'MR' of a 2-voxel y shift, two MI levels."""
    fixed = textured(3)
    moving_ct = np.roll(fixed, shift=2, axis=1)
    moving_mr = (moving_ct.max() - moving_ct) * 0.37 + 11.0
    dvf_t, loss_t, dvf_j, loss_j = both(
        fixed, moving_mr, (1, 1, 1), metric="mi", bins=32, resolutions=2,
        final_grid_spacing=12.0, iterations=150, lr=0.2)
    inner = np.s_[2:-2, 4:-4, 4:-4]
    r_t = ratio(dvf_t, moving_ct, fixed, inner)
    r_j = ratio(dvf_j, moving_ct, fixed, inner)
    assert abs(r_t - r_j) <= RATIO_TOL, (r_t, r_j)
    assert r_t < 0.05 and loss_t[-1] < loss_t[0]


@pytest.mark.parametrize("pm", [
    {"Metric": ["AdvancedMeanSquares"], "NumberOfHistogramBins": ["16"],
     "NumberOfResolutions": ["2"], "FinalGridSpacingInPhysicalUnits": ["8"],
     "MaximumNumberOfIterations": ["60"]},
    {"Metric": "AdvancedMeanSquares", "NumberOfResolutions": "3",
     "FinalGridSpacingInPhysicalUnits": "6",
     "MaximumNumberOfIterations": "20"}], ids=["lists", "scalars"])
def test_elastix_parameter_map_matches_jax(pm):
    """Elastix-style maps (one-element string lists or plain values), mean
    squares: the first level's losses within 1e-4 relative, the field
    within 0.05 mm, the residual within 0.02."""
    fixed = make_blob().astype(np.float32) / 1000.0
    moving = np.roll(fixed, shift=1, axis=2)
    dvf_t, loss_t, dvf_j, loss_j = both(fixed, moving, (1, 1, 1),
                                        parameter_map=pm)
    steps = int(np.ravel([pm["MaximumNumberOfIterations"]])[0])
    np.testing.assert_allclose(loss_t[:steps], loss_j[:steps], rtol=1e-4)
    assert np.abs(dvf_t - dvf_j).max() < 0.05
    inner = np.s_[1:-1, 2:-2, 2:-2]
    assert abs(ratio(dvf_t, moving, fixed, inner)
               - ratio(dvf_j, moving, fixed, inner)) <= RATIO_TOL


def test_elastix_with_masks_matches_jax():
    """A fixed mask and a moving mask: the levels downsample both, and
    the moving mask warps with the image (ITK semantics)."""
    fixed = make_blob().astype(np.float32) / 1000.0
    moving = np.roll(fixed, shift=1, axis=2)
    fmask = (fixed > 0.1).astype(np.float32)
    mmask = (moving > 0.1).astype(np.float32)
    dvf_t, loss_t, dvf_j, loss_j = both(
        fixed, moving, (1, 1, 1), metric="mse", resolutions=2,
        final_grid_spacing=8.0, iterations=30, lr=0.25, fixed_mask=fmask,
        moving_mask=mmask)
    np.testing.assert_allclose(loss_t[:30], loss_j[:30], rtol=1e-4)
    assert np.abs(dvf_t - dvf_j).max() < 0.05


def staged_pair():
    """tests/test_deformable_dose.py's staged case: 6 degrees, a
    (14, 6)-voxel offset and a sinusoidal y deformation, inverted
    contrast."""
    fixed = textured(5)
    th = np.deg2rad(6.0)
    cz, cy, cx = [(s - 1) / 2.0 for s in fixed.shape]
    zz, yy, xx = np.mgrid[0:16, 0:48, 0:48].astype(np.float64)
    xr = np.cos(th) * (xx - cx) - np.sin(th) * (yy - cy) + cx + 6.0
    yr = (np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy) + cy + 14.0
          + 1.5 * np.sin(2 * np.pi * xx / 48.0))
    moving_ct = _mc(fixed, [zz, yr, xr], order=1, mode="nearest") \
        .astype(np.float32)
    moving_mr = (moving_ct.max() - moving_ct) * 0.41 + 7.0
    return fixed, moving_ct, moving_mr


STAGES = [
    {"Transform": ["EulerTransform"],
     "Metric": ["AdvancedMattesMutualInformation"],
     "NumberOfResolutions": ["3"], "MaximumNumberOfIterations": ["180"]},
    {"Transform": ["BSplineTransform"],
     "Metric": ["AdvancedMattesMutualInformation"],
     "NumberOfHistogramBins": ["32"], "NumberOfResolutions": ["2"],
     "FinalGridSpacingInPhysicalUnits": ["12"],
     "MaximumNumberOfIterations": ["100"]},
]


def test_elastix_staged_matches_jax():
    """The Euler stage, seeded by phase correlation of the gradient
    magnitudes, then the B-spline on the resampled moving image: the
    composed field's residual within 0.02 of the JAX package's."""
    fixed, moving_ct, moving_mr = staged_pair()
    info = {}
    dvf_t, loss_t = tbspline.elastix_registration(
        fixed, moving_mr, (1, 1, 1), parameter_map=STAGES, metric="mi",
        device="cpu", info=info)
    dvf_j, loss_j = jbspline.elastix_registration(
        fixed, moving_mr, (1, 1, 1), parameter_map=STAGES, metric="mi")
    assert loss_t.shape == np.asarray(loss_j).shape
    assert [s["transform"] for s in info["stages"]] == \
        ["EulerTransform", "BSplineTransform"]
    assert info["stages"][0]["seeded"]
    inner = np.s_[2:-2, 18:-2, 10:-2]
    r_t = ratio(dvf_t, moving_ct, fixed, inner)
    r_j = ratio(np.asarray(dvf_j), moving_ct, fixed, inner)
    assert abs(r_t - r_j) <= RATIO_TOL, (r_t, r_j)
    assert r_t < 0.2


def test_elastix_staged_seed_matches_jax():
    """The linear stage's seed: phase correlation of the two gradient
    magnitudes (float64 central differences, within 1e-15 relative of
    numpy's), as the JAX package takes it."""
    from medicalimageanalysis_torch.ops.registration.phase_correlation \
        import phase_correlation as tpc
    from medicalimageanalysis_tpu.ops.registration.phase_correlation \
        import phase_correlation as jpc

    fixed, _, moving_mr = staged_pair()

    def gmag(a):
        gz, gy, gx = np.gradient(np.asarray(a, np.float64))
        return np.sqrt(gz * gz + gy * gy + gx * gx)

    gm_t = tbspline._gradient_magnitude64(torch.from_numpy(fixed))
    np.testing.assert_allclose(gm_t.numpy(), gmag(fixed), rtol=1e-15)
    shift, resp = tpc(gm_t, tbspline._gradient_magnitude64(
        torch.from_numpy(moving_mr)), spacing_xyz=(1, 1, 1))
    jshift, jresp = jpc(gmag(fixed), gmag(moving_mr), spacing_xyz=(1, 1, 1))
    np.testing.assert_allclose(shift, jshift, atol=0.03)
    assert abs(resp - jresp) <= 0.03


def test_elastix_staged_validation_and_shapes_like_jax():
    fixed = make_blob().astype(np.float32)
    for stages, match in (
            ([{"Transform": ["Warp"]}], "unsupported Transform"),
            ([{"Transform": ["BSplineTransform"]}] * 2, "at most one"),
            ([{"Transform": ["BSplineTransform"]},
              {"Transform": ["EulerTransform"]}], "must be last")):
        for fn in (tbspline.elastix_registration,
                   jbspline.elastix_registration):
            with pytest.raises(ValueError, match=match):
                fn(fixed, fixed, (1, 1, 1), parameter_map=stages)
    # differing grids: the seed is skipped, the descent runs
    fixed = make_blob(shape=(8, 24, 24)).astype(np.float32)
    moving = np.pad(np.roll(fixed, 1, axis=2), ((0, 0), (0, 2), (0, 2)))
    stages = [{"Transform": ["EulerTransform"], "NumberOfResolutions": ["2"],
               "MaximumNumberOfIterations": ["30"]},
              {"Transform": ["BSplineTransform"],
               "NumberOfResolutions": ["1"],
               "FinalGridSpacingInPhysicalUnits": ["8"],
               "MaximumNumberOfIterations": ["20"]}]
    dvf, losses = tbspline.elastix_registration(
        fixed, moving, (1, 1, 1), parameter_map=stages, metric="mse",
        device="cpu")
    jdvf, jlosses = jbspline.elastix_registration(
        fixed, moving, (1, 1, 1), parameter_map=stages, metric="mse")
    assert dvf.shape == fixed.shape + (3,) and np.isfinite(dvf).all()
    assert losses.shape == np.asarray(jlosses).shape
    assert np.abs(dvf - np.asarray(jdvf)).max() < 0.05


@pytest.mark.parametrize("metric", ["Intensity", "MI"])
def test_backend_elastix_matches_jax(metric):
    """DeformableTorch.elastix against DeformableJAX.elastix: the
    reference API's switch (mean squares for 'Intensity', else MI)."""
    fixed = textured(7)
    moving = np.roll(fixed, shift=1, axis=2)
    outs = []
    for backend in (DeformableTorch(device="cpu"), DeformableJAX()):
        backend.create_volume(fixed, (0, 0, 0), (1, 1, 1), np.eye(3))
        backend.create_volume(moving, (0, 0, 0), (1, 1, 1), np.eye(3),
                              reference=False)
        outs.append(backend.elastix(metric=metric, resolution=2, spacing=12,
                                    iterations=40, crop=0))
    t, j = outs
    assert t["array"].shape == np.asarray(j["array"]).shape \
        == fixed.shape + (3,)
    np.testing.assert_array_equal(t["origin"], j["origin"])
    inner = np.s_[2:-2, 4:-4, 4:-4]
    assert abs(ratio(t["array"], moving, fixed, inner)
               - ratio(np.asarray(j["array"]), moving, fixed, inner)) \
        <= RATIO_TOL
