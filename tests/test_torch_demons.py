"""Parity of the port's demons (``ops/registration/demons.py``, plain twins
on the CPU) with the JAX package's, for every method and both forces.

Demons trajectories fork on sub-ulp differences (the |diff| > threshold
gate is bistable, and the peak normalisation compounds rounding every
iteration), so the fields are not compared element by element: the
port's warp residual must sit within 2 % of JAX's, and the two fields
within 0.15 mm of each other after 8 iterations (the bound the JAX
package's hardware lane holds its sharded demons to)."""

import numpy as np
import pytest
import torch

from medicalimageanalysis_tpu.ops.registration.demons import (
    demons_registration as j_demons)
from medicalimageanalysis_tpu.ops.registration.dvf import (
    warp_volume as j_warp)
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import resample as tresample
from medicalimageanalysis_torch.ops.registration import demons as tdemons
from medicalimageanalysis_torch.ops.registration import bspline as tbspline

SHAPE = (16, 24, 32)
SPACING = (1.2, 1.1, 2.0)            # [sx, sy, sz] mm


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def pair():
    """Two smooth blobs in HU-like units, the moving pair displaced by
    about one voxel in x, y and z."""
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]] \
        .astype(np.float32)

    def blob(cz, cy, cx):
        return 1000 * np.exp(-(((zz - cz) / 3.5) ** 2 + ((yy - cy) / 5) ** 2
                               + ((xx - cx) / 6) ** 2))

    fixed = blob(8, 12, 16) + 0.5 * blob(5, 8, 10)
    moving = blob(8, 12.8, 17.5) + 0.5 * blob(5.4, 8.5, 11)
    return fixed.astype(np.float32), moving.astype(np.float32)


@pytest.mark.parametrize("forces", ["ssd", "lncc"])
@pytest.mark.parametrize("method", ["demons", "fast", "diffeomorphic",
                                    "biomechanical", "syn"])
def test_demons_matches_jax(method, forces):
    fixed, moving = pair()
    kw = dict(method=method, iterations=8, forces=forces)
    ref = j_demons(fixed, moving, SPACING, **kw)
    out = tdemons.demons_registration(fixed, moving, SPACING, device="cpu",
                                      **kw)
    assert out.shape == SHAPE + (3,) and np.isfinite(out).all()

    def residual(field):
        return np.abs(np.asarray(j_warp(moving, field, SPACING))
                      - fixed).mean()

    before = np.abs(moving - fixed).mean()
    r_port, r_jax = residual(out), residual(ref)
    assert r_jax < 0.5 * before                       # the solver moved
    assert abs(r_port - r_jax) <= 0.02 * r_jax
    assert np.abs(out - ref).max() < 0.15


def test_pyramid_levels_and_info():
    """A (4, 2, 1) pyramid against JAX, and the per-level report."""
    fixed, moving = pair()
    kw = dict(method="fast", iterations=6, pyramid=(4, 2))
    info = {}
    out = tdemons.demons_registration(fixed, moving, SPACING, device="cpu",
                                      info=info, **kw)
    ref = j_demons(fixed, moving, SPACING, **kw)
    assert info["level_shapes"] == [(4, 6, 8), (8, 12, 16), SHAPE]
    assert len(info["level_seconds"]) == 3
    assert np.abs(out - ref).max() < 0.15


def test_separable_resample_matches_jax():
    from medicalimageanalysis_tpu.ops.resample import separable_resample

    fixed, _ = pair()
    for out_shape in ((8, 12, 16), (20, 30, 40)):
        out = tresample.separable_resample(fixed, out_shape).numpy()
        ref = np.asarray(separable_resample(fixed, out_shape))
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def test_invalid_arguments_raise():
    fixed, moving = pair()
    with pytest.raises(ValueError, match="forces"):
        tdemons.demons_registration(fixed, moving, forces="ncc")
    with pytest.raises(ValueError, match="method"):
        tdemons.demons_registration(fixed, moving, method="elastic")


@pytest.mark.parametrize("entry", ["smooth_field", "box_sum", "densify",
                                   "separable_resample", "demons_lncc"])
def test_contractions_run_in_full_float32(monkeypatch, entry):
    """A caller that turned TF32 on still gets full-float32 field
    smoothing, LNCC box sums, B-spline densify and pyramid resamples, and
    gets its setting back."""
    seen = []
    einsum = torch.einsum

    def recording_einsum(*args):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cudnn.allow_tf32))
        return einsum(*args)

    monkeypatch.setattr(torch, "einsum", recording_einsum)
    vol = torch.rand(4, 5, 6)
    mats = [torch.rand(n, n) for n in (4, 5, 6)]
    prior = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        if entry == "smooth_field":
            tdemons._smooth_field(torch.rand(3, 4, 5, 6), *mats)
        elif entry == "box_sum":
            tdemons._box_sum(vol, *mats)
        elif entry == "densify":
            tbspline._bspline_fit(
                vol, vol, torch.ones_like(vol), None, torch.rand(4, 3),
                torch.rand(5, 3), torch.rand(6, 3), torch.ones(3), 0.1, 1)
        elif entry == "separable_resample":
            tresample.separable_resample(vol, (2, 3, 3))
        else:
            tdemons.demons_registration(vol.numpy(), vol.numpy(),
                                        forces="lncc", iterations=1,
                                        device="cpu")
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prior)
    assert seen and set(seen) == {("highest", False)}
    assert after == "high"
