"""Parity of the port's DVF primitives (``ops/registration/dvf.py``, plain
twins on the CPU) with the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)

from medicalimageanalysis_tpu.ops.registration import dvf as jdvf
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.registration import dvf as tdvf

SHAPE = (10, 14, 18)
SPACING = (1.2, 0.9, 2.5)            # [sx, sy, sz] mm


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def smooth_field_mm(seed, amp=2.0):
    """A smooth (Z, Y, X, 3) mm field whose inverse the fixed point
    reaches (displacement gradient well below 1)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]] \
        .astype(np.float32)
    a = rng.uniform(0, 6.28, 3)
    return np.stack([amp * np.sin(yy / 5 + a[0]),
                     amp * np.cos(xx / 6 + a[1]),
                     0.8 * amp * np.sin(zz / 4 + a[2])], -1) \
        .astype(np.float32)


def blob_volume(seed):
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]] \
        .astype(np.float32)
    vol = 800 * np.exp(-((zz - 5) ** 2 / 9 + (yy - 7) ** 2 / 16
                         + (xx - 9) ** 2 / 25))
    return (vol + rng.normal(0, 5, SHAPE)).astype(np.float32)


def close(port, jax_out, rtol=1e-5):
    """rtol 1e-5, with an absolute floor of 1e-5 of the largest value for
    the entries near zero, where a relative bound means nothing."""
    ref = np.asarray(jax_out)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_warp_volume_matches_jax():
    vol, d = blob_volume(1), smooth_field_mm(2)
    out = tdvf.warp_volume(vol, d, SPACING, background=-5.0, device="cpu")
    assert isinstance(out, torch.Tensor)
    ref = np.asarray(jdvf.warp_volume(vol, d, SPACING, background=-5.0))
    assert (ref == -5.0).any()
    close(out.numpy(), ref)


def test_invert_dvf_matches_jax_and_inverts():
    d = smooth_field_mm(3)
    inv = tdvf.invert_dvf(d, SPACING, device="cpu")
    assert isinstance(inv, np.ndarray) and inv.shape == d.shape
    close(inv, jdvf.invert_dvf(d, SPACING))
    # a tensor in gives a tensor out, with the same values
    inv_t = tdvf.invert_dvf(torch.from_numpy(d), SPACING)
    np.testing.assert_array_equal(inv_t.numpy(), inv)
    # the fixed point v = -d(x + v(x)) makes (id + d) o (id + v) = id,
    # away from the border where samples leave the grid
    back = tdvf.compose_dvf(d, inv, SPACING, device="cpu")
    assert np.abs(back[3:-3, 3:-3, 3:-3]).max() < 1e-3


def test_compose_dvf_matches_jax():
    u, v = smooth_field_mm(4), smooth_field_mm(5, amp=1.5)
    out = tdvf.compose_dvf(u, v, SPACING, device="cpu")
    close(out, jdvf.compose_dvf(u, v, SPACING))


def test_gradient_magnitude_matches_jax():
    vol = blob_volume(6)
    out = tdvf.gradient_magnitude(vol, SPACING, device="cpu")
    close(out.numpy(), jdvf.gradient_magnitude(vol, SPACING))


@pytest.mark.parametrize("mode_nearest", [True, False])
def test_sample_dvf_at_points_matches_jax(mode_nearest):
    """One warp_coords launch (B = 3) against the JAX package's three
    trilinear gathers: within float32 rounding (1e-5 mm); points outside
    the grid clamp under mode_nearest and sample 0 without it."""
    dvf = smooth_field_mm(5)
    origin = np.array([-3.0, 4.5, -10.0])
    rng = np.random.default_rng(6)
    extent = np.array([SHAPE[2], SHAPE[1], SHAPE[0]]) * np.array(SPACING)
    pts = origin + rng.uniform(-0.2, 1.2, (500, 3)) * extent
    port = tdvf.sample_dvf_at_points(dvf, pts, origin, SPACING,
                                     mode_nearest=mode_nearest)
    ref = np.asarray(jdvf.sample_dvf_at_points(dvf, pts, origin, SPACING,
                                               mode_nearest=mode_nearest))
    assert port.dtype == np.float64 and port.shape == (500, 3)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-5)
    outside = ((pts - origin) / SPACING < 0).any(1) \
        | ((pts - origin) / SPACING > [SHAPE[2] - 1, SHAPE[1] - 1,
                                       SHAPE[0] - 1]).any(1)
    assert outside.sum() > 50
    if not mode_nearest:
        assert np.all(port[outside] == 0)
    assert tdvf.sample_dvf_at_points(dvf, np.zeros((0, 3)), origin,
                                     SPACING).shape == (0, 3)
