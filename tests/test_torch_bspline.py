"""Parity of the port's B-spline FFD (``ops/registration/bspline.py``: the
``disp`` sampler's plain twin and hand-written Adam on the CPU) with the
JAX package's (its XLA sampler and optax)."""

import numpy as np
import pytest
import torch

from medicalimageanalysis_tpu.ops.registration import bspline as jbspline
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
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
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]] \
        .astype(np.float32)

    def blob(cz, cy, cx):
        return np.exp(-(((zz - cz) / 3.5) ** 2 + ((yy - cy) / 5) ** 2
                        + ((xx - cx) / 6) ** 2))

    fixed = blob(8, 12, 16) + 0.5 * blob(5, 8, 10)
    moving = blob(8, 12.8, 17.5) + 0.5 * blob(5.4, 8.5, 11)
    return fixed.astype(np.float32), moving.astype(np.float32)


@pytest.mark.parametrize("n_vox,n_ctrl,spacing", [(30, 7, 5.3), (128, 8, 25.6),
                                                  (24, 11, 3.0)])
def test_basis_matrix_bit_equal(n_vox, n_ctrl, spacing):
    np.testing.assert_array_equal(
        tbspline.bspline_basis_matrix(n_vox, n_ctrl, spacing),
        jbspline.bspline_basis_matrix(n_vox, n_ctrl, spacing))


@pytest.mark.parametrize("moving_mask", [False, True])
def test_fit_matches_jax(moving_mask):
    """20 Adam steps: losses within rtol 1e-4 and the field within
    0.05 mm of JAX's."""
    fixed, moving = pair()
    mmask = (moving > 0.05).astype(np.float32) if moving_mask else None
    kw = dict(control_spacing=[10, 10, 10], iterations=20, lr=0.5,
              moving_mask=mmask)
    dvf_j, loss_j = jbspline.bspline_registration(fixed, moving, SPACING,
                                                  **kw)
    dvf_t, loss_t = tbspline.bspline_registration(fixed, moving, SPACING,
                                                  device="cpu", **kw)
    assert dvf_t.shape == SHAPE + (3,) and loss_t.shape == (20,)
    assert loss_t[-1] < 0.2 * loss_t[0]               # the fit moved
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    assert np.abs(dvf_t - dvf_j).max() < 0.05
    assert np.abs(dvf_t).max() > 0.5


def test_mi_metric_fit_matches_jax():
    """The fit through the port's _metric_loss (Mattes-style MI), the
    path the elastix parity mode takes."""
    fixed, moving = pair()
    Z, Y, X = SHAPE
    sp = np.asarray(SPACING, np.float32)
    B = [tbspline.bspline_basis_matrix(n, 5, n / 2) for n in (Z, Y, X)]
    ones = np.ones_like(fixed)
    dvf_t, loss_t = tbspline._bspline_fit(
        *(torch.from_numpy(a) for a in (fixed, moving, ones)), None,
        *(torch.from_numpy(b) for b in B), torch.from_numpy(sp), 0.3, 8,
        metric="mi", bins=16)
    import jax.numpy as jnp
    dvf_j, loss_j, _ = jbspline._bspline_fit(
        *(jnp.asarray(a) for a in (fixed, moving, ones)),
        jnp.zeros((1, 1, 1)), *(jnp.asarray(b) for b in B),
        jnp.asarray(sp), jnp.float32(0.3), 8, metric="mi", bins=16)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=1e-4)
    assert np.abs(dvf_t.numpy() - np.asarray(dvf_j)).max() < 0.05
