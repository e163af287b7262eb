"""Parity of the port's warp operators (plain twin on the CPU) with the
JAX package's Pallas warp kernel, run in interpret mode as the JAX
package's own CPU tests run it, and with its XLA twin."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medicalimageanalysis_tpu.ops import pallas_warp as jwarp
from medicalimageanalysis_tpu.ops import resample as jresample
from medicalimageanalysis_tpu.ops.resample import _affine_resample_jit
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import resample as tresample
from medicalimageanalysis_torch.ops import warp as twarp

SHAPE = (16, 18, 40)
BG = -3001.0


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def smooth_coords(rng, shape=SHAPE):
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]] \
        .astype(np.float32)
    a = rng.uniform(0, 6.28, 3)
    cz = zz + 1.8 * np.sin(xx / 7 + a[0])
    cy = yy - 1.5 * np.cos(zz / 3 + a[1])
    cx = xx + 3.0 * np.sin(yy / 5 + a[2])
    return [c.astype(np.float32) for c in (cz, cy, cx)]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("reference", ["interpret", "xla"])
@pytest.mark.parametrize("B", [1, 3])
def test_coords_mode_matches_jax(B, reference):
    rng = np.random.default_rng(10 + B)
    vol = rng.normal(size=(B,) + SHAPE).astype(np.float32) * 300
    cz, cy, cx = smooth_coords(rng)
    if reference == "interpret":
        ref = jwarp.field_warp(vol, cz, cy, cx, background=BG,
                               interpret=True)
    else:
        ref = jwarp.field_warp_xla(jnp.asarray(vol), cz, cy, cx, BG)
    out = twarp.field_warp(t(vol), t(cz), t(cy), t(cx), BG)
    # f32 rounding of the 8-tap lerp (the JAX CPU path may contract FMAs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6 * np.abs(vol).max())


@pytest.mark.parametrize("B", [1, 3])
def test_sampler_grads_match_jax_kernel_and_autograd(B):
    rng = np.random.default_rng(20 + B)
    vol = rng.normal(size=(B,) + SHAPE).astype(np.float32)
    cz, cy, cx = smooth_coords(rng)
    w = rng.normal(size=(B,) + SHAPE).astype(np.float32)
    jvol = vol[0] if B == 1 else vol
    jw = w[0] if B == 1 else w

    sample_j = jwarp.make_warp_sampler(jnp.asarray(jvol), 0.0,
                                       interpret=True)
    gj = jax.grad(lambda a, b, c: jnp.sum(sample_j(a, b, c) * jw),
                  argnums=(0, 1, 2))(jnp.asarray(cz), jnp.asarray(cy),
                                     jnp.asarray(cx))

    coords = [t(c).requires_grad_(True) for c in (cz, cy, cx)]
    sample_t = twarp.make_warp_sampler(t(jvol), 0.0)
    (sample_t(*coords) * t(jw)).sum().backward()
    for g_t, g_j in zip(coords, gj):
        np.testing.assert_allclose(g_t.grad.numpy(), np.asarray(g_j),
                                   rtol=0, atol=5e-6)

    # torch autograd straight through the plain gather (floor has zero
    # derivative, so this is the analytic trilinear derivative too)
    auto = [t(c).requires_grad_(True) for c in (cz, cy, cx)]
    out = twarp.warp_coords_plain(t(vol), *auto, 0.0)[0]
    (out * t(w)).sum().backward()
    for g_t, g_a in zip(coords, auto):
        np.testing.assert_allclose(g_t.grad.numpy(), g_a.grad.numpy(),
                                   rtol=0, atol=5e-6)


def affine_map(deg, shift):
    Z, Y, X = SHAPE
    c = np.array([(X - 1) / 2, (Y - 1) / 2, (Z - 1) / 2])
    th = np.deg2rad(deg)
    R = np.array([[np.cos(th), -np.sin(th), 0.05],
                  [np.sin(th), np.cos(th), -0.03], [0.02, 0.01, 1.0]])
    A = np.eye(4)
    A[:3, :3] = R
    A[:3, 3] = c + np.asarray(shift) - R @ c
    return A.astype(np.float32)


def boundary_distance(A, out_shape, vol_shape):
    """Per output voxel, float64 distance of its sample from the nearest
    face of [0, dim-1] (a vanishing distance marks a boundary voxel)."""
    Zo, Yo, Xo = out_shape
    zz, yy, xx = np.mgrid[0:Zo, 0:Yo, 0:Xo].astype(np.float64)
    A = A.astype(np.float64)
    d = np.full(out_shape, np.inf)
    for row, n in ((0, vol_shape[2]), (1, vol_shape[1]), (2, vol_shape[0])):
        c = A[row, 0] * xx + A[row, 1] * yy + A[row, 2] * zz + A[row, 3]
        d = np.minimum(d, np.minimum(np.abs(c), np.abs(c - (n - 1))))
    return d


@pytest.mark.parametrize("reference", ["interpret", "xla"])
@pytest.mark.parametrize("deg,shift", [(0.0, (0.25, -0.5, 0.0)),
                                       (8.0, (1.3, -2.2, 0.4)),
                                       (45.0, (0.0, 0.0, 0.0))])
def test_affine_mode_matches_jax(deg, shift, reference):
    rng = np.random.default_rng(30)
    vol = rng.normal(size=SHAPE).astype(np.float32) * 300
    A = affine_map(deg, shift)
    if reference == "interpret":
        ref, ovf = jwarp.affine_warp_fused(
            jnp.asarray(vol), jnp.asarray(A), jnp.float32(BG), SHAPE,
            interpret=True)
        assert float(ovf) == 0.0
    else:
        ref = _affine_resample_jit(jnp.asarray(vol), jnp.asarray(A), SHAPE,
                                   jnp.float32(BG))
    ref = np.asarray(ref)
    out = twarp.affine_warp_fused(t(vol), A, BG, SHAPE).numpy()
    both = (out != BG) & (ref != BG)
    # the JAX CPU path contracts the coefficient sums into FMAs, so its
    # sample coordinates differ by a few ulp; on a noise volume that moves
    # a sample by (coordinate error) x (largest step between neighbours)
    # per axis, on top of the f32 rounding of the lerp
    coord_err = 4 * np.spacing(np.float32(max(SHAPE)))
    max_step = max(np.abs(np.diff(vol, axis=k)).max() for k in range(3))
    atol = 3 * coord_err * max_step + 1e-6 * np.abs(vol).max()
    np.testing.assert_allclose(out[both], ref[both], rtol=0, atol=atol)
    # the background mask is exact away from boundary voxels, whose
    # sample sits within rounding of a face of the volume
    flip = (out == BG) != (ref == BG)
    assert np.all(boundary_distance(A, SHAPE, SHAPE)[flip] < 1e-4)
    assert (out == BG).any() or deg == 0.0


def test_affine_mode_equals_coords_mode_on_affine_coords():
    rng = np.random.default_rng(31)
    vol = rng.normal(size=SHAPE).astype(np.float32)
    A = affine_map(8.0, (1.3, -2.2, 0.4))
    cz, cy, cx = twarp.affine_coords(t(A), SHAPE)
    a = twarp.affine_warp_fused(t(vol), A, BG, SHAPE)
    b = twarp.field_warp(t(vol), cz, cy, cx, BG)
    assert torch.equal(a, b)


def test_edge_nan_and_huge_coordinates():
    rng = np.random.default_rng(40)
    Z, Y, X = 4, 5, 6
    vol = rng.normal(size=(2, Z, Y, X)).astype(np.float32)
    special = [(Z - 1.0, Y - 1.0, X - 1.0), (0.0, 0.0, 0.0),
               (-0.0, -0.0, -0.0), (np.nan, 1.0, 1.0), (1.0, 1e30, 1.0),
               (1.0, 1.0, -1e30), (np.inf, 1.0, 1.0), (1.0, 1.0, -np.inf),
               (Z - 1 + 1e-6 * 4, 1.0, 1.0), (2.5, 3.25, 4.75)]
    cz, cy, cx = (np.array([s[i] for s in special], np.float32)
                  .reshape(1, 1, -1) for i in range(3))
    out, (gz, gy, gx) = twarp.field_warp(t(vol), t(cz), t(cy), t(cx), BG,
                                         want_grad=True)
    out, gz, gy, gx = (a.numpy()[:, 0, 0] for a in (out, gz, gy, gx))
    # exact edges sample the corner voxels
    np.testing.assert_array_equal(out[:, 0], vol[:, Z - 1, Y - 1, X - 1])
    np.testing.assert_array_equal(out[:, 1], vol[:, 0, 0, 0])
    np.testing.assert_array_equal(out[:, 2], vol[:, 0, 0, 0])
    # NaN, +-1e30, +-inf and just-outside samples: background, zero grads
    for k in range(3, 9):
        np.testing.assert_array_equal(out[:, k], BG)
        for g in (gz, gy, gx):
            np.testing.assert_array_equal(g[:, k], 0.0)
    assert np.isfinite(np.stack([gz, gy, gx])).all()
    # an interior sample agrees with the JAX XLA twin
    ref = np.asarray(jwarp.field_warp_xla(jnp.asarray(vol), cz, cy, cx, BG))
    np.testing.assert_allclose(out[:, 9], ref[:, 0, 0, 9], atol=1e-6)


def test_trilinear_matches_jax():
    """resample._trilinear on (N, 3) xyz points, some outside."""
    rng = np.random.default_rng(41)
    vol = rng.normal(size=SHAPE).astype(np.float32) * 300
    hi = np.array([SHAPE[2], SHAPE[1], SHAPE[0]], np.float32)
    pts = rng.uniform(-2, hi + 1, (500, 3)).astype(np.float32)
    out = tresample._trilinear(t(vol), t(pts), BG).numpy()
    ref = np.asarray(jresample._trilinear(jnp.asarray(vol), jnp.asarray(pts),
                                          jnp.float32(BG)))
    np.testing.assert_array_equal(out == BG, ref == BG)
    assert 0 < (out == BG).sum() < len(out)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-6 * np.abs(vol).max())


def test_cpu_tensors_take_the_plain_twin():
    """Dispatch is by device: CPU tensors never reach the kernel."""
    before = dict(twarp.LAUNCHES)
    vol = torch.randn(1, 4, 5, 6)
    c = torch.full((2, 2, 2), 1.5)
    torch.ops.mia_torch.warp_coords(vol, c, c, c, 0.0, True)
    torch.ops.mia_torch.warp_affine(vol, [1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0,
                                          1.0, 0], [2, 2, 2], 0.0)
    assert twarp.LAUNCHES == before
