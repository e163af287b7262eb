"""The rest of ops/filters.py in both packages, on the CPU: morphology,
``window_level``, ``largest_component`` (host) and
``largest_component_batch`` (label propagation on the device),
``histogram_match``, ``anisotropic_diffusion`` and ``curvature_flow``,
on the cases of tests/test_filters.py and tests/test_resample_filters.py
that touch them, plus random masks and volumes made from a seed.

Tolerances, stated per check:
- morphology, ``largest_component(_batch)``: bit-equal (and equal to
  scipy where the JAX suite holds them to scipy);
- ``window_level``: equal (one float32 expression); ``interp`` against
  ``jnp.interp``: 2 ulp (XLA fuses the last multiply-add);
- ``histogram_match``, ``anisotropic_diffusion``, ``curvature_flow``:
  1e-5 of the largest magnitude (float32 stencils and the interpolation
  in another operation order), plus the JAX suite's property checks
  through the port.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import filters as tf
from medicalimageanalysis_tpu.ops import filters as jf


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def close(out, ref, rel=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("size", [2, 3, 4, 5])
@pytest.mark.parametrize("name", ["binary_erode", "binary_dilate",
                                  "binary_open", "binary_close"])
@pytest.mark.parametrize("batched", [False, True])
def test_morphology_bit_equal(name, size, batched):
    rng = np.random.default_rng(size)
    shape = (3, 7, 11, 9) if batched else (7, 11, 9)
    mask = (rng.random(shape) > 0.45).astype(np.uint8)
    out = getattr(tf, name)(mask, size)
    ref = np.asarray(getattr(jf, name)(mask, size))
    assert out.dtype == np.uint8 and out.shape == mask.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", ["binary_erode", "binary_dilate"])
def test_morphology_iterations_and_tensor_input(name):
    mask = np.zeros((10, 12, 12), np.uint8)
    mask[2:8, 3:10, 2:9] = 1
    ref = np.asarray(getattr(jf, name)(mask, 3, iterations=2))
    np.testing.assert_array_equal(getattr(tf, name)(mask, 3, iterations=2),
                                  ref)
    np.testing.assert_array_equal(
        getattr(tf, name)(torch.as_tensor(mask), 3, iterations=2), ref)


def test_morphology_matches_scipy():
    """tests/test_resample_filters.py's single and batched cubes."""
    mask = np.zeros((10, 10, 10), np.uint8)
    mask[3:7, 3:7, 3:7] = 1
    np.testing.assert_array_equal(
        tf.binary_erode(mask, size=3).astype(bool),
        ndimage.binary_erosion(mask, structure=np.ones((3, 3, 3)),
                               border_value=0))
    np.testing.assert_array_equal(
        tf.binary_dilate(mask, size=3).astype(bool),
        ndimage.binary_dilation(mask, structure=np.ones((3, 3, 3))))
    masks = np.zeros((3, 8, 10, 10), np.uint8)
    masks[:, 2:6, 3:8, 3:8] = 1
    er, di = tf.binary_erode(masks), tf.binary_dilate(masks)
    for b in range(3):
        np.testing.assert_array_equal(
            er[b].astype(bool), ndimage.binary_erosion(
                masks[b], np.ones((3, 3, 3)), border_value=0))
        np.testing.assert_array_equal(
            di[b].astype(bool), ndimage.binary_dilation(
                masks[b], np.ones((3, 3, 3))))


def test_window_level_equal():
    vol = np.random.default_rng(0).normal(200, 300, (5, 9, 7)) \
        .astype(np.float32)
    for window in ((-160, 240), (0.5, 0.75)):
        out = tf.window_level(vol, window)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jf.window_level(vol, window)))


def components(seed, shape=(12, 24, 24)):
    rng = np.random.default_rng(seed)
    m = rng.random(shape) > 0.72
    m[:, :2, :] = False  # carve structure so components separate
    m[:, :, 11:13] = False
    return m


def test_largest_component_equal():
    for seed in range(3):
        m = components(seed)
        for full in (True, False):
            out, sl = tf.largest_component(m, connectivity_full=full)
            ref, sl_j = jf.largest_component(m, connectivity_full=full)
            np.testing.assert_array_equal(out, ref)
            assert sl == sl_j
    out, sl = tf.largest_component(np.zeros((3, 4, 5)))
    assert not out.any() and sl is None
    hole = np.ones((7, 7), bool)
    hole[2:5, 2:5] = False
    np.testing.assert_array_equal(tf.fill_holes_2d(hole),
                                  jf.fill_holes_2d(hole))


def test_largest_component_batch_bit_equal():
    """tests/test_resample_filters.py's batch against scipy and the JAX
    label propagation; a single mask, an empty mask, a snaking
    component and a tie (the smaller label wins in both)."""
    batch = np.stack([components(seed) for seed in range(3)])
    out = tf.largest_component_batch(batch)
    np.testing.assert_array_equal(
        out, np.asarray(jf.largest_component_batch(batch)))
    for b in range(3):
        np.testing.assert_array_equal(out[b],
                                      jf.largest_component(batch[b])[0])
    snake = np.zeros((3, 9, 9), bool)
    snake[1, ::2, :] = True
    snake[1, 1::4, 8] = True
    snake[1, 3::4, 0] = True
    tie = np.zeros((3, 9, 9), bool)
    tie[0, 0, 0:3] = True
    tie[2, 8, 6:9] = True
    for single in (batch[0], np.zeros((4, 5, 6), bool), snake, tie):
        got = tf.largest_component_batch(single)
        assert got.dtype == bool and got.shape == single.shape
        np.testing.assert_array_equal(
            got, np.asarray(jf.largest_component_batch(single)))
    assert tf.largest_component_batch(snake).sum() == snake.sum()


def test_histogram_match_matches_jax():
    """tests/test_filters.py's three cases through both packages."""
    rng = np.random.default_rng(0)
    ref = rng.normal(300.0, 80.0, size=(8, 32, 32)).astype(np.float32)
    mov = (np.clip(ref, 0, None) / 500.0) ** 1.7 * 900.0 + 50.0
    out = tf.histogram_match(mov, ref, n_quantiles=256)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    close(out.numpy(), jf.histogram_match(mov, ref, n_quantiles=256))
    out = out.numpy()
    for q in (10, 25, 50, 75, 90):
        assert abs(np.percentile(out, q) - np.percentile(ref, q)) < 8.0
    idx = np.argsort(mov.ravel())
    assert np.all(np.diff(out.ravel()[idx]) >= -1e-3)

    rng = np.random.default_rng(1)
    body = rng.normal(200.0, 30.0, size=(4, 16, 16)).astype(np.float32)
    ref, mov = body.copy(), body * 2.0
    ref[:, :8] = -1000.0
    mov[:, :8] = -1000.0
    out = tf.histogram_match(mov, ref, exclude_below=-500.0)
    close(out.numpy(), jf.histogram_match(mov, ref, exclude_below=-500.0))
    sel = slice(None), slice(8, None)
    assert abs(np.median(out.numpy()[sel]) - np.median(ref[sel])) < 10.0
    with pytest.raises(ValueError, match="every voxel"):
        tf.histogram_match(mov, ref, exclude_below=1e9)

    rng = np.random.default_rng(7)
    body = rng.uniform(100.0, 400.0, size=(4, 24, 24)).astype(np.float32)
    ref = rng.uniform(100.0, 400.0, size=(4, 24, 24)).astype(np.float32)
    mov = body.copy()
    mov[:2] = 100.0
    ref[:2] = 100.0
    lo = float(tf.histogram_match(mov, ref).numpy()[:2].mean())
    hi_out = tf.histogram_match(mov + 10000.0, ref + 10000.0).numpy()
    close(hi_out, jf.histogram_match(mov + 10000.0, ref + 10000.0))
    hi = float(hi_out[:2].mean()) - 10000.0
    assert abs(hi - lo) < 1.0 and abs(hi - 100.0) < 2.0


def test_interp_matches_jnp_interp():
    """The device interpolation against ``jnp.interp``: inside, beyond
    both ends, on the knots, and over a repeated knot; within 2 ulp of
    the largest value (XLA on the CPU fuses the last multiply-add)."""
    import jax.numpy as jnp

    xp = np.array([-3.0, -1.0, -1.0, 0.5, 2.0, 7.0], np.float32)
    fp = np.array([5.0, 1.0, 2.0, -4.0, 0.0, 3.0], np.float32)
    x = np.concatenate([np.linspace(-5, 9, 57), xp]).astype(np.float32)
    out = tf.interp(torch.as_tensor(x), torch.as_tensor(xp),
                    torch.as_tensor(fp)).numpy()
    np.testing.assert_allclose(out, np.asarray(jnp.interp(x, xp, fp)),
                               rtol=0, atol=2 * np.spacing(np.float32(5)))


@pytest.mark.parametrize("conductance,spacing", [
    ("exp", (1.0, 1.0, 1.0)), ("reciprocal", (0.8, 0.9, 2.5))])
def test_anisotropic_diffusion_matches_jax(conductance, spacing):
    rng = np.random.default_rng(0)
    vol = np.where(np.arange(48)[None, None, :] < 24, 0.0, 500.0)
    vol = np.broadcast_to(vol, (12, 32, 48)).copy()
    vol += rng.normal(0, 10, vol.shape)
    kw = dict(iterations=10, kappa=30.0, conductance=conductance,
              spacing_xyz=spacing)
    out = tf.anisotropic_diffusion(vol, **kw)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    close(out.numpy(), jf.anisotropic_diffusion(vol, **kw))
    if conductance == "exp":
        # tests/test_filters.py's edge-preserving property
        out = out.numpy()
        flat = np.s_[2:-2, 2:-2, 4:18]
        assert out[flat].std() < 0.5 * vol[flat].std()
        assert out[:, :, 26:30].mean() - out[:, :, 18:22].mean() \
            > 0.95 * 500.0
    with pytest.raises(ValueError, match="conductance"):
        tf.anisotropic_diffusion(vol, conductance="linear")
    with pytest.raises(ValueError, match="expected"):
        tf.anisotropic_diffusion(vol[0])


def test_anisotropic_diffusion_physical_gradient_conductance():
    """tests/test_filters.py's analytic step face: the conductance gates
    on df / spacing."""
    vol = np.zeros((4, 4, 4), np.float32)
    vol[2:] = 30.0
    sp = (1.0, 1.0, 3.0)
    t = 1.0 / (2.0 * (1.0 + 1.0 + 1.0 / 9.0))
    out = tf.anisotropic_diffusion(vol, iterations=1, kappa=10.0,
                                   spacing_xyz=sp).numpy()
    close(out, jf.anisotropic_diffusion(vol, iterations=1, kappa=10.0,
                                        spacing_xyz=sp))
    delta = t * np.exp(-((30.0 / 3.0) / 10.0) ** 2) * 30.0 / 9.0
    np.testing.assert_allclose(out[1], delta, rtol=1e-5)
    np.testing.assert_allclose(out[2], 30.0 - delta, rtol=1e-5)
    np.testing.assert_allclose(out[0], 0.0, atol=1e-6)
    np.testing.assert_allclose(out[3], 30.0, atol=1e-5)


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.8, 0.9, 2.5)])
def test_curvature_flow_matches_jax(spacing):
    rng = np.random.default_rng(1)
    zz, yy, xx = np.mgrid[0:16, 0:32, 0:32].astype(np.float32)
    vol = 300.0 / (1.0 + np.exp(-(xx - 16.0)))
    vol = vol + rng.normal(0, 8, vol.shape)
    out = tf.curvature_flow(vol, iterations=10, time_step=0.05,
                            spacing_xyz=spacing)
    close(out.numpy(), jf.curvature_flow(vol, iterations=10,
                                         time_step=0.05,
                                         spacing_xyz=spacing))
    out = out.numpy()
    flat = np.s_[2:-2, 2:-2, 2:8]
    if spacing == (1.0, 1.0, 1.0):
        assert out[flat].std() < 0.7 * vol[flat].std()
        assert (out[:, :, 24:].mean() - out[:, :, :8].mean()) > \
            0.9 * (vol[:, :, 24:].mean() - vol[:, :, :8].mean())
    with pytest.raises(ValueError, match="expected"):
        tf.curvature_flow(vol[0])
