"""Parity of the port's registration model and cohort preprocess with the
JAX package: pose matrices, similarity metrics, the hand-written Adam,
one pyramid level of descent, and ``preprocess_batch``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.models import rigid_intensity as tri
from medicalimageanalysis_torch.ops import geometry as tgeo
from medicalimageanalysis_torch.parallel import batch as tbatch
from medicalimageanalysis_tpu.models import rigid_intensity as jri
from medicalimageanalysis_tpu.ops.filters import _gauss_kernel_matrix
from medicalimageanalysis_tpu.parallel import batch as jbatch


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [6, 7, 12])
def test_pose_to_matrix_matches_jax(n):
    rng = np.random.default_rng(n)
    pose = np.concatenate([rng.uniform(-0.3, 0.3, 3), rng.uniform(-8, 8, 3),
                           rng.uniform(-0.1, 0.1, n - 6)]).astype(np.float32)
    center = rng.uniform(-50, 50, 3).astype(np.float32)
    out = tri.pose_to_matrix(t(pose), t(center)).numpy()
    ref = np.asarray(jri.pose_to_matrix(jnp.asarray(pose),
                                        jnp.asarray(center)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * max(
        1.0, np.abs(ref).max()))


@pytest.mark.parametrize("metric", ["mse", "ncc", "mi"])
def test_metric_loss_matches_jax(metric):
    rng = np.random.default_rng(3)
    vals = rng.uniform(0, 1, (6, 7, 8)).astype(np.float32)
    ref = np.clip(vals + rng.normal(0, 0.1, vals.shape), 0, 1) \
        .astype(np.float32)
    inside = (rng.uniform(size=vals.shape) > 0.2).astype(np.float32)
    out = float(tri._metric_loss(metric, t(vals), t(ref), t(inside)))
    want = float(jri._metric_loss(metric, jnp.asarray(vals), jnp.asarray(ref),
                                  jnp.asarray(inside)))
    np.testing.assert_allclose(out, want, rtol=1e-5)


def test_mi_joint_chunks_match_one_product():
    """The chunked joint histogram (volumes past _MI_CHUNK values) equals
    the single product, value and gradient."""
    rng = np.random.default_rng(4)
    v = t(rng.uniform(0, 1, 1000).astype(np.float32)).requires_grad_(True)
    r = t(rng.uniform(0, 1, 1000).astype(np.float32))
    w = t((rng.uniform(size=1000) > 0.1).astype(np.float32))
    whole = tri._mi_joint(v, r, w, 16)
    (g_whole,) = torch.autograd.grad((whole * whole).sum(), v)
    chunked = tri._mi_joint(v, r, w, 16, chunk=128)
    (g_chunk,) = torch.autograd.grad((chunked * chunked).sum(), v)
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(g_chunk, g_whole, rtol=1e-5, atol=1e-4)


def test_hand_adam_matches_optax():
    rng = np.random.default_rng(5)
    grads = (rng.normal(size=(30, 6))
             * 10.0 ** rng.integers(-3, 2, (30, 1))).astype(np.float32)
    lr = 0.1
    p_t = torch.zeros(6)
    state = tri.adam_init(p_t)
    opt = optax.adam(jnp.float32(lr))
    p_j = jnp.zeros(6, jnp.float32)
    s_j = opt.init(p_j)
    for g in grads:
        upd, state = tri.adam_update(t(g), state, lr)
        p_t = p_t + upd
        upd_j, s_j = opt.update(jnp.asarray(g), s_j)
        p_j = optax.apply_updates(p_j, upd_j)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                                   atol=1e-7)


def smooth_pair(shape, shift_vox):
    """A smooth volume and the same function shifted by ``shift_vox``
    (x, y, z), both (Z, Y, X) float32."""
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]] \
        .astype(np.float64)

    def f(z, y, x):
        return (np.sin(x / 3.1) * np.cos(y / 2.7) + 0.5 * np.sin(z / 2.3)
                + 0.3 * np.cos((x + y) / 4.0))

    sx, sy, sz = shift_vox
    return (f(zz, yy, xx).astype(np.float32),
            f(zz + sz, yy + sy, xx + sx).astype(np.float32))


def test_register_level_matches_jax():
    """Ten Adam steps at stride 2 on (16, 20, 24). On the CPU the JAX
    level takes its XLA branch (the Pallas sampler runs only on a TPU):
    the same loss and Adam, with the ref->mov pixel map applied to the
    grid in another f32 operation order, hence the tolerances."""
    shape = (16, 20, 24)
    ref, mov = smooth_pair(shape, (0.6, -0.4, 0.3))
    spacing = np.array([1.2, 1.0, 2.0])
    origin = np.array([-10.0, 5.0, 3.0])
    m = np.eye(3)
    ref_pix2pos = tgeo.pixel_to_position_matrix(m, spacing, origin) \
        .astype(np.float32)
    mov_pos2pix = tgeo.position_to_pixel_matrix(m, spacing, origin) \
        .astype(np.float32)
    center = tgeo.apply_homogeneous([12, 10, 8], ref_pix2pos) \
        .astype(np.float32)
    pose0 = np.array([0.01, -0.02, 0.015, 0.3, -0.2, 0.1], np.float32)
    pose_t, losses_t = tri._register_level(
        t(ref), t(mov), t(ref_pix2pos), t(mov_pos2pix), t(center),
        t(pose0), 0.1, 10, (2, 2, 2))
    pose_j, losses_j = jri._register_level(
        jnp.asarray(ref), jnp.asarray(mov), jnp.asarray(ref_pix2pos),
        jnp.asarray(mov_pos2pix), jnp.asarray(center), jnp.asarray(pose0),
        jnp.float32(0.1), 10, (2, 2, 2), jnp.float32(1.0))
    pose_t, pose_j = pose_t.numpy(), np.asarray(pose_j)
    assert np.abs(pose_t - pose0).max() > 1e-2      # the descent moved
    np.testing.assert_allclose(pose_t[:3], pose_j[:3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(pose_t[3:], pose_j[3:], rtol=0, atol=1e-3)
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-4)


@pytest.mark.parametrize("entry", ["register_level", "preprocess"])
def test_contractions_run_in_full_float32(monkeypatch, entry):
    """A caller that turned TF32 on still gets full-float32 contractions
    in the descent and the preprocess, and gets its setting back."""
    seen = []
    einsum = torch.einsum

    def recording_einsum(*args):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cudnn.allow_tf32))
        return einsum(*args)

    monkeypatch.setattr(torch, "einsum", recording_einsum)
    prior = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        if entry == "register_level":
            ref, mov = smooth_pair((8, 10, 12), (0.5, 0.0, 0.0))
            eye = np.eye(4, dtype=np.float32)
            tri._register_level(t(ref), t(mov), t(eye), t(eye),
                                t(np.full(3, 5.0, np.float32)),
                                torch.zeros(6), 0.1, 2, (2, 2, 2))
        else:
            raw = np.zeros((1, 4, 6, 8), np.int16)
            tbatch.preprocess_batch(raw, [1.0], [0.0], (2, 3, 4),
                                    device="cpu")
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prior)
    assert seen and set(seen) == {("highest", False)}
    assert after == "high"


@pytest.mark.parametrize("ffs_op", ["none", "ax_rot1", "ax_rot2"])
def test_preprocess_batch_matches_jax(ffs_op):
    rng = np.random.default_rng(9)
    in_shape, out_shape = (8, 20, 24), (6, 10, 12)
    zz, yy, xx = np.mgrid[0:8, 0:20, 0:24].astype(np.float32)
    field = 700 * np.sin(xx / 3) * np.cos(yy / 4) * np.cos(zz / 2) - 226
    raw = (field + rng.normal(0, 50, (2,) + in_shape)).round() \
        .astype(np.int16)
    slopes = np.array([1.0, 1.0], np.float32)
    intercepts = np.array([-24.0, 0.0], np.float32)
    vol_t, mask_t = tbatch.preprocess_batch(raw, slopes, intercepts,
                                            out_shape, ffs_op, device="cpu")
    vol_j, mask_j = jbatch.preprocess_batch(raw, slopes, intercepts,
                                            out_shape, ffs_op)
    vol_j, mask_j = np.asarray(vol_j), np.asarray(mask_j)
    # rtol 1e-5 on HU values; the atol covers values near zero, where the
    # two sum orders leave the same absolute rounding
    np.testing.assert_allclose(vol_t.numpy(), vol_j, rtol=1e-5,
                               atol=1e-5 * np.abs(vol_j).max())
    # masks agree except where the blurred value sits within 1e-3 HU of
    # the -250 threshold (the sum order may flip those)
    blurred = vol_j.astype(np.float64)
    for axis, n in zip((1, 2, 3), out_shape):
        g = _gauss_kernel_matrix(n, 1.0).astype(np.float64)
        blurred = np.moveaxis(np.tensordot(g, blurred, axes=(1, axis)), 0,
                              axis)
    differ = mask_t.numpy() != mask_j
    assert not (differ & (np.abs(blurred + 250.0) > 1e-3)).any()
    assert mask_j.any() and not mask_j.all()
