"""The port's device normalisation, cohort rigid registration
(``register_rigid_intensity_batch``) and batched registration step
(``parallel.batch.make_registration_step``) against the JAX package's,
on the CPU.

Tolerances, stated per check:
- the 2/98 percentiles: bit-equal to ``np.percentile``; the uint16 codes:
  bit-equal to the JAX package's host recipe (numpy on this machine);
- a batch pair's pose: bit-equal to ``register_rigid_intensity``'s level
  loop for that pair alone (the same descent);
- batch poses against JAX's ``register_rigid_intensity_batch``: 1e-4 in
  all six components (rad and mm). On the CPU the JAX level takes its XLA
  sampler branch, which maps the grid in another float32 operation
  order; the largest gaps are about 1e-7 rad and 6e-6 mm;
- ``make_registration_step``: parameters within 1e-4 (pose units) and
  losses within 1e-4 relative after 8 steps (float32 matmul and mean
  orders differ).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.models import rigid_intensity as tri
from medicalimageanalysis_torch.ops import geometry as tgeo
from medicalimageanalysis_torch.parallel import batch as tbatch
from medicalimageanalysis_torch.parallel.mesh import make_mesh
from medicalimageanalysis_tpu.models import rigid_intensity as jri
from medicalimageanalysis_tpu.parallel import batch as jbatch


@pytest.fixture(autouse=True)
def torch_env():
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    set_default_device(None)


def host_recipe(a):
    """The JAX package's normalisation (models/rigid_intensity.py:
    504-507), verbatim."""
    lo, hi = np.percentile(a, [2, 98])
    a = np.clip((a - lo) / max(hi - lo, 1e-6), 0, 1)
    return (a * 65535.0 + 0.5).astype(np.uint16)


def volumes():
    rng = np.random.default_rng(21)
    ct = rng.integers(-1024, 3071, size=(7, 11, 13)).astype(np.int16)
    ct[0, 0, :5] = -1024
    flat = np.full((4, 5, 6), 37, np.int16)
    return {
        "ct_int16": ct,
        "float_signed": (rng.normal(0, 300, (5, 9, 8))).astype(np.float32),
        "uint16": rng.integers(0, 65535, size=(6, 6, 6)).astype(np.uint16),
        "constant": flat,                # hi - lo == 0: the 1e-6 floor
        "one_voxel": np.array([[[5.5]]], np.float32),
        "two_voxels": np.array([[[-3.0, 8.0]]], np.float32),
        "ties": np.repeat(np.arange(10, dtype=np.float32), 37)
        .reshape(10, 37, 1),
    }


@pytest.mark.parametrize("name", list(volumes()))
def test_normalisation_bit_equal_to_host_recipe(name):
    from medicalimageanalysis_torch.ops.volume import stored_to_float

    a = volumes()[name]
    vol = stored_to_float(a, "cpu")
    lo, hi = tri._percentile_bounds(vol)
    want_lo, want_hi = np.percentile(a.astype(np.float32), [2, 98])
    assert lo.tobytes() == want_lo.tobytes() and \
        hi.tobytes() == want_hi.tobytes()
    codes = tri._normalize(vol)
    assert codes.dtype == torch.int32 and codes.shape == a.shape
    np.testing.assert_array_equal(codes.numpy().astype(np.uint16),
                                  host_recipe(a.astype(np.float32)))


def smooth(shape, shift=(0.0, 0.0, 0.0)):
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]] \
        .astype(np.float64)
    sx, sy, sz = shift
    z, y, x = zz + sz, yy + sy, xx + sx
    return (np.sin(x / 3.1) * np.cos(y / 2.7) + 0.5 * np.sin(z / 2.3)
            + 0.3 * np.cos((x + y) / 4.0) + 1.0).astype(np.float32)


def image(arr, spacing, origin):
    return SimpleNamespace(array=arr, matrix=np.eye(3),
                           spacing=np.asarray(spacing, float),
                           origin=np.asarray(origin, float))


def batch_inputs(shape, P=3):
    spacing, origin = [1.2, 1.0, 2.0], [-10.0, 5.0, 3.0]
    refs, movs, imgs = [], [], []
    for p in range(P):
        ref = (smooth(shape) * 400).astype(np.int16)
        mov = (smooth(shape, (0.5 * (p + 1), -0.4, 0.3 * p)) * 400) \
            .astype(np.int16)
        imgs.append((image(ref, spacing, origin),
                     image(mov, spacing, origin)))
        refs.append(ref)
        movs.append(mov)
    ref_pix2pos = tgeo.pixel_to_position_matrix(np.eye(3), spacing, origin) \
        .astype(np.float32)
    mov_pos2pix = tgeo.position_to_pixel_matrix(np.eye(3), spacing, origin) \
        .astype(np.float32)
    center = tgeo.apply_homogeneous(
        [shape[2] / 2, shape[1] / 2, shape[0] / 2], ref_pix2pos) \
        .astype(np.float32)
    geo = (np.stack([ref_pix2pos] * P), np.stack([mov_pos2pix] * P),
           np.stack([center] * P))
    return np.stack(refs), np.stack(movs), geo, imgs


LEVELS = ((2, 12, 0.3), (1, 8, 0.1))


@pytest.mark.parametrize("shape", [(8, 16, 16), (16, 32, 32)])
def test_batch_matches_jax_and_single_pair_descent(shape):
    refs, movs, geo, imgs = batch_inputs(shape)
    # the batch takes normalised volumes: the port's device codes
    norm = [[tri._normalize(torch.from_numpy(v.astype(np.float32)))
             for v in stack] for stack in (refs, movs)]
    scale = 1.0 / 65535.0
    poses, losses = tri.register_rigid_intensity_batch(
        norm[0], norm[1], *geo, levels=LEVELS, intensity_scale=scale)
    assert poses.shape == (3, 6) and poses.dtype == np.float32
    assert np.isfinite(losses).all()
    host = [np.stack([host_recipe(v.astype(np.float32)) for v in stack])
            for stack in (refs, movs)]
    j_poses, j_losses = jri.register_rigid_intensity_batch(
        host[0], host[1], *geo, levels=LEVELS, intensity_scale=scale)
    assert np.abs(poses[:, 3]).max() > 0.2             # the descent moved
    np.testing.assert_allclose(poses, j_poses, rtol=0, atol=1e-4)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    # each pair: the single-pair registration's pose, to the bit
    for p, (ref_img, mov_img) in enumerate(imgs):
        _, info = tri.register_rigid_intensity(ref_img, mov_img,
                                               levels=LEVELS)
        np.testing.assert_array_equal(info["pose"], poses[p])
        assert set(info["prep_seconds"]) == {"upload", "percentile",
                                             "quantize"}


def test_batch_mi_guard_and_arguments_match_jax():
    refs, movs, geo, _ = batch_inputs((6, 12, 12), P=2)
    raw = refs.astype(np.float32)
    for module in (tri, jri):
        with pytest.raises(ValueError, match="normalized"):
            module.register_rigid_intensity_batch(
                raw, raw, *geo, metric="mi", levels=((1, 1, 0.1),))
        with pytest.raises(ValueError, match="unknown mode"):
            module.register_rigid_intensity_batch(raw, raw, *geo,
                                                  mode="shear")
        with pytest.raises(ValueError, match="poses0"):
            module.register_rigid_intensity_batch(
                raw, raw, *geo, poses0=np.zeros((2, 7), np.float32))
    noisy = np.clip(raw / raw.max(), -0.03, 1.0).astype(np.float32)
    noisy[:, 0, 0, 0] = -0.03
    with pytest.warns(UserWarning, match="fall outside"):
        tri.register_rigid_intensity_batch(noisy, noisy, *geo, metric="mi",
                                           levels=((1, 1, 0.1),))
    # a 2-shard CPU mesh: one pair a data row, the same descent as
    # mesh=None, so the poses are bit-equal
    sharded = tri.register_rigid_intensity_batch(
        noisy, noisy[::-1], *geo, levels=((1, 3, 0.1),),
        mesh=make_mesh(2, devices=["cpu"] * 2))
    single = tri.register_rigid_intensity_batch(
        noisy, noisy[::-1], *geo, levels=((1, 3, 0.1),))
    for a, b in zip(sharded, single):
        np.testing.assert_array_equal(a, b)


def test_registration_step_matches_jax():
    zz, yy, xx = np.mgrid[0:8, 0:16, 0:16]
    blob = np.exp(-(((zz - 4) / 2.0) ** 2 + ((yy - 8) / 4.0) ** 2
                    + ((xx - 8) / 4.0) ** 2)).astype(np.float32)
    B = 2
    refs = np.broadcast_to(blob, (B, 8, 16, 16)).copy()
    movs = np.stack([np.roll(blob, 1, axis=2), np.roll(blob, -1, axis=1)])
    t_step, t_init = tbatch.make_registration_step((8, 16, 16), lr=0.1,
                                                   stride=2)
    j_step, j_init = jbatch.make_registration_step((8, 16, 16), lr=0.1,
                                                   stride=2)
    t_params, t_state = t_init(B)
    j_params, j_state = j_init(B)
    j_step = jax.jit(j_step)
    t_losses, j_losses = [], []
    for _ in range(8):
        t_params, t_state, loss = t_step(t_params, t_state,
                                         torch.from_numpy(refs),
                                         torch.from_numpy(movs))
        t_losses.append(float(loss))
        j_params, j_state, loss = j_step(j_params, j_state,
                                         jnp.asarray(refs),
                                         jnp.asarray(movs))
        j_losses.append(float(loss))
    np.testing.assert_allclose(t_params.numpy(), np.asarray(j_params),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0]


def test_registration_step_converges():
    """The JAX package's own convergence check (tests/test_parallel.py),
    on the port: 30 steps halve the loss."""
    zz, yy, xx = np.mgrid[0:8, 0:16, 0:16]
    blob = np.exp(-(((zz - 4) / 2.0) ** 2 + ((yy - 8) / 4.0) ** 2
                    + ((xx - 8) / 4.0) ** 2)).astype(np.float32)
    refs = torch.from_numpy(np.broadcast_to(blob, (2, 8, 16, 16)).copy())
    movs = torch.roll(refs, 1, dims=3)
    step, init = tbatch.make_registration_step((8, 16, 16), lr=0.1,
                                               stride=1)
    params, state = init(2)
    losses = []
    for _ in range(30):
        params, state, loss = step(params, state, refs, movs)
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0]
