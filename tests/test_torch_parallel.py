"""The port's multi-device layer (parallel/mesh.py, parallel/halo.py and
the ``mesh=`` paths of parallel/batch.py) against the JAX package's, on
the CPU: the JAX side on its 8-device virtual mesh (tests/conftest.py),
the port's on ``make_mesh(8, ..., devices=["cpu"] * 8)``, eight logical
shards on one device.

Tolerances, stated per check:
- the z-sharded functions against the JAX package's sharded function and
  against the port's single-device function: 2e-3 (tests/
  test_parallel.py's bound; the sums run in another order, and the
  slab's z coordinate, local row + halo + u_z, rounds otherwise than the
  global row + u_z); the LNCC demons as test_parallel.py holds it, mean
  5e-4 and max 0.05 (the peak normalisation amplifies the order of the
  float32 sums);
- the z gradients from a 1-row halo and the halo exchange itself:
  bit-equal (the same operations on the same values);
- the warp's background voxels: the same count and places (the global
  z bounds are the single-device kernel's own test);
- a data-sharded function against the port's ``mesh=None``: bit-equal
  (each pair's arithmetic does not depend on B on the CPU); against the
  JAX package's ``mesh=`` result: the tolerance of that function's own
  parity test (named at each case).
"""

import warnings

import numpy as np
import pytest
import torch

import jax

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.registration.demons import (
    demons_registration)
from medicalimageanalysis_torch.ops.registration.dvf import warp_volume
from medicalimageanalysis_torch.parallel import batch as tbatch
from medicalimageanalysis_torch.parallel import halo as thalo
from medicalimageanalysis_torch.parallel.mesh import (
    Ring, batch_sharding, make_mesh, shard_map_nocheck, volume_sharding)
from medicalimageanalysis_tpu.parallel import batch as jbatch
from medicalimageanalysis_tpu.parallel import halo as jhalo
from medicalimageanalysis_tpu.parallel.mesh import make_mesh as j_make_mesh


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def cpu_mesh(n=8, space=1):
    return make_mesh(n, space=space, devices=["cpu"] * n)


def jax_mesh(space):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return j_make_mesh(8, space=space)


def blob_pair(rng, shape=(32, 24, 40), shift=2):
    zz, yy, xx = np.mgrid[tuple(slice(0, n) for n in shape)].astype(
        np.float32)
    c = [n / 2 for n in shape]
    fixed = np.exp(-(((zz - c[0]) / 6) ** 2 + ((yy - c[1]) / 5) ** 2
                     + ((xx - c[2]) / 8) ** 2)).astype(np.float32) * 100
    moving = np.roll(fixed, shift=shift, axis=2) + \
        rng.normal(0, 0.1, fixed.shape).astype(np.float32)
    return fixed, moving.astype(np.float32)


# --------------------------------------------------------------------------
# the mesh
def test_mesh_shapes_and_refusals():
    mesh = cpu_mesh(8, space=4)
    assert mesh.shape == {"data": 2, "space": 4}
    assert dict(mesh.shape) == dict(jax_mesh(4).shape)
    assert mesh.local_rows() == [0, 1]
    with pytest.raises(ValueError, match="not divisible"):
        cpu_mesh(8, space=3)
    with pytest.raises(ValueError):
        j_make_mesh(8, space=3)
    with pytest.raises(ValueError, match="one device type"):
        make_mesh(2, devices=["cpu", "cuda:0"])
    if not torch.cuda.is_available():
        # no fallback: no card and no devices named
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1)


def test_shardings_split_per_block_and_gather():
    mesh = cpu_mesh(8, space=2)
    vols = np.arange(4 * 6 * 3 * 2, dtype=np.float32).reshape(4, 6, 3, 2)
    s = volume_sharding(mesh).split(vols)
    assert sorted(s.blocks) == [(r, c) for r in range(4) for c in range(2)]
    assert all(b.shape == (1, 3, 3, 2) for b in s.blocks.values())
    np.testing.assert_array_equal(np.asarray(s), vols)
    b = batch_sharding(mesh).split(vols)
    assert sorted(b.blocks) == [(r, 0) for r in range(4)]
    np.testing.assert_array_equal(b.numpy(), vols)
    with pytest.raises(ValueError, match="divisible"):
        volume_sharding(mesh).split(vols[:3])
    # the lockstep helper: one call per block, merged in block order
    calls = []

    def body(v):
        calls.append(tuple(v.shape))
        return {"sum": v.sum(dim=(1, 2, 3)).numpy(), "n": 1}

    out = shard_map_nocheck(body, mesh, in_specs=(("data",),),
                            out_specs=("data",))(vols)
    assert calls == [(1, 6, 3, 2)] * 4 and out["n"] == 1
    np.testing.assert_array_equal(out["sum"], vols.sum(axis=(1, 2, 3)))


def test_halo_exchange_on_one_device_never_aliases():
    """Eight shards on one device: each halo is a fresh tensor, so an
    in-place update of a slab (or of a received halo) leaves the
    neighbour's block as it was."""
    mesh = cpu_mesh(8, space=8)
    ring = Ring(mesh, 0)
    vol = torch.arange(16 * 3 * 2, dtype=torch.float32).reshape(16, 3, 2)
    blocks = {i: vol[2 * i:2 * i + 2].clone() for i in range(8)}
    before = {i: b.clone() for i, b in blocks.items()}
    slabs = thalo._exchange_z(ring, blocks, 2, 0)
    for i in range(8):
        want = torch.cat([vol[max(2 * i - 2, 0):2 * i]
                          if i else vol[:1].expand(2, 3, 2),
                          vol[2 * i:2 * i + 2],
                          vol[2 * i + 2:2 * i + 4]
                          if i < 7 else vol[-1:].expand(2, 3, 2)])
        assert torch.equal(slabs[i], want), i
    for s in slabs.values():
        s.add_(1000.0)
    moved = ring.ppermute({i: blocks[i] for i in range(8)}, 1)
    for t in moved.values():
        t.mul_(-1.0)
    for i in range(8):
        assert torch.equal(blocks[i], before[i]), i
        assert i == 0 or moved[i].data_ptr() != blocks[i - 1].data_ptr()


def test_z_gradient_from_the_halo_equals_torch_gradient(rng):
    mesh = cpu_mesh(4, space=4)
    ring = Ring(mesh, 0)
    vol = torch.as_tensor(rng.normal(size=(16, 7, 5)).astype(np.float32))
    sp = torch.tensor([0.8, 1.1, 2.5])
    got = thalo._gradient_planar(
        ring, {i: vol[4 * i:4 * i + 4] for i in range(4)},
        {torch.device("cpu"): sp}, 16)
    gz, gy, gx = torch.gradient(vol)
    want = torch.stack([gx / sp[0], gy / sp[1], gz / sp[2]])
    assert torch.equal(torch.cat([got[i] for i in range(4)], dim=1), want)


# --------------------------------------------------------------------------
# the z-sharded functions
def test_gaussian_z_sharded_matches_jax_and_single_device(rng):
    from scipy import ndimage

    from medicalimageanalysis_torch.ops.filters import _gauss_kernel_matrix

    vol = rng.normal(size=(32, 16, 16)).astype(np.float32)
    got = np.asarray(thalo.gaussian_z_sharded(vol, 1.5, cpu_mesh(8, 4)))
    want = np.asarray(jhalo.gaussian_z_sharded(vol, 1.5, jax_mesh(4)))
    np.testing.assert_allclose(got, want, atol=2e-3)
    single = torch.einsum("ij,jyx->iyx", torch.as_tensor(
        _gauss_kernel_matrix(32, 1.5)), torch.as_tensor(vol)).numpy()
    np.testing.assert_allclose(got, single, atol=2e-3)
    golden = ndimage.gaussian_filter1d(vol, sigma=1.5, axis=0,
                                       mode="nearest", truncate=4.0)
    np.testing.assert_allclose(got, golden, atol=2e-3)


@pytest.mark.parametrize("case", ["edges_bg", "anisotropic"])
def test_warp_z_sharded_matches_jax_and_warp_volume(rng, case):
    if case == "edges_bg":
        space, shape, spacing, bg, reach = 4, (32, 16, 24), (1, 1, 1), \
            -3001.0, 3.5
    else:
        space, shape, spacing, bg, reach = 2, (16, 12, 20), \
            (0.8, 1.2, 2.5), 0.0, 4.0
    vol = rng.normal(size=shape).astype(np.float32) * 100
    # |dz| within the halo's reach, pushing edge rows out of the volume
    dvf = rng.uniform(-reach, reach, size=shape + (3,)).astype(np.float32)
    got = np.asarray(thalo.warp_z_sharded(
        vol, dvf, cpu_mesh(8, space), spacing, background=bg, halo=8))
    want = np.asarray(jhalo.warp_z_sharded(
        vol, dvf, jax_mesh(space), spacing, background=bg, halo=8))
    single = warp_volume(vol, dvf, spacing, background=bg,
                         device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_allclose(got, single, atol=2e-3)
    np.testing.assert_array_equal(got == bg, single == bg)
    if case == "edges_bg":
        assert np.any(single == bg)


def test_warp_z_sharded_halo_overflow_warns_like_jax(rng):
    vol = rng.normal(size=(32, 8, 8)).astype(np.float32)
    dvf = np.zeros((32, 8, 8, 3), np.float32)
    # 12 rows away: inside the volume, beyond the halo-8 cap of 6 rows
    dvf[8, :, :, 2] = 12.0
    outs = []
    for fn, mesh in ((thalo.warp_z_sharded, cpu_mesh(8, 4)),
                     (jhalo.warp_z_sharded, jax_mesh(4))):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            outs.append(np.asarray(fn(vol, dvf, mesh, halo=8,
                                      background=-3001)))
        assert any("exceeded the halo reach (cap 6 rows)" in str(r.message)
                   for r in rec)
    got, want = outs
    assert np.all(got[8] == -3001)
    np.testing.assert_array_equal(got == -3001, want == -3001)
    np.testing.assert_allclose(got[0], vol[0], atol=1e-4)


@pytest.mark.parametrize("method", ["fast", "demons"])
def test_demons_z_sharded_matches_jax_and_single_device(rng, method):
    fixed, moving = blob_pair(rng)
    got = thalo.demons_z_sharded(fixed, moving, cpu_mesh(8, 4),
                                 method=method, iterations=8, std=1)
    want = jhalo.demons_z_sharded(fixed, moving, jax_mesh(4),
                                  method=method, iterations=8, std=1)
    single = demons_registration(fixed, moving, method=method,
                                 iterations=8, std=1, device="cpu")
    assert got.shape == fixed.shape + (3,) and got.dtype == np.float32
    assert np.abs(got - want).max() < 2e-3
    assert np.abs(got - single).max() < 2e-3
    assert np.abs(got[..., 0]).max() > 0.3
    with pytest.raises(ValueError, match="forces"):
        thalo.demons_z_sharded(fixed, moving, cpu_mesh(8, 4), forces="ncc")


def test_demons_z_sharded_lncc_matches_jax_and_single_device(rng):
    fixed, _ = blob_pair(rng)
    fixed = fixed + rng.normal(0, 0.5, fixed.shape).astype(np.float32)
    moving = (120.0 - np.roll(fixed, shift=2, axis=2)).astype(np.float32)
    kw = dict(method="fast", iterations=12, std=1, step=1.0, forces="lncc")
    got = thalo.demons_z_sharded(fixed, moving, cpu_mesh(8, 4), **kw)
    want = jhalo.demons_z_sharded(fixed, moving, jax_mesh(4), **kw)
    single = demons_registration(fixed, moving, device="cpu", **kw)
    for other in (want, single):
        d = np.abs(got - other)
        assert d.mean() < 5e-4 and d.max() < 0.05, (d.mean(), d.max())
    assert np.abs(got[..., 0]).max() > 0.3


def test_demons_batch_z_sharded_matches_jax_and_single_device(rng):
    zz, yy, xx = np.mgrid[0:16, 0:20, 0:32].astype(np.float32)
    base = np.exp(-(((zz - 8) / 4) ** 2 + ((yy - 10) / 4) ** 2
                    + ((xx - 16) / 6) ** 2)).astype(np.float32) * 100
    fixeds = np.stack([base + rng.normal(0, 0.05, base.shape)
                       .astype(np.float32) for _ in range(4)])
    movings = np.stack([np.roll(fixeds[b], shift=1 + (b % 2), axis=2)
                        for b in range(4)])
    got = thalo.demons_batch_z_sharded(fixeds, movings, cpu_mesh(8, 4),
                                       method="fast", iterations=6, std=1)
    want = jhalo.demons_batch_z_sharded(fixeds, movings, jax_mesh(4),
                                        method="fast", iterations=6, std=1)
    assert got.shape == (4, 16, 20, 32, 3)
    assert np.abs(got - want).max() < 2e-3
    for b in range(4):
        single = demons_registration(fixeds[b], movings[b], method="fast",
                                     iterations=6, std=1, device="cpu")
        assert np.abs(got[b] - single).max() < 2e-3, b
    assert np.abs(got[..., 0]).max() > 0.2
    with pytest.raises(ValueError, match="not divisible"):
        thalo.demons_batch_z_sharded(fixeds[:3], movings[:3],
                                     cpu_mesh(8, 4))


# --------------------------------------------------------------------------
# the data-sharded batch functions
def _cases(rng):
    """name -> (port call, JAX call, compare(port, jax)); each call takes
    ``mesh``."""
    from test_torch_radiomics import assert_panel_close

    B = 8
    doses = rng.uniform(0, 72, size=(B, 6, 12, 10)).astype(np.float32)
    masks = (rng.random((B, 6, 12, 10)) > 0.4).astype(np.uint8)
    masks[5] = 0
    zz, yy, xx = np.mgrid[0:6, 0:14, 0:12]
    base = 60 * np.exp(-((zz - 3) ** 2 / 8 + (yy - 7) ** 2 / 30
                         + (xx - 6) ** 2 / 24)).astype(np.float32)
    refs = np.stack([base * (1 + 0.05 * i) for i in range(B)])
    evals = np.stack([np.roll(r, 1, axis=2) * 1.02 for r in refs])
    ma = rng.random((B, 8, 10, 9)) > 0.6
    mb = np.roll(ma, 1, axis=2)
    vols = rng.normal(0, 50, size=(B, 7, 8, 6)).astype(np.float32)
    vmasks = rng.random((B, 7, 8, 6)) < 0.6
    vmasks[:, 0, 0, 0] = True
    raw = rng.integers(-500, 1500, (B, 8, 20, 24)).astype(np.int16)
    zb, yb, xb = np.mgrid[0:8, 0:16, 0:16]
    blob = np.exp(-(((zb - 4) / 2.0) ** 2 + ((yb - 8) / 4.0) ** 2
                    + ((xb - 8) / 4.0) ** 2)).astype(np.float32)
    fixed = np.broadcast_to(blob, (B, 8, 16, 16)).copy()
    moving = np.stack([np.roll(blob, 1 + b % 2, axis=2) for b in range(B)])
    n4v = np.stack([np.exp(0.3 * np.sin(xb / 5.0 + b)) * (100 + 50 * blob)
                    for b in range(B)]).astype(np.float32)
    sets = [[np.array([[1.0 + b % 3, 2.0, s], [9.0, 1.0, s],
                       [5.0, 11.0 - b % 4, s]]) for s in (1.0, 3.0)]
            for b in range(B)]
    from test_torch_rigid_batch import batch_inputs
    rr, rm, geo, _ = batch_inputs((8, 16, 16), P=B)
    rr = (rr.astype(np.float32) / 400.0)
    rm = (rm.astype(np.float32) / 400.0)

    def close(rtol=0.0, atol=0.0):
        def check(a, b):
            if isinstance(a, dict):
                for k in b:
                    if k in a:
                        check(a[k], b[k])
            elif isinstance(a, (tuple, list)):
                for x, y in zip(a, b):
                    check(x, y)
            else:
                np.testing.assert_allclose(np.asarray(a, np.float64),
                                           np.asarray(b, np.float64),
                                           rtol=rtol, atol=atol)
        return check

    def panels(a, b):
        for x, y in zip(a, b):
            assert_panel_close(x, y)

    def fields(a, b):
        from test_torch_n4 import assert_same_field
        for x, y in zip(a[1], np.asarray(b[1])):
            assert_same_field(x, y)

    def vol_only(a, b):
        # preprocess: test_torch_rigid.py's HU tolerance
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]),
                                   rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b[0])).max())

    rigid_levels = ((2, 6, 0.3),)
    return {
        # test_parallel.py's sharded-vs-unsharded DVH bound
        "dvh_batch": (lambda m: tbatch.dvh_batch(doses, masks, 0.002, mesh=m),
                      lambda m: jbatch.dvh_batch(doses, masks, 0.002, mesh=m),
                      close(rtol=1e-6, atol=1e-4)),
        # test_torch_gamma.py's map tolerance
        "gamma_batch": (
            lambda m: tbatch.gamma_batch(refs, evals, (2.5, 2.5, 2.5),
                                         return_maps=True, mesh=m),
            lambda m: jbatch.gamma_batch(refs, evals, (2.5, 2.5, 2.5),
                                         return_maps=True, mesh=m),
            close(atol=1e-5)),
        # test_torch_metrics.py's panel tolerance
        "compare_masks_batch": (
            lambda m: tbatch.compare_masks_batch(ma, mb, (1.0, 1.2, 2.0),
                                                 mesh=m),
            lambda m: jbatch.compare_masks_batch(ma, mb, (1.0, 1.2, 2.0),
                                                 mesh=m),
            close(rtol=1e-5)),
        "radiomics_batch": (
            lambda m: tbatch.radiomics_batch(vols, vmasks, (1.0, 1.2, 2.0),
                                             n_bins=6, mesh=m),
            lambda m: jbatch.radiomics_batch(vols, vmasks, (1.0, 1.2, 2.0),
                                             n_bins=6, mesh=m),
            panels),
        # test_torch_n4.py's field rule (the FFTs differ in the last bits)
        "n4_batch": (
            lambda m: tbatch.n4_batch(n4v, shrink=2, levels=2,
                                      max_iterations=10, return_fields=True,
                                      mesh=m),
            lambda m: jbatch.n4_batch(n4v, shrink=2, levels=2,
                                      max_iterations=10, return_fields=True,
                                      mesh=m),
            fields),
        "rasterize_batch": (
            lambda m: tbatch.rasterize_batch(sets, (4, 14, 12), mesh=m),
            lambda m: jbatch.rasterize_batch(sets, (4, 14, 12), mesh=m),
            close()),
        "preprocess_batch": (
            lambda m: tbatch.preprocess_batch(raw, np.ones(B), np.zeros(B),
                                              (6, 10, 12), mesh=m),
            lambda m: jbatch.preprocess_batch(raw, np.ones(B), np.zeros(B),
                                              (6, 10, 12), mesh=m),
            vol_only),
        # test_torch_demons_batch.py's bound after a few iterations
        "demons_batch": (
            lambda m: tbatch.demons_batch(fixed, moving, iterations=4,
                                          mesh=m),
            lambda m: jbatch.demons_batch(fixed, moving, iterations=4,
                                          mesh=m),
            close(atol=0.15)),
        # test_torch_rigid_batch.py's pose bound
        "register_rigid_intensity_batch": (
            lambda m: _rigid(tbatch_rigid(), rr, rm, geo, rigid_levels, m),
            lambda m: _rigid(jbatch_rigid(), rr, rm, geo, rigid_levels, m),
            close(atol=1e-4)),
    }


def tbatch_rigid():
    from medicalimageanalysis_torch.models import rigid_intensity
    return rigid_intensity


def jbatch_rigid():
    from medicalimageanalysis_tpu.models import rigid_intensity
    return rigid_intensity


def _rigid(module, refs, movs, geo, levels, mesh):
    poses, losses = module.register_rigid_intensity_batch(
        refs, movs, *geo, levels=levels, mesh=mesh)
    return np.asarray(poses), np.asarray(losses)


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


CASES = ["dvh_batch", "gamma_batch", "compare_masks_batch",
         "radiomics_batch", "n4_batch", "rasterize_batch",
         "preprocess_batch", "demons_batch",
         "register_rigid_intensity_batch"]


@pytest.mark.parametrize("name", CASES)
def test_data_sharded_matches_mesh_none_and_jax(name):
    port, jax_call, compare = _cases(np.random.default_rng(21))[name]
    sharded = port(cpu_mesh(8, space=2))          # 4 data rows
    _equal(sharded, port(None))
    compare(sharded, jax_call(jax_mesh(2)))


@pytest.mark.parametrize("name", CASES)
def test_data_sharded_batch_must_divide(name):
    """8 pairs over 3 data rows: the JAX package's ValueError."""
    port, _, _ = _cases(np.random.default_rng(21))[name]
    with pytest.raises(ValueError, match="not divisible by the 'data'"):
        port(cpu_mesh(3, space=1))


def test_data_sharded_batch_sizes_must_match():
    """Per-item inputs of different batch sizes raise before any row runs
    (4 doses against 8 masks would otherwise drop masks 4-7 unseen)."""
    rng = np.random.default_rng(3)
    doses = rng.uniform(0, 70, (4, 4, 6, 6)).astype(np.float32)
    masks = (rng.random((8, 4, 6, 6)) > 0.5).astype(np.uint8)
    with pytest.raises(ValueError, match="matching batch sizes"):
        tbatch.dvh_batch(doses, masks, 0.002, mesh=cpu_mesh(2, space=1))
