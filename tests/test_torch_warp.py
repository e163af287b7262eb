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


class _FakeWarpLibrary:
    """Records each kernel call of the CUDA wrappers, for their host logic
    on the CPU (no card here): entry point, volumes B and pointers."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_warp_library(monkeypatch):
    import contextlib
    import types

    from medicalimageanalysis_torch.ops import _build

    lib = _FakeWarpLibrary()
    monkeypatch.setattr(_build, "load_warp_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(twarp, "LAUNCHES", dict.fromkeys(twarp.LAUNCHES, 0))
    monkeypatch.setattr(twarp, "LAUNCH_SHAPES", {})
    return lib


@pytest.mark.parametrize("B,chunks", [(1, [(0, 1)]), (4, [(0, 4)]),
                                      (5, [(0, 4), (4, 1)]),
                                      (9, [(0, 4), (4, 4), (8, 1)])])
def test_batch_chunks_split_into_launches_of_at_most_four(B, chunks):
    assert twarp.batch_chunks(B) == chunks
    assert twarp.MAX_B == 4


def test_check_index_range_refuses_2_31_voxels():
    twarp.check_index_range("t", (3, 128, 512, 512), (2, 1024, 1024, 2047))
    with pytest.raises(ValueError, match="2\\^31"):
        twarp.check_index_range("t", (1, 1024, 1024, 2048))
    with pytest.raises(ValueError, match="2\\^31"):
        twarp.check_index_range("t", (2, 4, 4), (2048, 1024, 1024))


@pytest.mark.parametrize("want_grad", [False, True])
def test_coords_wrapper_splits_batches_and_records_shapes(
        fake_warp_library, want_grad):
    """B=6 volumes: two launches (4 + 2), each at the right volume and
    output rows, counted once each and by shape."""
    vol = torch.zeros(6, 3, 4, 5)
    c = torch.zeros(2, 3, 7)
    outs = twarp._warp_coords_cuda(vol, c, c, c, 0.0, want_grad)
    assert [tuple(o.shape) for o in outs] == \
        [(6, 2, 3, 7)] * (4 if want_grad else 1)
    calls = fake_warp_library.calls
    assert [name for name, _ in calls] == ["mia_warp_coords"] * 2
    (_, a0), (_, a1) = calls
    assert (a0[1], a1[1]) == (4, 2)
    assert a1[0] - a0[0] == 4 * 4 * 3 * 4 * 5          # 4 volumes on
    assert a1[12] - a0[12] == 4 * 4 * 2 * 3 * 7        # 4 output rows on
    assert a0[12] == outs[0].data_ptr()
    if want_grad:
        assert [a1[k] - a0[k] for k in (13, 14, 15)] == [4 * 4 * 42] * 3
    else:
        assert (a0[13], a0[14], a0[15]) == (None, None, None)
    assert twarp.LAUNCHES["warp_coords"] == 2
    assert twarp.LAUNCH_SHAPES == {
        ("warp_coords", 4, want_grad, (2, 3, 7), (3, 4, 5)): 1,
        ("warp_coords", 2, want_grad, (2, 3, 7), (3, 4, 5)): 1}


def test_affine_wrappers_refuse_volumes_beyond_int32(fake_warp_library):
    vol = torch.zeros(1, 2, 2, 2)
    coef = [1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0]
    with pytest.raises(ValueError, match="2\\^31"):
        twarp._warp_affine_cuda(vol, coef, [2048, 1024, 1024], 0.0)
    assert fake_warp_library.calls == []
    twarp._warp_affine_cuda(vol, coef, [3, 2, 2], 0.0)
    # an identity map: the separable entry, counted under its name
    assert twarp.LAUNCH_SHAPES == {
        ("warp_affine_axis", 1, False, (3, 2, 2), (2, 2, 2)): 1}


def test_build_compiles_warp_with_fmad_false(monkeypatch, tmp_path):
    """Bit-equality with the plain version rests on nvcc not contracting
    a*(1-f) + b*f into FMAs: the warp source is compiled with
    --fmad=false, for sm_90a."""
    import subprocess

    from medicalimageanalysis_torch.ops import _build

    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    path, _ = _build.build_library("warp")
    (cmd,) = seen
    assert cmd[-1].endswith("csrc/warp.cu") and path.parent == tmp_path
    assert "--fmad=false" in cmd and "--fmad=true" not in cmd
    assert "-gencode=arch=compute_90a,code=sm_90a" in cmd
