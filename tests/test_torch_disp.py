"""Parity of the warp kernel's ``disp`` mode in the port (plain twin on
the CPU) with the JAX package's ``warp_disp_jit`` (its XLA twin, and the
Pallas kernel in interpret mode) and ``make_disp_sampler``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medicalimageanalysis_tpu.ops import pallas_warp as jwarp
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import warp as twarp

SHAPE = (12, 14, 20)
BG = -3001.0


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def smooth_disp(rng, shape=SHAPE, amp=(2.5, 1.5, 1.2)):
    """A smooth planar (3, Z, Y, X) voxel field, rows (x, y, z), that
    pushes some samples outside the volume."""
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]] \
        .astype(np.float32)
    a = rng.uniform(0, 6.28, 3)
    return np.stack([amp[0] * np.sin(yy / 4 + a[0]) + 0.1 * zz,
                     amp[1] * np.cos(zz / 3 + a[1]),
                     amp[2] * np.sin(xx / 5 + a[2])]).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("B", [1, 3])
def test_disp_mode_matches_jax(B):
    rng = np.random.default_rng(50 + B)
    vol = rng.normal(size=(B,) + SHAPE).astype(np.float32) * 300
    disp = smooth_disp(rng)
    ref = np.asarray(jwarp.warp_disp_jit(jnp.asarray(vol), jnp.asarray(disp),
                                         BG))
    out = twarp.warp_disp(t(vol), t(disp), BG).numpy()
    assert (out == BG).any() and not (out == BG).all()
    # f32 rounding of the 8-tap lerp (the JAX CPU path may contract FMAs)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-6 * np.abs(vol).max())
    # the eager surface is the same call
    np.testing.assert_array_equal(
        twarp.field_warp_disp(t(vol), t(disp), BG).numpy(), out)


def test_disp_mode_matches_pallas_kernel_in_interpret_mode():
    """The TPU kernel itself, emulated on the CPU as the JAX package's own
    tests run it; the volume's dims differ from the field's."""
    rng = np.random.default_rng(53)
    vol = rng.normal(size=(2, 10, 12, 24)).astype(np.float32) * 300
    disp = smooth_disp(rng, (8, 9, 16))
    ref = np.asarray(jwarp.warp_disp_jit(jnp.asarray(vol), jnp.asarray(disp),
                                         BG, interpret=True))
    out = twarp.warp_disp(t(vol), t(disp), BG).numpy()
    assert out.shape == (2, 8, 9, 16)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-6 * np.abs(vol).max())


@pytest.mark.parametrize("reference", ["interpret", "xla"])
@pytest.mark.parametrize("B", [1, 3])
def test_disp_sampler_grads_match_jax_and_autograd(B, reference):
    """The fused VJP (kernel gradients restacked x, y, z and summed over
    B) against JAX's make_disp_sampler (the Pallas kernel in interpret
    mode, or its XLA twin) and torch autograd of the plain gather."""
    rng = np.random.default_rng(60 + B)
    vol = rng.normal(size=(B,) + SHAPE).astype(np.float32)
    disp = smooth_disp(rng)
    w = rng.normal(size=(B,) + SHAPE).astype(np.float32)
    jvol = vol[0] if B == 1 else vol
    jw = w[0] if B == 1 else w

    sample_j = jwarp.make_disp_sampler(
        jnp.asarray(jvol), 0.0,
        interpret=True if reference == "interpret" else None)
    out_j, vjp = jax.vjp(sample_j, jnp.asarray(disp))
    (g_j,) = vjp(jnp.asarray(jw))

    d_t = t(disp).requires_grad_(True)
    out_t = twarp.make_disp_sampler(t(jvol), 0.0)(d_t)
    (out_t * t(jw)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(g_j), rtol=0,
                               atol=5e-6)

    # torch autograd straight through the plain gather (floor has zero
    # derivative, so this is the analytic trilinear derivative too)
    d_a = t(disp).requires_grad_(True)
    (twarp.warp_disp_plain(t(vol), d_a, 0.0)[0] * t(w)).sum().backward()
    np.testing.assert_allclose(d_t.grad.numpy(), d_a.grad.numpy(), rtol=0,
                               atol=5e-6)


def test_disp_nan_inf_and_edge_displacements():
    rng = np.random.default_rng(70)
    Z, Y, X = 4, 5, 6
    vol = rng.normal(size=(2, Z, Y, X)).astype(np.float32)
    disp = np.zeros((3, Z, Y, X), np.float32)
    # voxel (0, 0, k) gets displacement k's special (x, y, z) row
    special = [(X - 1.0, Y - 1.0, Z - 1.0), (0.0, 0.0, 0.0),
               (-0.0, -0.0, -0.0), (np.nan, 1.0, 1.0), (1.0, 1e30, 1.0),
               (1.0, 1.0, -1e30), (np.inf, 1.0, 1.0)]
    for k, (dx, dy, dz) in enumerate(special[:X]):
        disp[:, 0, 0, k] = (dx - k, dy, dz)     # absolute coordinate targets
    disp[:, 1, 1, 1] = (-np.inf, 0.0, 0.0)
    disp[:, 1, 1, 2] = (0.0, 0.0, Z - 1 + 1e-5)  # just past the far z face
    out, gz, gy, gx = (a.numpy() for a in twarp.warp_disp_plain(
        t(vol), t(disp), BG, want_grad=True))
    np.testing.assert_array_equal(out[:, 0, 0, 0],
                                  vol[:, Z - 1, Y - 1, X - 1])
    np.testing.assert_array_equal(out[:, 0, 0, 1], vol[:, 0, 0, 0])
    np.testing.assert_array_equal(out[:, 0, 0, 2], vol[:, 0, 0, 0])
    for idx in ((0, 0, 3), (0, 0, 4), (0, 0, 5), (1, 1, 1), (1, 1, 2)):
        np.testing.assert_array_equal(out[(slice(None),) + idx], BG)
        for g in (gz, gy, gx):
            np.testing.assert_array_equal(g[(slice(None),) + idx], 0.0)
    assert np.isfinite(np.stack([gz, gy, gx])).all()
    # every voxel, special ones included, equals the coords mode at the
    # same absolute coordinates, and the JAX twin
    zz, yy, xx = np.mgrid[0:Z, 0:Y, 0:X].astype(np.float32)
    coords = [zz + disp[2], yy + disp[1], xx + disp[0]]
    np.testing.assert_array_equal(
        out, twarp.warp_coords_plain(t(vol), *map(t, coords), BG)[0].numpy())
    ref = np.asarray(jwarp.warp_disp_jit(jnp.asarray(vol), jnp.asarray(disp),
                                         BG))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_cpu_tensors_take_the_plain_twin():
    """Dispatch is by device: CPU tensors never reach the kernel."""
    before = dict(twarp.LAUNCHES)
    vol = torch.randn(2, 4, 5, 6)
    disp = torch.randn(3, 3, 4, 5)
    res = torch.ops.mia_torch.warp_disp(vol, disp, 0.0, True)
    assert [tuple(r.shape) for r in res] == [(2, 3, 4, 5)] * 4
    assert twarp.LAUNCHES == before


@pytest.mark.parametrize("B,want_grad", [(5, False), (5, True), (4, True)])
def test_disp_wrapper_splits_batches_and_records_shapes(monkeypatch, B,
                                                        want_grad):
    """The CUDA wrapper's host logic with the library replaced (no card
    here): B > 4 volumes go out in launches of at most 4, each at its
    volume and output rows, with one field for all; each launch is
    counted once and by (B, gradients, output dims)."""
    import contextlib
    import types

    from medicalimageanalysis_torch.ops import _build

    calls = []

    class Lib:
        def mia_warp_disp(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "load_warp_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(twarp, "LAUNCHES", dict.fromkeys(twarp.LAUNCHES, 0))
    monkeypatch.setattr(twarp, "LAUNCH_SHAPES", {})
    vol = torch.zeros(B, 6, 7, 8)
    disp = torch.zeros(3, 2, 3, 5)
    outs = twarp._warp_disp_cuda(vol, disp, 0.0, want_grad)
    assert len(outs) == (4 if want_grad else 1)
    assert all(tuple(o.shape) == (B, 2, 3, 5) for o in outs)
    chunks = twarp.batch_chunks(B)
    assert [a[1] for a in calls] == [nb for _, nb in chunks]
    for (b0, _), a in zip(chunks, calls):
        assert a[0] == vol.data_ptr() + 4 * b0 * 6 * 7 * 8
        assert a[5] == disp.data_ptr()
        assert a[10] == outs[0].data_ptr() + 4 * b0 * 30
        assert a[14] == int(want_grad)
    assert twarp.LAUNCHES["warp_disp"] == len(chunks)
    assert twarp.LAUNCH_SHAPES == {
        ("warp_disp", nb, want_grad, (2, 3, 5), (6, 7, 8)): sum(
            1 for _, m in chunks if m == nb) for _, nb in chunks}

