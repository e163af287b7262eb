"""Parity of the port's per-row linear interpolation (``lane_interp``,
``shear_x``; the plain twin of csrc/lane_interp.cu on the CPU) with the
JAX package's ``_lane_interp_kernel``, run in interpret mode as the JAX
package's own CPU tests run it, and with its XLA twin ``_lane_interp_xla``.

Tolerance: 1e-6 * max|data|. Both compute a*(1-f) + b*f from the same
taps and fraction; XLA on the CPU may contract it into an FMA, the port
(and its kernel, built with --fmad=false) rounds each operation.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import lane_interp as tli
from medicalimageanalysis_tpu.ops.pallas_kernels import (_lane_interp_xla,
                                                         lane_interp,
                                                         shear_x)


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def reference(data, pos, route):
    if route == "interpret":
        return np.asarray(lane_interp(data, pos, interpret=True))
    return np.asarray(_lane_interp_xla(jnp.asarray(data), jnp.asarray(pos)))


def with_specials(rng, pos, Xs):
    """Positions exactly on -0.5 and Xs - 0.5 (both outside), just inside
    them, on the tap edges, NaN and +-inf, scattered over ``pos``."""
    special = np.array([-0.5, Xs - 0.5, -0.4999, Xs - 0.5001, 0.0,
                        Xs - 1.0, Xs - 2.0, np.nan, np.inf, -np.inf,
                        -2.0, Xs + 2.0], np.float32)
    flat = pos.reshape(-1)
    pick = rng.choice(flat.size, special.size * 3, replace=False)
    flat[pick] = np.tile(special, 3)
    return pos


@pytest.mark.parametrize("route", ["interpret", "xla"])
@pytest.mark.parametrize("R,Xs,Xd", [(37, 64, 64), (37, 64, 70),
                                     (9, 40, 23), (1, 2, 5)])
def test_lane_interp_matches_jax(R, Xs, Xd, route):
    rng = np.random.default_rng(R * 1000 + Xs + Xd)
    data = rng.normal(size=(R, Xs)).astype(np.float32) * 300
    pos = rng.uniform(-2, Xs + 2, size=(R, Xd)).astype(np.float32)
    pos = with_specials(rng, pos, Xs) if R * Xd >= 36 else pos
    out = tli.lane_interp(torch.from_numpy(data), torch.from_numpy(pos))
    ref = reference(data, pos, route)
    assert out.shape == (R, Xd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(data).max())
    # the edge policy, exactly: 0 outside (-0.5, Xs - 0.5), NaN and inf
    outside = ~((pos > -0.5) & (pos < Xs - 0.5))
    assert np.all(out.numpy()[outside] == 0.0)
    assert np.isfinite(out.numpy()).all()


def test_positions_on_the_edges_and_specials():
    data = np.array([[3.0, 6.0, 9.0, 12.0]], np.float32)
    pos = np.array([[-0.5, -0.25, 0.0, 1.5, 3.0, 3.25, 3.5, np.nan,
                     np.inf, -np.inf]], np.float32)
    out = tli.lane_interp(torch.from_numpy(data), torch.from_numpy(pos))
    # inside the half-voxel margins the taps stay on the edge pair and
    # the fraction extrapolates, as in the JAX package
    np.testing.assert_array_equal(
        out.numpy(), [[0.0, 2.25, 3.0, 7.5, 12.0, 12.75, 0.0, 0.0, 0.0,
                       0.0]])
    for route in ("interpret", "xla"):
        np.testing.assert_allclose(out.numpy(), reference(data, pos, route),
                                   rtol=0, atol=1e-6 * 12)


def test_one_column_rows():
    """Xs == 1: the JAX package's routes disagree (the Pallas kernel
    reads a zero lane at index -1 and returns d*(pos+1), the XLA twin
    wraps to the last column and returns d); the port reads the one
    column for both taps and returns d to within rounding (ROADMAP.md
    queue 3)."""
    data = np.array([[3.0], [-2.0]], np.float32)
    pos = np.tile(np.array([-0.6, -0.5, -0.25, 0.0, 0.25, 0.49, 0.5,
                            np.nan], np.float32), (2, 1))
    out = tli.lane_interp(torch.from_numpy(data), torch.from_numpy(pos))
    inside = (pos > -0.5) & (pos < 0.5)
    expect = np.where(inside, data, 0.0)
    np.testing.assert_allclose(out.numpy(), expect, rtol=0, atol=1e-6 * 3)
    np.testing.assert_allclose(out.numpy(), reference(data, pos, "xla"),
                               rtol=0, atol=1e-6 * 3)
    interp = reference(data, pos, "interpret")
    with np.errstate(invalid="ignore"):
        np.testing.assert_allclose(
            interp, np.where(inside, data * (pos + 1), 0.0), rtol=1e-6)


@pytest.mark.parametrize("route", ["interpret", "xla"])
def test_shear_x_matches_jax(route):
    rng = np.random.default_rng(7)
    vol = rng.normal(size=(4, 8, 16)).astype(np.float32)
    pos = (0.9 * np.arange(19, dtype=np.float32)[None, None, :]
           + rng.uniform(-2, 2, size=(4, 8, 1))).astype(np.float32)
    out = tli.shear_x(torch.from_numpy(vol), torch.from_numpy(pos))
    assert out.shape == (4, 8, 19)
    if route == "interpret":
        ref = np.asarray(shear_x(vol, pos, interpret=True))
    else:
        ref = reference(vol.reshape(32, 16), pos.reshape(32, 19),
                        "xla").reshape(4, 8, 19)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(vol).max())
    # identity positions reproduce the volume exactly
    ident = np.broadcast_to(np.arange(16, dtype=np.float32),
                            (4, 8, 16)).copy()
    back = tli.shear_x(torch.from_numpy(vol), torch.from_numpy(ident))
    np.testing.assert_array_equal(back.numpy(), vol)


def test_cpu_tensors_take_the_plain_twin():
    """Dispatch is by device: CPU tensors never reach the kernel, and the
    operator is the plain twin."""
    before = dict(tli.LAUNCHES)
    data = torch.randn(5, 7)
    pos = torch.rand(5, 9) * 8 - 1
    out = torch.ops.mia_torch.lane_interp(data, pos)
    assert torch.equal(out, tli.lane_interp_plain(data, pos))
    assert tli.LAUNCHES == before


@pytest.mark.parametrize("shape,pos_cols", [((2 ** 20, 2 ** 11), 4),
                                            ((2 ** 20, 3), 2 ** 11),
                                            ((2 ** 31, 1), 1)])
def test_kernel_wrapper_refuses_int32_offsets(shape, pos_cols):
    """The kernel's offsets inside data, pos and out are int32: the CUDA
    wrapper refuses R * max(Xs, Xd) >= 2^31 before it builds or launches
    anything (meta tensors carry the shapes without memory); one element
    fewer a row passes the check."""
    data = torch.empty(shape, device="meta")
    pos = torch.empty((shape[0], pos_cols), device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        tli._lane_interp_cuda(data, pos)
    R, Xs = shape
    if R < 2 ** 31:
        tli.check_index_range(R, Xs - (Xs > pos_cols), pos_cols - (
            pos_cols > Xs))
