"""The ``affine`` warp's separable path (csrc/warp.cu ``axis_kernel``).

A map whose six off-diagonal coefficients are 0 goes to the kernel entry
``mia_warp_affine_axis`` (``ops/warp.affine_path``). That kernel computes
each axis's taps once per column, row and slice, x-lerps the input rows
first, then lerps in y and in z. ``separable_affine`` below repeats that
order in plain PyTorch, and it must give the bits of
``warp_affine_plain``, the twin the kernel is held to on the card, at
every map listed here: the CPU proof that the reordering is exact. The
wrapper's choice of entry is pinned through the fake library of
tests/test_torch_warp.py, and the port at gamma's map is held to the JAX
package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medicalimageanalysis_tpu.ops.resample import _affine_resample_jit
from medicalimageanalysis_torch.ops import warp as twarp
from medicalimageanalysis_torch.ops.gamma import (fine_grid_layout,
                                                  fine_grid_shape,
                                                  fine_to_ref_pixel_matrix)
from medicalimageanalysis_torch.ops.resample import compose_pixel_matrix
from test_torch_warp import fake_warp_library  # noqa: F401 (fixture)

BG = -3001.0
F32 = torch.float32
NAN, INF = float("nan"), float("inf")
# the two kernel entries, by the names they count under (affine_path)
AXIS, GENERAL = "warp_affine_axis", "warp_affine"


def axis_taps(c, t, n_out, n_in):
    """One axis of a diagonal map: csrc/warp.cu axis_tap at the output
    indices 0 .. n_out-1 -> (i0, i1, f, inside)."""
    v = c * torch.arange(n_out, dtype=F32) + t
    inside = (v >= 0) & (v <= n_in - 1)
    v0 = torch.floor(v)
    i0 = torch.nan_to_num(v0, nan=0.0).clamp(0, n_in - 1).to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=n_in - 1), v - v0, inside


def separable_affine(vol, coef, out_shape, background):
    """The axis path's order in plain PyTorch: vol (Z, Y, X) f32, 12
    coefficients of a diagonal map -> (Zo, Yo, Xo). The x-lerp of every
    input row at each output column, then the y lerp, then the z lerp."""
    Z, Y, X = vol.shape
    Zo, Yo, Xo = out_shape
    c = torch.tensor(coef, dtype=F32)
    x0, x1, fx, inx = axis_taps(c[0], c[3], Xo, X)
    y0, y1, fy, iny = axis_taps(c[5], c[7], Yo, Y)
    z0, z1, fz, inz = axis_taps(c[10], c[11], Zo, Z)
    rows = vol[:, :, x0] * (1 - fx) + vol[:, :, x1] * fx        # (Z, Y, Xo)
    fy, fz = fy[:, None], fz[:, None, None]
    plane = rows[:, y0] * (1 - fy) + rows[:, y1] * fy          # (Z, Yo, Xo)
    out = plane[z0] * (1 - fz) + plane[z1] * fz                # (Zo, Yo, Xo)
    inside = inz[:, None, None] & iny[None, :, None] & inx[None, None, :]
    return torch.where(inside, out, torch.tensor(background, dtype=F32))


def diagonal(scale, shift):
    """12 coefficients of the map x -> sx*x + tx, y -> sy*y + ty, z ->
    sz*z + tz (scale and shift in (x, y, z) order)."""
    A = np.zeros((3, 4))
    A[[0, 1, 2], [0, 1, 2]] = scale
    A[:, 3] = shift
    return [float(v) for v in A.reshape(-1)]


def gamma_map(ref_shape, spacing, shift_mm, dta_mm=3.0):
    """Dose.compute_gamma's fine-grid map: the evaluated dose's pixel
    matrix onto a reference grid ``shift_mm`` (x, y, z) away, composed
    with the reference -> fine grid map, cast to float32."""
    s, r = fine_grid_layout(spacing, dta_mm)[:2]
    origin = np.array([-20.0, -31.5, 12.0])
    A = compose_pixel_matrix(np.eye(3), spacing, origin, np.eye(3), spacing,
                             origin + np.asarray(shift_mm)) \
        .astype(np.float64) @ fine_to_ref_pixel_matrix(s, r)
    A = A.astype(np.float32)
    return [float(v) for v in A[:3].reshape(-1)], \
        fine_grid_shape(ref_shape, s, r)


def ct_to_dose_map():
    """resample_to's CT (0.8 x 0.8 x 2 mm) onto a 2.5 mm dose grid."""
    ct_sp, dose_sp = [0.8, 0.8, 2.0], [2.5, 2.5, 2.5]
    ct_origin = np.array([-16.0, -16.0, -20.0])
    dose_origin = ct_origin + [1.3, 0.9, 1.0]
    A = compose_pixel_matrix(np.eye(3), ct_sp, ct_origin, np.eye(3),
                             dose_sp, dose_origin)
    return [float(v) for v in A[:3].reshape(-1)], (15, 12, 12)


# name -> (volume dims, coefficients, output dims)
CASES = {
    "gamma": ((6, 7, 8),) + gamma_map((6, 7, 8), [2.5, 2.5, 2.5],
                                      [0.0, 0.0, 0.0]),
    "gamma_shift_1mm": ((6, 7, 8),) + gamma_map((6, 7, 8), [2.5, 2.5, 2.5],
                                                [1.0, 0.0, 0.0]),
    "gamma_shift_xyz": ((5, 7, 6),) + gamma_map((5, 7, 6), [2.0, 2.5, 3.0],
                                                [0.7, -1.1, 2.3]),
    "ct_to_dose": ((20, 40, 40),) + ct_to_dose_map(),
    "flip_xz": ((6, 7, 9), diagonal([-1.0, 1.0, -1.0], [8.0, 0.0, 5.0]),
                (6, 7, 9)),
    "flip_scaled": ((6, 7, 9), diagonal([-0.5, 0.75, -1.25],
                                        [8.0, 0.3, 6.0]), (7, 9, 17)),
    "exact_faces": ((5, 7, 9), diagonal([0.5, 0.5, 0.25], [0.0, 0.0, 0.0]),
                    (17, 13, 17)),
    "faces_past": ((5, 7, 9), diagonal([0.5, 0.5, 0.25], [-1.0, 0.5, -0.5]),
                   (21, 14, 19)),
    "nan_shift": ((4, 5, 6), diagonal([1.0, 1.0, 1.0], [NAN, 0.25, 0.5]),
                  (4, 5, 6)),
    "inf_shift": ((4, 5, 6), diagonal([1.0, 1.0, 1.0], [0.5, INF, -INF]),
                  (4, 5, 6)),
    "huge_shift": ((4, 5, 6), diagonal([1.0, 1.0, 1.0], [1e30, 0.5, -1e30]),
                   (4, 5, 6)),
    "nan_diagonal": ((4, 5, 6), diagonal([NAN, 1.0, 1.0], [0.0, 0.5, 0.5]),
                     (4, 5, 6)),
    "inf_diagonal": ((4, 5, 6), diagonal([1.0, INF, 1.0], [0.5, 0.0, 0.5]),
                     (4, 5, 6)),
    "zero_diagonal": ((4, 5, 6), diagonal([0.0, 0.0, 0.0], [2.5, 1.5, 0.5]),
                      (3, 4, 5)),
    "xo_odd": ((5, 6, 23), diagonal([0.34, 0.5, 0.4], [0.2, 0.1, 0.3]),
               (11, 11, 67)),
    "one_voxel_axes": ((1, 6, 1), diagonal([0.5, 0.3, 1.0], [0.0, 0.2, 0.0]),
                       (3, 17, 5)),
    "zo_1": ((4, 9, 10), diagonal([0.5, 0.5, 1.0], [0.1, 0.2, 1.5]),
             (1, 17, 19)),
    "yo_xo_1": ((4, 9, 10), diagonal([0.5, 0.5, 0.5], [4.5, 3.5, 0.5]),
                (6, 1, 1)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_separable_order_is_bit_equal_to_the_twin(name):
    shape, coef, out_shape = CASES[name]
    assert twarp.affine_path(coef) == AXIS
    vol = torch.from_numpy(np.random.default_rng(len(name)).normal(
        size=shape).astype(np.float32) * 300)
    want = twarp.warp_affine_plain(vol[None], coef, out_shape, BG)[0]
    got = separable_affine(vol, coef, out_shape, BG)
    assert got.shape == tuple(out_shape)
    assert torch.equal(got, want)
    inside = want != BG
    assert inside.any() or name in ("nan_shift", "inf_shift", "huge_shift",
                                    "nan_diagonal", "inf_diagonal")


def test_separable_order_reaches_the_faces_exactly():
    """A map landing on faces 0 and dim - 1 samples the corner voxels."""
    shape, coef, out_shape = CASES["exact_faces"]
    vol = torch.from_numpy(np.random.default_rng(3).normal(
        size=shape).astype(np.float32))
    got = separable_affine(vol, coef, out_shape, BG)
    assert not (got == BG).any()
    assert got[0, 0, 0] == vol[0, 0, 0]
    assert got[-1, -1, -1] == vol[-1, -1, -1]


OFF = (1, 2, 4, 6, 8, 9)


@pytest.mark.parametrize("value,path", [
    (0.0, AXIS), (-0.0, AXIS), (1e-50, AXIS),     # 0 in float32
    (1e-30, GENERAL), (-1e-45, GENERAL), (NAN, GENERAL),
    (INF, GENERAL), (-INF, GENERAL), (0.5, GENERAL)])
@pytest.mark.parametrize("k", OFF)
def test_path_choice_follows_the_off_diagonals(k, value, path):
    coef = diagonal([1.0, 1.0, 1.0], [0.5, 0.5, 0.5])
    coef[k] = value
    assert twarp.affine_path(coef) == path


@pytest.mark.parametrize("value", [NAN, INF, -INF, 0.0, -0.0, -2.5, 1e30])
def test_any_diagonal_keeps_the_axis_path(value):
    for k in (0, 5, 10):
        coef = diagonal([1.0, 1.0, 1.0], [0.5, NAN, 1e30])
        coef[k] = value
        assert twarp.affine_path(coef) == AXIS


def test_axis_path_on_a_tensor_matrix_row():
    """The wrapper hands the path the 12 floats affine_warp builds."""
    A = torch.eye(4)
    A[0, 3] = 2.0
    coef = [float(v) for v in A[:3].reshape(12)]
    assert twarp.affine_path(coef) == AXIS
    A[2, 1] = -0.0
    assert twarp.affine_path([float(v) for v in A[:3].reshape(12)]) == AXIS
    A[2, 1] = 1e-7
    assert twarp.affine_path([float(v) for v in A[:3].reshape(12)]) \
        == GENERAL


@pytest.mark.parametrize("coef,entry,path", [
    (diagonal([0.5, 0.5, 0.25], [0.1, -0.2, 0.3]), "mia_warp_affine_axis",
     AXIS),
    (diagonal([-1.0, 1.0, 1.0], [NAN, 0.0, 1e30]), "mia_warp_affine_axis",
     AXIS),
    ([1.0, 1e-30, 0, 0.5, 0, 1.0, 0, 0, 0, 0, 1.0, 0],
     "mia_warp_affine", GENERAL),
    ([1.0, 0, 0, 0.5, 0, 1.0, NAN, 0, 0, 0, 1.0, 0], "mia_warp_affine",
     GENERAL),
    ([0.9, -0.4, 0.02, 3, 0.4, 0.9, 0.01, -2, 0.0, 0.0, 1.0, 0],
     "mia_warp_affine", GENERAL)])
@pytest.mark.parametrize("B,chunks", [(1, [1]), (5, [4, 1])])
def test_wrapper_calls_the_chosen_entry(fake_warp_library, monkeypatch,
                                        coef, entry, path, B, chunks):
    """Either entry gets mia_warp_affine's arguments, launch by launch, and
    counts under its own name (the path) in LAUNCHES and LAUNCH_SHAPES."""
    vol = torch.zeros(B, 3, 4, 5)
    out = twarp._warp_affine_cuda(vol, coef, [2, 3, 7], BG)
    assert tuple(out.shape) == (B, 2, 3, 7)
    calls = fake_warp_library.calls
    assert [name for name, _ in calls] == [entry] * len(chunks)
    for (_, args), nb, b0 in zip(calls, chunks, np.cumsum([0] + chunks)):
        assert args[0] == vol.data_ptr() + b0 * 4 * 3 * 4 * 5
        assert args[1:5] == (nb, 3, 4, 5)
        assert np.array_equal(np.array(list(args[5]), np.float32),
                              np.array(coef, np.float32), equal_nan=True)
        assert args[6:10] == (2, 3, 7, BG)
        assert args[10] == out.data_ptr() + b0 * 4 * 2 * 3 * 7
        assert len(args) == 12
    assert twarp.LAUNCHES == dict.fromkeys(twarp.LAUNCHES, 0) | {
        path: len(chunks)}
    assert twarp.LAUNCH_SHAPES == {
        (path, nb, False, (2, 3, 7), (3, 4, 5)): chunks.count(nb)
        for nb in chunks}


@pytest.mark.parametrize("coef", [diagonal([1.0, 1.0, 1.0], [0, 0, 0]),
                                  [1.0, 0.1, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0,
                                   0]])
@pytest.mark.parametrize("vol_shape,out_shape", [
    ((1, 2, 2, 2), [2048, 1024, 1024]), ((1, 2048, 1024, 1024), [2, 2, 2])])
def test_both_entries_refuse_volumes_beyond_int32(fake_warp_library, coef,
                                                  vol_shape, out_shape):
    # a meta tensor: the shape without the 8 GB
    device = "meta" if np.prod(vol_shape) > 2 ** 20 else "cpu"
    vol = torch.zeros(vol_shape, device=device)
    with pytest.raises(ValueError, match="2\\^31"):
        twarp._warp_affine_cuda(vol, coef, out_shape, 0.0)
    assert fake_warp_library.calls == []
    assert not any(twarp.LAUNCHES.values())


@pytest.mark.parametrize("shift", [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
def test_gamma_map_matches_jax(shift):
    """affine_warp_fused at gamma's fine-grid map against the JAX
    package's XLA twin, at test_torch_warp's affine tolerance."""
    ref_shape = (6, 7, 8)
    coef, out_shape = gamma_map(ref_shape, [2.5, 2.5, 2.5], shift)
    A = np.eye(4, dtype=np.float32)
    A[:3] = np.asarray(coef, np.float32).reshape(3, 4)
    rng = np.random.default_rng(50)
    vol = rng.normal(size=ref_shape).astype(np.float32) * 300
    ref = np.asarray(_affine_resample_jit(jnp.asarray(vol), jnp.asarray(A),
                                          out_shape, jnp.float32(BG)))
    out = twarp.affine_warp_fused(torch.from_numpy(vol), A, BG,
                                  out_shape).numpy()
    assert out.shape == ref.shape == tuple(out_shape)
    both = (out != BG) & (ref != BG)
    # test_torch_warp.test_affine_mode_matches_jax's bound: the JAX CPU
    # path may contract the coefficient sums into FMAs
    coord_err = 4 * np.spacing(np.float32(max(out_shape)))
    max_step = max(np.abs(np.diff(vol, axis=k)).max() for k in range(3))
    atol = 3 * coord_err * max_step + 1e-6 * np.abs(vol).max()
    np.testing.assert_allclose(out[both], ref[both], rtol=0, atol=atol)
    assert both.mean() > 0.1     # the pad ring is most of a small grid
    # the background ring: exact, the fine grid's pad lies whole voxels out
    np.testing.assert_array_equal(out == BG, ref == BG)
