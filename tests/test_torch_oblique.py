"""The oblique entry (staircase-shear factorization) of the port against
the JAX package: ``oblique_plan``, ``_axis_align_input`` and
``affine_warp_oblique`` (plain twins on the CPU; the JAX kernel in
interpret mode, as its own tests run it).

Tolerances, stated per check:
- the plan's fields and ``_axis_align_input``: equal;
- the port's oblique entry against the port's ``affine`` mode on the
  relayouted volume: bit-equal (V2 is an exact copy of a finite volume,
  and the ``affine_shear`` twin reads the same 8 taps and combines them
  in the ``affine`` order);
- against JAX ``affine_warp_oblique(interpret=True)``: 2e-4 on N(0, 1)
  volumes, the JAX package's own bound (tests/test_pallas_warp.py).
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import resample as tresample
from medicalimageanalysis_torch.ops import warp as twarp
from medicalimageanalysis_tpu.ops import pallas_warp as jwarp
from medicalimageanalysis_tpu.ops import resample as jresample

SHAPE = (20, 28, 36)
BG = -3001.0
MAPS = [(45.0, (0, 0, 1)), (60.0, (0, 0, 1)), (45.0, (1, 1, 1)),
        (33.0, (1, 2, 0.5))]


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def rotation_map(deg, axis, shape=SHAPE):
    Z, Y, X = shape
    ax = np.asarray(axis, float)
    R = Rotation.from_rotvec(np.deg2rad(deg) * ax
                             / np.linalg.norm(ax)).as_matrix()
    A = np.eye(4)
    A[:3, :3] = R
    c = np.array([X / 2, Y / 2, Z / 2])
    A[:3, 3] = c - R @ c
    return A


def relayout(A, shape, align):
    """(perm, flips, A2, relayouted shape), as test_pallas_warp.py's
    oblique test factors a map before planning it."""
    al = align(A, shape)
    if al is None:
        return None, (), A, shape
    perm, flips, A2 = al
    return perm, flips, A2, tuple(shape[p] for p in perm)


@pytest.mark.parametrize("A", [
    rotation_map(45.0, (0, 0, 1)), rotation_map(90.0, (0, 0, 1)),
    rotation_map(180.0, (0, 1, 0)), rotation_map(90.0, (1, 0, 0)),
    rotation_map(33.0, (1, 2, 0.5)), rotation_map(3.0, (0, 0, 1)),
    rotation_map(-120.0, (1, 1, 1))])
def test_axis_align_input_matches_jax(A):
    t = tresample._axis_align_input(A, SHAPE)
    j = jresample._axis_align_input(A, SHAPE)
    assert (t is None) == (j is None)
    if t is not None:
        assert t[0] == j[0] and t[1] == j[1]
        np.testing.assert_array_equal(t[2], j[2])


@pytest.mark.parametrize("deg,axis", MAPS)
def test_oblique_plan_matches_jax(deg, axis):
    A = rotation_map(deg, axis)
    _, _, A2, shp = relayout(A, SHAPE, tresample._axis_align_input)
    plan = twarp.oblique_plan(A2, shp)
    ref = jwarp.oblique_plan(A2, shp)
    assert plan is not None and ref is not None
    assert plan == {k: ref[k] for k in ("ky", "kz", "oy", "oz", "Z2", "Y2")}


def test_oblique_plan_gates():
    """The geometric gates of the JAX planner (test_pallas_warp.py's
    test_oblique_plan_gates) refuse the same maps."""
    weak = np.eye(4)
    weak[0, 0] = 0.1
    steep = np.eye(4)
    steep[1, 0] = 2.0
    steep_z = np.eye(4)
    steep_z[2, 0] = -1.2
    for A in (weak, steep, steep_z):
        assert twarp.oblique_plan(A, (32, 32, 32)) is None
        assert jwarp.oblique_plan(A, (32, 32, 32)) is None
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    A = np.eye(4)
    A[:2, :2] = [[c, -s], [s, c]]
    plan = twarp.oblique_plan(A, (32, 64, 64))
    ref = jwarp.oblique_plan(A, (32, 64, 64))
    assert plan == {k: ref[k] for k in plan}
    assert set(plan) == {"ky", "kz", "oy", "oz", "Z2", "Y2"}


def test_v2_is_the_staircase_copy():
    """V2[z + oz - stair(kz, x), y + oy - stair(ky, x), x] = V[z, y, x],
    0 elsewhere, with stair(k, x) = floor(f32(k) * f32(x) + 0.5)."""
    rng = np.random.default_rng(5)
    vol = rng.normal(size=SHAPE).astype(np.float32)
    plan = twarp.oblique_plan(rotation_map(45.0, (1, 1, 1)), SHAPE)
    v2 = twarp.oblique_v2(torch.from_numpy(vol), plan).numpy()
    Z, Y, X = SHAPE
    assert v2.shape == (plan["Z2"], plan["Y2"], X)
    golden = np.zeros_like(v2)
    x = np.arange(X)
    sz = np.floor(np.float32(plan["kz"]) * x.astype(np.float32)
                  + np.float32(0.5)).astype(int)
    sy = np.floor(np.float32(plan["ky"]) * x.astype(np.float32)
                  + np.float32(0.5)).astype(int)
    for z in range(Z):
        for y in range(Y):
            golden[z + plan["oz"] - sz, y + plan["oy"] - sy, x] = vol[z, y]
    np.testing.assert_array_equal(v2, golden)


@pytest.mark.parametrize("deg,axis", MAPS)
def test_oblique_equals_affine_and_matches_jax(deg, axis):
    rng = np.random.default_rng(int(deg))
    vol = rng.normal(size=SHAPE).astype(np.float32)
    A = rotation_map(deg, axis)
    perm, flips, A2, shp = relayout(A, SHAPE, tresample._axis_align_input)
    plan = twarp.oblique_plan(A2, shp)
    out = twarp.affine_warp_oblique(torch.from_numpy(vol), A2, BG, SHAPE,
                                    plan, perm=perm, flips=flips)
    v = torch.from_numpy(vol)
    if perm is not None:
        v = v.permute(*perm)
    if flips:
        v = v.flip(flips)
    direct = twarp.affine_warp_fused(v.contiguous(), A2, BG, SHAPE)
    assert torch.equal(out, direct)
    assert (out == BG).any() and (out != BG).mean(dtype=torch.float32) > 0.3

    ref, ovf = jwarp.affine_warp_oblique(
        vol, A2, BG, SHAPE, jwarp.oblique_plan(A2, shp), perm=perm,
        flips=flips, interpret=True)
    assert float(ovf) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-4)


def test_affine_shear_twin_on_an_exact_copy():
    """The operator on a V2 built by hand, against the ``affine`` twin
    on the volume: bit-equal, background and edge taps included."""
    rng = np.random.default_rng(9)
    vol = torch.from_numpy(rng.normal(size=(6, 7, 9)).astype(np.float32))
    A = rotation_map(40.0, (0, 0, 1), shape=(6, 7, 9))
    A[:3, 3] += [0.5, -1.25, 0.3]           # some samples fall outside
    plan = twarp.oblique_plan(A, (6, 7, 9))
    v2 = twarp.oblique_v2(vol, plan)
    coef = [float(v) for v in np.float32(A[:3]).reshape(-1)] + [
        float(np.float32(plan[k])) for k in ("ky", "kz", "oy", "oz")]
    before = dict(twarp.LAUNCHES)
    out = torch.ops.mia_torch.warp_affine_shear(v2[None], coef, [6, 7, 9],
                                                [6, 8, 10], -5.0)
    ref = twarp.warp_affine_plain(vol[None], coef[:12], (6, 8, 10), -5.0)
    assert torch.equal(out, ref)
    assert (out == -5.0).any() and (out != -5.0).any()
    assert twarp.LAUNCHES == before
