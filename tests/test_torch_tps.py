"""Thin-plate splines (ops/registration/tps.py, ``Deformable.compute_tps``)
and rigid landmark registration (``Rigid.compute_landmarks``) through
both packages, on the CPU, on the fixtures of tests/test_tps.py and
tests/test_rigid.py.

Tolerances:
- ``tps_fit``: bit-equal (the same host float64 solve).
- the evaluations, point-wise and on the grid, and ``compute_tps``'s
  field: within 1e-4 mm of the JAX package's (float32 contractions in
  both; the landmarks sit up to 1200 mm from the origin);
- ``compute_tps``'s residuals within 1e-4 mm, ``update_pois`` within
  1e-4 mm;
- ``compute_landmarks``: matrices within 1e-12 and the residuals within
  1e-12 mm (the same host float64 Umeyama).
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.registration import tps as ttps
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.ops.registration import tps as jtps

FIELD_TOL_MM = 1e-4


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    JData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    JData.clear()
    set_default_device(None)


# (landmarks, displacements, regularization): tests/test_tps.py's layouts
def _layout(seed, n, offset=(0.0, 0.0, 0.0), scale=50.0, reg=0.0,
            affine=False):
    rng = np.random.default_rng(seed)
    P = rng.uniform(-scale, scale, size=(n, 3)) + np.asarray(offset)
    if affine:
        M = np.eye(3) + rng.normal(0, 0.02, (3, 3))
        V = P @ (M - np.eye(3)).T + rng.normal(0, 2, 3)
    else:
        V = rng.uniform(-5, 5, size=(n, 3))
    return P, V, reg


TPS_CASES = {
    "exact_12": lambda: _layout(0, 12),
    "affine_field": lambda: _layout(1, 10, scale=40.0, affine=True),
    "regularized": lambda: _layout(2, 15, reg=0.5),
    "clinical_magnitudes": lambda: _layout(7, 12,
                                           offset=(200.0, -300.0, 1200.0)),
    "coplanar": lambda: (np.c_[np.random.default_rng(3).uniform(
        -30, 30, (6, 2)), np.zeros(6)], np.random.default_rng(4).uniform(
        -2, 2, (6, 3)), 0.0),
    "thirty_landmarks": lambda: _layout(5, 30, offset=(-20.0, 10.0, -40.0),
                                        scale=120.0),
}


@pytest.mark.parametrize("case", sorted(TPS_CASES))
def test_tps_matches_jax(case):
    P, V, reg = TPS_CASES[case]()
    W, A = ttps.tps_fit(P, V, regularization=reg)
    jW, jA = jtps.tps_fit(P, V, regularization=reg)
    np.testing.assert_array_equal(W, jW)
    np.testing.assert_array_equal(A, jA)
    rng = np.random.default_rng(9)
    q = np.concatenate([P, P.mean(0) + rng.uniform(-60, 60, (500, 3))])
    got = ttps.tps_displacement(P, W, A, q, chunk=128, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (len(q), 3)
    want = np.asarray(jtps.tps_displacement(P, W, A, q))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FIELD_TOL_MM)
    if not reg:
        np.testing.assert_allclose(got.numpy()[:len(P)], V, atol=2e-2)
    origin = P.min(0) - 5.0
    grid = ttps.tps_displacement_grid(P, W, A, origin, [2.0, 2.5, 3.0],
                                      np.eye(3), (5, 7, 9), chunk=64,
                                      device="cpu")
    jgrid = jtps.tps_displacement_grid(P, W, A, origin, [2.0, 2.5, 3.0],
                                       np.eye(3), (5, 7, 9), chunk=64)
    assert grid.shape == (5, 7, 9, 3) and grid.dtype == torch.float32
    np.testing.assert_allclose(grid.numpy(), jgrid, rtol=0,
                               atol=FIELD_TOL_MM)


def test_tps_grid_on_an_oblique_lattice_matches_jax():
    P, V, _ = _layout(6, 9)
    W, A = ttps.tps_fit(P, V)
    M = Rotation.from_euler("xyz", [10, -20, 30], degrees=True).as_matrix()
    args = (P, W, A, [-40.0, -30.0, -20.0], [3.0, 2.0, 4.0], M, (6, 5, 7))
    got = ttps.tps_displacement_grid(*args, device="cpu").numpy()
    np.testing.assert_allclose(got, jtps.tps_displacement_grid(*args),
                               rtol=0, atol=FIELD_TOL_MM)


def test_tps_fit_validates_like_jax():
    for args, match in (((np.zeros((3, 3)), np.zeros((2, 3))), "mismatch"),
                        ((np.zeros((0, 3)), np.zeros((0, 3))), "no land"),
                        ((np.zeros((3, 3)), np.zeros((3, 3)), -1.0),
                         "negative")):
        for fit in (ttps.tps_fit, jtps.tps_fit):
            with pytest.raises(ValueError, match=match):
                fit(*args)


def read_pair(tmp_path, shape=(8, 24, 24)):
    arr = np.random.default_rng(4).integers(-200, 200, size=shape) \
        .astype(np.int16)
    write_ct_series(tmp_path / "a", arr, spacing=(1, 1), thickness=2.0)
    write_ct_series(tmp_path / "b", arr, spacing=(1, 1), thickness=2.0,
                    modality="MR")
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    ct = [n for n in JData.image_list if JData.image[n].modality == "CT"][0]
    mr = [n for n in JData.image_list if JData.image[n].modality == "MR"][0]
    return ct, mr


TRUTH = np.array([[-90.0, -110.0, -45.0], [-82.0, -104.0, -41.0],
                  [-88.0, -100.0, -39.0], [-80.0, -112.0, -43.0],
                  [-85.0, -107.0, -47.0]])


def add_landmarks(ct, mr, moved):
    """The same POIs on both packages' images (the port's through
    interop.pois_from_numpy)."""
    interop.pois_from_numpy(TData.image[ct],
                            {f"L{i}": p for i, p in enumerate(TRUTH)})
    interop.pois_from_numpy(TData.image[mr],
                            {f"L{i}": q for i, q in enumerate(moved)})
    for i, (p, q) in enumerate(zip(TRUTH, moved)):
        JData.image[ct].add_poi(poi_name=f"L{i}", point=list(p))
        JData.image[mr].add_poi(poi_name=f"L{i}", point=list(q))


@pytest.mark.parametrize("kw,rigid_x", [
    ({}, 0.0), ({"poi_names": ["L0", "L1", "L2", "L3"]}, 0.0),
    ({"regularization": 0.3}, 0.0),
    ({"points_reference": TRUTH,
      "points_moving": TRUTH + [3.0, 0.0, 0.0]}, 3.0)],
    ids=["pois", "poi_subset", "regularized", "explicit_points_rigid"])
def test_compute_tps_matches_jax(tmp_path, kw, rigid_x):
    """tests/test_tps.py's end-to-end case: matched POIs displaced by a
    smooth offset (or explicit points with a rigid pre-map), the field on
    the reference grid, the residuals and update_pois."""
    ct, mr = read_pair(tmp_path)
    offs = np.stack([0.02 * (TRUTH[:, 1] + 110.0) + 1.0,
                     -0.5 + 0.01 * (TRUTH[:, 0] + 90.0),
                     np.full(len(TRUTH), 0.75)], axis=1)
    add_landmarks(ct, mr, TRUTH + offs)
    shift = np.eye(4)
    shift[0, 3] = rigid_x
    t = tmia.Deformable(reference_name=ct, moving_name=mr, rigid_matrix=shift,
                        roi_names=[], device="cpu")
    j = jmia.Deformable(reference_name=ct, moving_name=mr,
                        rigid_matrix=shift, roi_names=[])
    res, jres = t.compute_tps(**kw), j.compute_tps(**kw)
    assert list(res) == list(jres)
    np.testing.assert_allclose(list(res.values()), list(jres.values()),
                               rtol=0, atol=FIELD_TOL_MM)
    if "regularization" not in kw:
        assert max(res.values()) < 5e-3
    assert isinstance(t.dvf, torch.Tensor)
    assert tuple(t.dvf.shape) == tuple(TData.image[ct].dimensions) + (3,)
    np.testing.assert_allclose(t.dvf.numpy(), np.asarray(j.dvf), rtol=0,
                               atol=FIELD_TOL_MM)
    np.testing.assert_array_equal(t.origin, j.origin)
    np.testing.assert_array_equal(t.spacing, j.spacing)
    if not rigid_x:
        mapped, jmapped = t.update_pois(), j.update_pois()
        for name in mapped:
            np.testing.assert_allclose(mapped[name], jmapped[name], rtol=0,
                                       atol=FIELD_TOL_MM)
    if rigid_x:
        assert float(t.dvf.abs().max()) < 0.05


def test_compute_tps_raises_like_jax(tmp_path):
    ct, mr = read_pair(tmp_path, shape=(4, 12, 12))
    for mia in (tmia, jmia):
        d = mia.Deformable(reference_name=ct, moving_name=mr, roi_names=[])
        with pytest.raises(ValueError, match="no matched POIs"):
            d.compute_tps()
        with pytest.raises(ValueError, match="together"):
            d.compute_tps(points_reference=np.zeros((3, 3)))


LANDMARKS = np.array([[-90.0, -110.0, -45.0], [-60.0, -90.0, -40.0],
                      [-75.0, -100.0, -35.0], [-50.0, -120.0, -42.0],
                      [-85.0, -95.0, -50.0]])


@pytest.mark.parametrize("scale,kw", [
    (1.0, {}), (1.07, {"scaling": True}),
    (1.0, {"poi_names": ["F0", "F1", "F3"]}), (1.0, {"explicit": True}),
    (1.0, {"noise": 0.4})], ids=["rigid", "similarity", "poi_subset",
                                 "explicit_points", "noisy"])
def test_compute_landmarks_matches_jax(tmp_path, scale, kw):
    """tests/test_rigid.py's fiducials: Umeyama over matched POIs (or
    explicit point arrays) with the matrix stored in the matrix @ combo
    convention."""
    ct, mr = read_pair(tmp_path, shape=(4, 12, 12))
    kw = dict(kw)
    R = Rotation.from_euler("xyz", [5, -3, 8], degrees=True).as_matrix()
    t = np.array([4.0, -6.0, 2.5])
    moved = scale * LANDMARKS @ R.T + t
    noise = kw.pop("noise", 0.0)
    if noise:
        moved = moved + np.random.default_rng(3).normal(0, noise,
                                                        moved.shape)
    explicit = kw.pop("explicit", False)
    if explicit:
        kw = {"points_reference": LANDMARKS, "points_moving": moved}
    else:
        for data in (TData, JData):
            for i, (p, q) in enumerate(zip(LANDMARKS, moved)):
                data.image[ct].add_poi(poi_name=f"F{i}", point=list(p))
                data.image[mr].add_poi(poi_name=f"F{i}", point=list(q))
    tr, jr = tmia.Rigid(ct, mr), jmia.Rigid(ct, mr)
    res, jres = tr.compute_landmarks(**kw), jr.compute_landmarks(**kw)
    assert list(res) == list(jres)
    np.testing.assert_allclose(list(res.values()), list(jres.values()),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tr.matrix, jr.matrix, rtol=0, atol=1e-12)
    assert tr.misc["landmark_fre"] == res
    if not noise:
        assert max(res.values()) < 1e-6
        F = tr.matrix @ tr.combo_matrix
        np.testing.assert_allclose(F[:3, :3], scale * R, atol=1e-8)


def test_compute_landmarks_raises_like_jax(tmp_path):
    ct, mr = read_pair(tmp_path, shape=(4, 12, 12))
    for data in (TData, JData):
        data.image[ct].add_poi(poi_name="F0", point=[0.0, 0.0, 0.0])
        data.image[mr].add_poi(poi_name="F0", point=[1.0, 0.0, 0.0])
    for mia in (tmia, jmia):
        with pytest.raises(ValueError, match=">= 3"):
            mia.Rigid(ct, mr).compute_landmarks()
        with pytest.raises(ValueError, match="together"):
            mia.Rigid(ct, mr).compute_landmarks(points_reference=LANDMARKS)
        with pytest.raises(ValueError, match="shapes differ"):
            mia.Rigid(ct, mr).compute_landmarks(
                points_reference=LANDMARKS, points_moving=LANDMARKS[:4])
