"""Radiomics in both packages, on the CPU: the port's texture matrices
(counted with ``torch.bincount`` on the device) against the JAX
package's one-hot contractions and against tests/test_radiomics.py's
per-voxel brute force; every feature family of ``compute_radiomics``;
``parallel.batch.radiomics_batch``; ``Image.compute_radiomics`` through
``read_dicoms``.

Tolerances, stated per check:
- texture-matrix counts (GLCM, GLRLM, GLDM, NGTDM n, histogram):
  bit-equal to the JAX package and to the brute force; the NGTDM float
  sums ``ngtdm_s``: 1e-6 relative (the JAX package sums float32 in its
  own order, the port in float64), 1e-4 absolute to the brute force as
  tests/test_radiomics.py;
- discretisation and the meta block: equal;
- every feature: 1e-6 relative (abs 1e-9) against the JAX package, the
  shape family included (the port's table-path mesh is bit-equal);
- ``radiomics_batch``: each pair equal to its ``compute_radiomics`` call
  at the same bound, and to the JAX package's ``radiomics_batch``.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import radiomics as TR
from medicalimageanalysis_torch.parallel.batch import radiomics_batch
from medicalimageanalysis_torch.parallel.mesh import make_mesh
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.ops import radiomics as JR
from medicalimageanalysis_tpu.parallel.batch import (
    radiomics_batch as j_radiomics_batch)
from test_radiomics import brute_glcm, brute_gldm_ngtdm, brute_glrlm

COUNTS = ("glcm", "glrlm", "gldm", "ngtdm_n", "hist")


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


def small(seed, shape=(7, 8, 6), ng=5, p=0.7):
    rng = np.random.default_rng(seed)
    lev = rng.integers(0, ng, size=shape).astype(np.int32)
    mask = rng.random(shape) < p
    mask[0, 0, 0] = True
    return lev, mask, ng


def assert_panel_close(out, ref):
    assert set(out) == set(ref)
    for fam in ref:
        if fam == "meta":
            assert out[fam] == ref[fam]
            continue
        assert list(out[fam]) == list(ref[fam])
        for k, v in ref[fam].items():
            if np.isnan(v):
                assert np.isnan(out[fam][k]), (fam, k)
            else:
                assert out[fam][k] == pytest.approx(v, rel=1e-6, abs=1e-9), \
                    (fam, k, out[fam][k], v)


@pytest.mark.parametrize("seed,alpha", [(0, 0), (1, 0), (2, 1)])
def test_texture_counts_bit_equal(seed, alpha):
    lev, mask, ng = small(seed)
    out = TR.texture_matrices(lev, mask, ng, alpha=alpha)
    ref = JR.texture_matrices(lev, mask, ng, alpha=alpha)
    assert set(out) == set(ref)
    for k in COUNTS:
        assert out[k].dtype == np.float64 and out[k].shape == ref[k].shape
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    np.testing.assert_allclose(out["ngtdm_s"], ref["ngtdm_s"], rtol=1e-6,
                               atol=1e-6 * ref["ngtdm_s"].max())


def test_texture_counts_equal_the_brute_force():
    """tests/test_radiomics.py's per-voxel counts, every direction."""
    lev, mask, ng = small(7)
    lmax = max(lev.shape)
    mats = TR.texture_matrices(lev, mask, ng, Lmax=lmax)
    lengths = np.arange(1, lmax + 1)
    for k, d in enumerate(TR.DIRECTIONS_13):
        np.testing.assert_array_equal(mats["glcm"][k],
                                      brute_glcm(lev, mask, ng, d))
        np.testing.assert_array_equal(mats["glrlm"][k],
                                      brute_glrlm(lev, mask, ng, d, lmax))
        assert mats["glrlm"][k].sum(axis=0) @ lengths == mask.sum()
    for alpha in (0, 1):
        mats = TR.texture_matrices(lev, mask, ng, alpha=alpha)
        gldm, s, n = brute_gldm_ngtdm(lev, mask, ng, alpha=alpha)
        np.testing.assert_array_equal(mats["gldm"], gldm)
        np.testing.assert_array_equal(mats["ngtdm_n"], n)
        np.testing.assert_allclose(mats["ngtdm_s"], s, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        mats["hist"], np.bincount(lev[mask], minlength=ng))


def test_texture_counts_edge_cases():
    """Levels outside [0, Ng) under the mask are dropped as the one-hot
    drops them; a one-voxel-thick ROI; a run as long as the axis."""
    lev, mask, ng = small(4, shape=(5, 6, 7))
    lev[1, 2, 3] = ng + 2
    lev[2, 2, 2] = -1
    mask[1, 2, 3] = mask[2, 2, 2] = True
    for args in ((lev, mask, ng), (np.zeros((1, 1, 9), np.int32),
                                   np.ones((1, 1, 9), bool), 1),
                 (lev[2:3], mask[2:3], ng)):
        out = TR.texture_matrices(*args)
        ref = JR.texture_matrices(*args)
        for k in COUNTS:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_discretize_and_host_formulas_equal():
    vals = np.array([[[-100.0, -75.0, 0.0, 24.9, 25.0, 80.0]]])
    mask = np.ones(vals.shape, bool)
    for kw in (dict(bin_width=25.0), dict(n_bins=4)):
        lev, ng = TR.discretize(vals, mask, **kw)
        lev_j, ng_j = JR.discretize(vals, mask, **kw)
        np.testing.assert_array_equal(lev, lev_j)
        assert ng == ng_j
    with pytest.raises(ValueError):
        TR.discretize(vals, mask)
    lev = np.array([[[0, 0, 1]]], np.int32)
    gx = TR.texture_matrices(lev, np.ones_like(lev, bool), 2, Lmax=3)
    np.testing.assert_array_equal(gx["glcm"][0], [[2, 1], [1, 0]])
    f = TR.glcm_features(gx["glcm"][0])
    assert f["JointEnergy"] == pytest.approx(0.375)
    lev = np.zeros((2, 3, 3), np.int32)
    lev[0, 0, :] = 1
    lev[1, 2, 2] = 1
    P = TR.glszm_matrix(lev, np.ones_like(lev, bool), 2)
    np.testing.assert_array_equal(P, JR.glszm_matrix(
        lev, np.ones_like(lev, bool), 2))


def ellipsoid_case(seed=7):
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.0, 40.0, size=(12, 16, 14)).astype(np.float32)
    zz, yy, xx = np.mgrid[0:12, 0:16, 0:14]
    mask = ((zz - 6.0) ** 2 / 9 + (yy - 8.0) ** 2 / 25
            + (xx - 7.0) ** 2 / 16) <= 1.0
    vol[mask] += 120.0
    return vol, mask


@pytest.mark.parametrize("kw", [dict(bin_width=25.0), dict(n_bins=8),
                                dict(n_bins=16, alpha=1)],
                         ids=["bin_width", "n_bins", "alpha"])
def test_compute_radiomics_every_family_matches_jax(kw):
    vol, mask = ellipsoid_case()
    sp = [1.0, 1.2, 2.5]
    out = TR.compute_radiomics(vol, mask, sp, **kw)
    assert_panel_close(out, JR.compute_radiomics(vol, mask, sp, **kw))
    for fam, feats in out.items():
        if fam != "meta":
            assert all(np.isfinite(v) for v in feats.values()), fam
    assert out["firstorder"]["Mean"] == pytest.approx(
        float(vol[mask].mean()), rel=1e-6)


def test_compute_radiomics_empty_and_family_selection():
    vol, mask = ellipsoid_case()
    empty = TR.compute_radiomics(vol, np.zeros_like(mask), [1, 1, 1],
                                 n_bins=8)
    assert_panel_close(empty, JR.compute_radiomics(
        vol, np.zeros_like(mask), [1, 1, 1], n_bins=8))
    assert empty["meta"]["voxels"] == 0
    for fams in (("firstorder",), ("shape", "glszm"), ("ngtdm", "gldm")):
        sub = TR.compute_radiomics(vol, mask, [1, 1, 1], n_bins=8,
                                   families=fams)
        assert_panel_close(sub, JR.compute_radiomics(
            vol, mask, [1, 1, 1], n_bins=8, families=fams))
    with pytest.raises(ValueError, match="matching"):
        TR.compute_radiomics(vol, mask[0], [1, 1, 1])


def test_shape_features_sphere_matches_jax():
    zz, yy, xx = np.mgrid[0:24, 0:24, 0:24]
    mask = ((zz - 12.0) ** 2 + (yy - 12.0) ** 2
            + (xx - 12.0) ** 2) <= 9.0 ** 2
    for sp in ([1.0, 1.0, 1.0], [1.0, 1.0, 3.0]):
        out = TR.shape_features(mask, sp)
        ref = JR.shape_features(mask, sp)
        for k, v in ref.items():
            assert out[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    out = TR.shape_features(mask, [1.0, 1.0, 1.0])
    assert out["MeshVolume"] == pytest.approx(4 / 3 * np.pi * 729, rel=0.05)


def test_radiomics_batch_matches_single_calls_and_jax():
    rng = np.random.default_rng(11)
    B, shape, sp = 4, (9, 11, 10), (1.0, 1.2, 2.0)
    vols = rng.normal(0, 50, size=(B,) + shape).astype(np.float32)
    masks = np.stack([rng.random(shape) < (0.4 + 0.1 * b)
                      for b in range(B)])
    masks[:, 0, 0, 0] = True
    out = radiomics_batch(vols, masks, sp, n_bins=6)
    ref = j_radiomics_batch(vols, masks, sp, n_bins=6)
    assert len(out) == B
    for b in range(B):
        assert_panel_close(out[b], ref[b])
        single = TR.compute_radiomics(vols[b], masks[b], sp, n_bins=6)
        for fam in ("firstorder", "glcm", "glrlm", "glszm", "gldm",
                    "ngtdm", "shape"):
            for k, v in single[fam].items():
                assert out[b][fam][k] == pytest.approx(
                    v, rel=1e-6, abs=1e-9), (b, fam, k)
        assert out[b]["meta"]["Ng"] == single["meta"]["Ng"]
    sub = radiomics_batch(vols, masks, sp, bin_width=20.0,
                          families=("glcm", "ngtdm"))
    sub_j = j_radiomics_batch(vols, masks, sp, bin_width=20.0,
                              families=("glcm", "ngtdm"))
    for b in range(B):
        assert_panel_close(sub[b], sub_j[b])
    with pytest.raises(ValueError):
        radiomics_batch(vols[:, 0], masks[:, 0], sp)
    # a 4-shard CPU mesh (one pair a data row) gives the same panels
    sharded = radiomics_batch(vols, masks, sp, n_bins=6,
                              mesh=make_mesh(4, devices=["cpu"] * 4))
    for b in range(B):
        assert_panel_close(sharded[b], out[b])
        assert sharded[b]["meta"] == out[b]["meta"]


def test_image_compute_radiomics_matches_jax(tmp_path):
    zz, yy, xx = np.mgrid[0:8, 0:24, 0:24]
    base = (400 * np.exp(-(((zz - 4) / 2.0) ** 2 + ((yy - 12) / 5.0) ** 2
                           + ((xx - 12) / 5.0) ** 2))).astype(np.int16)
    write_ct_series(tmp_path / "a", base, spacing=(1, 1), thickness=2.0)
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    jmia.read_dicoms(folder_path=str(tmp_path))
    ti = TData.image[TData.image_list[0]]
    ji = JData.image[JData.image_list[0]]
    mask = np.zeros(ti.array.shape, np.uint8)
    mask[2:6, 8:16, 8:16] = 1
    for img in (ti, ji):
        img.add_roi(roi_name="Cube", color=[255, 0, 0], visible=True)
        img.rois["Cube"].convert_mask(mask)
    out = ti.compute_radiomics("Cube", bin_width=50.0)
    assert out["meta"]["ROI"] == "Cube"
    assert_panel_close(out, ji.compute_radiomics("Cube", bin_width=50.0))
    values = np.asarray(ti.array, np.float32) * 0.5 + 3.0
    assert_panel_close(
        ti.compute_radiomics("Cube", values=values, n_bins=12,
                             families=("firstorder", "glcm")),
        ji.compute_radiomics("Cube", values=values, n_bins=12,
                             families=("firstorder", "glcm")))
    with pytest.raises(ValueError):
        ti.compute_radiomics("Cube", values=np.zeros((2, 2, 2)))
