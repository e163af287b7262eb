"""The port's gamma index (ops/gamma.py, Dose.compute_gamma,
parallel.batch.gamma_batch) against the JAX package's, on the CPU.

Tolerances, stated per check:
- the search layout and offset decomposition: equal;
- the fine-grid upsample: 1e-5 relative (the contractions sum in another
  order);
- gamma maps: within 1e-5, with ``pass_rate`` and ``analysed_voxels``
  equal. The scan body is ``d2 / dta2 + diff * diff / dd2`` in float32 in
  both, with no product-and-sum an FMA could contract, so the maps differ
  only through the fine grid they scan;
- ``compute_gamma`` across grids: the same 1e-5 (its resample's affine
  coordinates differ by a few ulp, ROADMAP.md queue 3).
"""

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import gamma as TG
from medicalimageanalysis_torch.parallel import batch as tbatch
from medicalimageanalysis_torch.parallel.mesh import make_mesh
from medicalimageanalysis_tpu.ops import gamma as JG
from medicalimageanalysis_tpu.parallel import batch as jbatch


@pytest.fixture(autouse=True)
def torch_env():
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    set_default_device(None)


def plan(shape, seed=0):
    """A smooth peaked dose of up to 60 Gy with a low-dose tail."""
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    c = [(n - 1) / 2 for n in shape]
    base = 60.0 * np.exp(-((zz - c[0]) ** 2 / 8 + (yy - c[1]) ** 2 / 30
                           + (xx - c[2]) ** 2 / 24)) + 2.0
    noise = np.random.default_rng(seed).normal(0, 0.3, shape)
    return (base + noise).astype(np.float32)


LAYOUTS = [((2.5, 2.5, 2.5), 3.0, None, 2.0), ((2.0, 2.0, 2.5), 2.0, None,
                                                1.5),
           ((1.0, 1.2, 3.0), 3.0, 2, 2.0)]


@pytest.mark.parametrize("spacing,dta,subdiv,cap", LAYOUTS)
def test_layout_and_decomposition_equal_jax(spacing, dta, subdiv, cap):
    t = TG.fine_grid_layout(spacing, dta, subdiv, cap)
    j = JG.fine_grid_layout(spacing, dta, subdiv, cap)
    assert t[:2] == j[:2]
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[3], j[3])
    np.testing.assert_array_equal(TG._decompose_offsets(t[2], t[0], t[1]),
                                  JG._decompose_offsets(j[2], j[0], j[1]))
    assert TG.fine_grid_shape((5, 7, 9), t[0], t[1]) == \
        JG.fine_grid_shape((5, 7, 9), j[0], j[1])
    np.testing.assert_array_equal(
        TG.fine_to_ref_pixel_matrix(t[0], t[1]),
        JG.fine_to_ref_pixel_matrix(j[0], j[1]))


def test_upsample_to_fine_matches_jax():
    ev = plan((6, 14, 12), seed=1)
    s, r, _, _ = TG.fine_grid_layout((2.5, 2.5, 2.5), 3.0)
    got = TG.upsample_to_fine(ev, s, r)
    ref = np.asarray(JG.upsample_to_fine(ev, s, r))
    assert got.shape == ref.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)
    assert float(got[0, 0, 0]) == float(TG._OUTSIDE)


CRITERIA = {
    "3%/3mm": dict(dose_pct=3.0, dta_mm=3.0),
    "2%/2mm": dict(dose_pct=2.0, dta_mm=2.0),
    "3%/3mm_local": dict(dose_pct=3.0, dta_mm=3.0, local=True),
    "3%/3mm_chunked": dict(dose_pct=3.0, dta_mm=3.0, chunk=2),
    "2%/2mm_local_chunked": dict(dose_pct=2.0, dta_mm=2.0, local=True,
                                 chunk=3),
}


@pytest.mark.parametrize("name", list(CRITERIA))
def test_gamma_index_matches_jax(name):
    kw = CRITERIA[name]
    spacing = (2.5, 2.5, 2.5)
    ref = plan((6, 14, 12))
    ev = (np.roll(ref, 1, axis=2) * 1.02).astype(np.float32)
    s, r, _, _ = JG.fine_grid_layout(spacing, kw["dta_mm"])
    fine = np.array(JG.upsample_to_fine(ev, s, r))
    got = TG.gamma_index(ref, torch.from_numpy(fine), spacing, **kw)
    want = JG.gamma_index(ref, fine, spacing, **kw)
    assert got["gamma"].dtype == np.float32
    np.testing.assert_allclose(got["gamma"], want["gamma"], rtol=0,
                               atol=1e-5)
    assert got["pass_rate"] == want["pass_rate"]
    assert got["analysed_voxels"] == want["analysed_voxels"]
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for key in ("mean", "max"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5)
    for key in ("norm_dose", "cap", "subdiv", "search_offsets"):
        assert got[key] == want[key], key
    assert 0.0 < got["pass_rate"] < 100.0


def test_gamma_index_rejects_bad_input():
    ref = np.full((2, 8, 8), 50.0, np.float32)
    with pytest.raises(ValueError, match="cap"):
        TG.gamma_index(ref, ref, [2.0, 2.0, 2.0], cap=0.5)
    with pytest.raises(ValueError, match="fine-grid shape"):
        TG.gamma_index(ref, ref, [2.0, 2.0, 2.0])


def mk_dose(dose_cls, array, spacing_xyz, origin):
    """A Dose on an axial grid from an array, as the JAX package's own
    gamma test builds one."""
    from types import SimpleNamespace
    return dose_cls(SimpleNamespace(
        array=array, image_set=[{}], plane="Axial",
        spacing=np.asarray(spacing_xyz, float),
        origin=np.asarray(origin, float),
        dimensions=np.asarray(array.shape),
        orientation=[1, 0, 0, 0, 1, 0], image_matrix=np.eye(3),
        dose_name="D", modality="RTDOSE", filepaths=[], sops=[]))


def field(shape, sp, org):
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    xs, ys, zs = (org[i] + v * sp[i] for i, v in enumerate((x, y, z)))
    return (20.0 + xs + 0.5 * ys + 0.25 * zs
            + 5.0 * np.sin(xs / 4.0)).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(dose_pct=2.0, dta_mm=2.0),
                                dict(dose_pct=3.0, dta_mm=2.0,
                                     norm_dose=100.0, subdiv=4)],
                         ids=["2%/2mm", "subdiv4"])
def test_compute_gamma_cross_grid_matches_jax(kw):
    from medicalimageanalysis_torch.dicom import Dataset as TDataset
    from medicalimageanalysis_torch.structure.dose import Dose as TDose
    from medicalimageanalysis_tpu.dicom import Dataset as JDataset
    from medicalimageanalysis_tpu.structure.dose import Dose as JDose

    ref_arr = field((6, 16, 16), [2.0, 2.0, 2.5], [0, 0, 0])
    ev_arr = field((10, 40, 40), [1.0, 1.0, 2.0], [-2, -2, -2]) + 1.0
    out = {}
    for key, cls, ds in (("t", TDose, TDataset), ("j", JDose, JDataset)):
        ref = mk_dose(cls, ref_arr, [2.0, 2.0, 2.5], [0, 0, 0])
        ev = mk_dose(cls, ev_arr, [1.0, 1.0, 2.0], [-2, -2, -2])
        ref.tags = ev.tags = [ds()]
        out[key] = ref.compute_gamma(ev, **kw)
    np.testing.assert_allclose(out["t"]["gamma"], out["j"]["gamma"],
                               rtol=0, atol=1e-5)
    assert out["t"]["pass_rate"] == out["j"]["pass_rate"]
    assert out["t"]["analysed_voxels"] == out["j"]["analysed_voxels"]


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_gamma_batch_matches_jax(local):
    B, shape, sp = 4, (6, 14, 12), (2.5, 2.5, 2.5)
    refs = np.stack([plan(shape, seed=i) * (1 + 0.05 * i) for i in range(B)])
    evals = np.stack([np.roll(r, 1, axis=2) * 1.02 for r in refs])
    refs[3] = 0.0                      # an all-zero reference pair
    got = tbatch.gamma_batch(refs, evals, sp, dose_pct=3.0, dta_mm=3.0,
                             local=local, return_maps=True)
    want = jbatch.gamma_batch(refs, evals, sp, dose_pct=3.0, dta_mm=3.0,
                              local=local, return_maps=True)
    np.testing.assert_allclose(got["gamma"], want["gamma"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["pass_rate"], want["pass_rate"])
    np.testing.assert_array_equal(got["analysed_voxels"],
                                  want["analysed_voxels"])
    assert got["analysed_voxels"].dtype == np.int32
    for key in ("mean", "max", "norm_dose"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                   err_msg=key)
    assert got["subdiv"] == want["subdiv"]
    assert got["search_offsets"] == want["search_offsets"]
    assert got["pass_rate"][3] == 100.0 and got["analysed_voxels"][3] == 0
    # each pair equals the per-pair path on the same fine grid
    s, r, _, _ = TG.fine_grid_layout(sp, 3.0)
    single = TG.gamma_index(refs[1], TG.upsample_to_fine(evals[1], s, r),
                            sp, local=local)
    np.testing.assert_allclose(got["gamma"][1], single["gamma"], atol=1e-5)


def test_gamma_batch_rejects_bad_input():
    refs = np.zeros((2, 4, 6, 6), np.float32)
    with pytest.raises(ValueError, match="cap"):
        tbatch.gamma_batch(refs, refs, (2.0, 2.0, 2.0), cap=0.5)
    with pytest.raises(ValueError, match="matching"):
        tbatch.gamma_batch(refs, refs[:, 0], (2.0, 2.0, 2.0))
    # a 2-shard CPU mesh runs the same call, equal to mesh=None
    refs = np.random.default_rng(3).uniform(0, 60, (2, 4, 6, 6)) \
        .astype(np.float32)
    got = tbatch.gamma_batch(refs, refs[::-1], (2.0, 2.0, 2.0),
                             return_maps=True,
                             mesh=make_mesh(2, devices=["cpu"] * 2))
    want = tbatch.gamma_batch(refs, refs[::-1], (2.0, 2.0, 2.0),
                              return_maps=True)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
