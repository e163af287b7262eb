"""Save and load in both packages, on the CPU: ``Image.save_image`` /
``load_image`` with the ROI and POI folders, ``Rigid.save_rigid`` /
``load_rigid``, ``Deformable.save_deformable`` / ``load_deformable``,
``Dose.save_image`` / ``load_image`` (the cases of tests/test_misc_io.py
and tests/test_deformable_dose.py), each folder saved by one package and
loaded by the other; and ``reader.check_memory`` without psutil.

Tolerances: none. Arrays, contours, points, matrices and fields are
bit-equal; names and collision suffixes equal. ``check_memory`` reads
/proc/meminfo's MemAvailable, psutil's figure on Linux: the two readings,
taken a moment apart, agree within 256 MB.
"""

import json
import os

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import square_contour_mm, write_ct_series, write_rtstruct
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.structure.deformable import (
    Deformable as TDeformable)
from medicalimageanalysis_torch.structure.dose import Dose as TDose
from medicalimageanalysis_torch.structure.image import Image as TImage
from medicalimageanalysis_torch.structure.rigid import Rigid as TRigid
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.structure.deformable import (
    Deformable as JDeformable)
from medicalimageanalysis_tpu.structure.dose import Dose as JDose
from medicalimageanalysis_tpu.structure.image import Image as JImage
from medicalimageanalysis_tpu.structure.rigid import Rigid as JRigid

PACKAGES = {"port": (TData, TImage, TRigid, TDeformable, TDose),
            "jax": (JData, JImage, JRigid, JDeformable, JDose)}


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


def read_both(**kw):
    jmia.read_dicoms(**kw)
    return tmia.read_dicoms(**kw)


def structures_case(tmp_path, rng):
    arr = rng.integers(-200, 800, size=(6, 16, 16)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr)
    rois = {"Liver": [(square_contour_mm(info, z, 4, 10), z)
                      for z in range(1, 4)],
            "PTV": [(square_contour_mm(info, z, 6, 12), z)
                    for z in range(2, 5)]}
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, rois,
                   pois={"Iso": [-95.0, -112.0, -45.0]})
    read_both(folder_path=str(tmp_path))
    return arr


def assert_same_image(t, j):
    np.testing.assert_array_equal(t.array, np.asarray(j.array))
    for key in ("spacing", "origin", "matrix", "dimensions",
                "orientation"):
        np.testing.assert_array_equal(np.asarray(getattr(t, key)),
                                      np.asarray(getattr(j, key)))
    assert t.image_name == j.image_name and t.modality == j.modality
    assert t.plane == j.plane and t.unverified == j.unverified
    assert sorted(t.rois) == sorted(j.rois)
    assert sorted(t.pois) == sorted(j.pois)
    for name, roi in t.rois.items():
        assert roi.color == j.rois[name].color
        if roi.contour_position is None:
            assert j.rois[name].contour_position is None
            continue
        for a, b in zip(roi.contour_position,
                        j.rois[name].contour_position):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(roi.compute_mask(),
                                      np.asarray(j.rois[name]
                                                 .compute_mask()))
    for name, poi in t.pois.items():
        np.testing.assert_array_equal(poi.point_position,
                                      j.pois[name].point_position)


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_image_save_load_across_packages(tmp_path, rng, saver):
    arr = structures_case(tmp_path, rng)
    data = PACKAGES[saver][0]
    data.image["CT 01"].save_image(str(tmp_path / "saved"))
    saved = tmp_path / "saved" / "CT 01"
    meta = json.loads((saved / "meta.json").read_text())
    assert meta["image_name"] == "CT 01" and meta["dimensions"] == [6, 16,
                                                                    16]
    TData.clear()
    JData.clear()
    t = TImage.load_image(str(saved))
    j = JImage.load_image(str(saved))
    assert TData.image_list == JData.image_list == ["CT 01"]
    assert t.device == torch.device("cpu")
    np.testing.assert_array_equal(t.array, arr)
    assert_same_image(t, j)
    assert len(t.rois["Liver"].contour_position) == 3


def test_load_rois_and_pois_suffix_like_jax(tmp_path, rng):
    structures_case(tmp_path, rng)
    for data in (TData, JData):
        img = data.image["CT 01"]
        img.save_rois(str(tmp_path / data.__module__))
        img.save_pois(str(tmp_path / data.__module__))
    for data in (TData, JData):
        img = data.image["CT 01"]
        img.load_rois(str(tmp_path / data.__module__ / "rois"))
        img.load_pois(str(tmp_path / data.__module__ / "pois"))
    t, j = TData.image["CT 01"], JData.image["CT 01"]
    assert sorted(t.rois) == sorted(j.rois) \
        == ["Liver", "Liver_2", "PTV", "PTV_2"]
    assert sorted(t.pois) == sorted(j.pois) == ["Iso", "Iso_2"]
    assert sorted(TData.roi_list) == sorted(JData.roi_list)
    assert_same_image(t, j)


def test_save_rois_create_main_folder(tmp_path, rng):
    structures_case(tmp_path, rng)
    img = TData.image["CT 01"]
    img.save_rois(str(tmp_path / "out"), create_main_folder=True)
    img.save_pois(str(tmp_path / "out"), create_main_folder=True)
    base = tmp_path / "out" / "CT 01"
    assert (base / "rois" / "PTV" / "roi.json").exists()
    assert (base / "rois" / "PTV" / "contour_0000.npy").exists()
    assert (base / "pois" / "Iso" / "point.npy").exists()
    img.save_rois(str(tmp_path / "flat"))
    assert (tmp_path / "flat" / "rois" / "PTV" / "roi.json").exists()
    JData.image["CT 01"].save_rois(str(tmp_path / "jflat"))
    for roi in ("PTV", "Liver"):
        files = sorted(os.listdir(tmp_path / "flat" / "rois" / roi))
        assert files == sorted(os.listdir(tmp_path / "jflat" / "rois"
                                          / roi))
        for f in files:
            a = tmp_path / "flat" / "rois" / roi / f
            b = tmp_path / "jflat" / "rois" / roi / f
            assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_rigid_save_load_across_packages(tmp_path, rng, saver):
    arr = rng.integers(0, 100, size=(4, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "a", arr)
    write_ct_series(tmp_path / "b", arr, modality="MR")
    read_both(folder_path=str(tmp_path))
    rigids = (TRigid("CT 01", "MR 02", device="cpu"),
              JRigid("CT 01", "MR 02"))
    for r in rigids:
        r.update_translation(t_x=3)
        r.update_rotation(r_z=4)
        r.inverse = True
    src = rigids[0] if saver == "port" else rigids[1]
    src.save_rigid(str(tmp_path / "rigid_out"))
    t = TRigid.load_rigid(str(tmp_path / "rigid_out"))
    j = JRigid.load_rigid(str(tmp_path / "rigid_out"))
    assert t.rigid_name == j.rigid_name == "CT 01_MR 02"
    assert TData.rigid_list == JData.rigid_list \
        == ["CT 01_MR 02", "CT 01_MR 02"]
    for key in ("matrix", "reference_matrix", "combo_matrix",
                "rotation_center"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key))
    np.testing.assert_array_equal(t.matrix, rigids[0].matrix)
    assert t.inverse is True and t.roi_names == j.roi_names
    assert t.device == torch.device("cpu")


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_deformable_save_load_across_packages(tmp_path, saver):
    rng = np.random.default_rng(5)
    dvf = rng.normal(0, 1.5, size=(4, 8, 8, 3)).astype(np.float32)
    rigid = np.eye(4)
    rigid[0, 3] = 2.5
    kw = dict(origin=np.array([0.0, 0.0, 0.0]), spacing=(2.0, 2.0, 2.0),
              dimensions=np.array([4, 8, 8]), rigid_matrix=rigid,
              registration_name="Fraction2_DVF", roi_names=[])
    if saver == "port":
        src = TDeformable(dvf=torch.from_numpy(dvf.copy()), device="cpu",
                          **kw)
    else:
        src = JDeformable(dvf=dvf, **kw)
    src.save_deformable(str(tmp_path / "defo"))
    TData.clear()
    JData.clear()
    t = TDeformable.load_deformable(str(tmp_path / "defo"))
    j = JDeformable.load_deformable(str(tmp_path / "defo"))
    assert TData.deformable_list == JData.deformable_list \
        == ["Fraction2_DVF"]
    assert isinstance(t.dvf, torch.Tensor) and t.dvf.device.type == "cpu"
    np.testing.assert_array_equal(t.dvf.numpy(), dvf)
    np.testing.assert_array_equal(t.dvf.numpy(), np.asarray(j.dvf))
    np.testing.assert_array_equal(t.rigid_matrix, j.rigid_matrix)
    np.testing.assert_array_equal(np.asarray(t.spacing), np.asarray(
        j.spacing))
    qa, jqa = t.compute_jacobian(), j.compute_jacobian()
    np.testing.assert_allclose(qa["det_mean"], jqa["det_mean"], rtol=1e-6)
    # a taken name loads under the saved name, collision-suffixed
    t2 = TDeformable.load_deformable(str(tmp_path / "defo"))
    j2 = JDeformable.load_deformable(str(tmp_path / "defo"))
    assert t2.deformable_name == j2.deformable_name == "Fraction2_DVF_1"


def dose_holder(dataset):
    class H:
        pass
    h = H()
    h.array = np.linspace(0, 60, 4 * 8 * 8).reshape(4, 8, 8) \
        .astype(np.float32)
    h.image_set = [dataset]
    h.plane = "Axial"
    h.spacing = np.array([2.0, 2.0, 2.5])
    h.origin = np.array([-10.0, -20.0, -5.0])
    h.dimensions = np.array([4, 8, 8])
    h.orientation = [1, 0, 0, 0, 1, 0]
    h.image_matrix = np.eye(3)
    h.dose_name = "RTDOSE 01"
    h.modality = "RTDOSE"
    h.filepaths, h.sops, h.unverified = [], ["1.2.3"], []
    return h


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_dose_save_load_across_packages(tmp_path, saver):
    from medicalimageanalysis_tpu.dicom import Dataset

    data, _, _, _, Dose = PACKAGES[saver]
    ds = Dataset()
    ds.SeriesDate = "20240102"
    ds.PatientBirthDate = "19500101"
    ds.PatientID = "MRN7"
    h = dose_holder(ds)
    d = Dose(h)
    data.dose["RTDOSE 01"] = d
    data.dose_list += ["RTDOSE 01"]
    d.save_image(str(tmp_path))
    TData.clear()
    JData.clear()
    t = TDose.load_image(str(tmp_path / "RTDOSE 01"))
    j = JDose.load_image(str(tmp_path / "RTDOSE 01"))
    assert TData.dose_list == JData.dose_list == ["RTDOSE 01"]
    np.testing.assert_array_equal(t.array, h.array)
    np.testing.assert_array_equal(t.array, np.asarray(j.array))
    for key in ("origin", "spacing", "matrix", "dimensions", "sops",
                "mrn", "birthdate"):
        np.testing.assert_array_equal(np.asarray(getattr(t, key)),
                                      np.asarray(getattr(j, key)))
    assert str(t.date) == str(j.date) == "20240102"
    assert t.compute_dose_statistics() == pytest.approx(
        j.compute_dose_statistics())
    t3 = TDose.load_image(str(tmp_path / "RTDOSE 01"))
    assert t3.dose_name == "RTDOSE 01_1"
    assert TData.dose_list == ["RTDOSE 01", "RTDOSE 01_1"]


def test_loaders_raise_without_a_card_unless_the_cpu_is_asked(
        tmp_path, rng, monkeypatch):
    structures_case(tmp_path, rng)
    img = TData.image["CT 01"]
    img.save_image(str(tmp_path / "saved"))
    TRigid("CT 01", "CT 01", device="cpu").save_rigid(str(tmp_path / "r"))
    TDeformable(dvf=np.zeros((2, 2, 2, 3), np.float32), origin=[0, 0, 0],
                spacing=(1, 1, 1), dimensions=[2, 2, 2], roi_names=[],
                device="cpu").save_deformable(str(tmp_path / "d"))
    set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: TImage.load_image(str(tmp_path / "saved" / "CT 01")),
             lambda: TRigid.load_rigid(str(tmp_path / "r")),
             lambda: TDeformable.load_deformable(str(tmp_path / "d")),
             lambda: TDose.load_image(str(tmp_path / "none"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    loaded = TImage.load_image(str(tmp_path / "saved" / "CT 01"),
                               device="cpu")
    assert loaded.device == "cpu"


def test_check_memory_reads_meminfo(tmp_path):
    import psutil

    from medicalimageanalysis_torch.reader import available_memory_bytes

    (tmp_path / "a.dcm").write_bytes(b"x" * 1024)
    files = tmia.file_parser(folder_path=str(tmp_path))
    remaining = tmia.check_memory(files)
    assert np.isfinite(remaining) and remaining > 0
    assert abs(available_memory_bytes()
               - psutil.virtual_memory().available) < 256 * 2 ** 20
    assert abs(remaining - jmia.check_memory(files)) < 0.25
    fake = tmp_path / "meminfo"
    fake.write_text("MemTotal: 100 kB\nMemAvailable:  2048 kB\n")
    assert available_memory_bytes(str(fake)) == 2048 * 1024
    fake.write_text("MemTotal: 100 kB\n")
    with pytest.raises(ValueError, match="MemAvailable"):
        available_memory_bytes(str(fake))
