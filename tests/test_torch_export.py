"""The writers and file codecs of the IO slice in both packages, on the
CPU: ``Image.create_rtstruct``, ``Dose.create_rtdose``,
``Image.export_dicom``, the NIfTI codec with ``Image.create_nifti`` /
``read_nifti``, and the MHD codec with ``MhdReader``'s image, ROI, dose and
DVF branches and ``Image.input_mhd``. Each file is written by one package
and read by the other (the cases of tests/test_rtstruct_writer.py,
tests/test_nifti_write.py, the RTDOSE cases of
tests/test_deformable_dose.py and the MHD and export cases of
tests/test_misc_io.py).

Tolerances, stated per check:
- arrays, masks, stored pixel bytes and the int16 quantisation: equal;
  the rescale slope and intercept to the JAX writer's 10 digits;
- datasets: equal element by element, the generated UIDs masked;
- geometry read back from NIfTI: the values the JAX package reads from
  the same file (bit-equal); against the source grid within 1e-4 mm,
  since the sform holds float32;
- RTDOSE: the stored integers within DoseGridScaling / 2 of the source
  grid (float64); the grid read back within that plus the reader's
  float32 roundings (``read_back_bound``);
- a float volume exported with export_dicom and read back: the stored
  int16 values equal, the rescaled floats within one float32 ulp of the
  rescale's largest term of the JAX package's (its reader's FMA,
  ROADMAP.md queue 3).
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import square_contour_mm, write_ct_series, write_rtstruct
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.read import mhd as tmhd
from medicalimageanalysis_torch.read import nifti as tnifti
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.dicom import Dataset, Sequence, dcmwrite
from medicalimageanalysis_tpu.read import mhd as jmhd
from medicalimageanalysis_tpu.read import nifti as jnifti
from test_deformable_dose import make_blob, write_rtdose_file
from test_torch_reg import assert_same_dataset


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


# -- RTSTRUCT ---------------------------------------------------------------
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rtstruct_write_read_round_trips_across_packages(tmp_path, rng,
                                                         writer):
    arr = rng.integers(-500, 1000, size=(8, 24, 24)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr)
    rois = {"Liver": [(square_contour_mm(info, z, 4, 12), z)
                      for z in range(2, 6)],
            "Cord": [(square_contour_mm(info, z, 14, 18), z)
                     for z in range(0, 8)]}
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, rois,
                   {"Isocenter": [-90.0, -110.0, -45.0]})
    read_both(folder_path=str(tmp_path))
    t_ds = TData.image["CT 01"].create_rtstruct()
    j_ds = JData.image["CT 01"].create_rtstruct()
    assert_same_dataset(t_ds, j_ds)
    before = {n: TData.image["CT 01"].rois[n].compute_mask()
              for n in rois}
    out = tmp_path / "rs_out.dcm"
    dcmwrite(str(out), t_ds if writer == "port" else j_ds)
    files = [str(p) for p in (tmp_path / "ct").glob("*.dcm")
             if p.name != "rs.dcm"] + [str(out)]
    read_both(file_list=files)
    t, j = TData.image["CT 01"], JData.image["CT 01"]
    assert sorted(t.rois) == sorted(j.rois) == ["Cord", "Liver"]
    assert list(t.pois) == list(j.pois) == ["Isocenter"]
    masks = t.compute_roi_masks()
    for name in rois:
        np.testing.assert_array_equal(masks[name], before[name])
        np.testing.assert_array_equal(masks[name],
                                      np.asarray(j.rois[name]
                                                 .compute_mask()))
        for a, b in zip(t.rois[name].contour_position,
                        j.rois[name].contour_position):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.pois["Isocenter"].point_position,
                                  j.pois["Isocenter"].point_position)


def test_rtstruct_of_a_mask_only_roi_traces_its_contours(tmp_path, rng):
    """A ROI made from a mask writes the port's tracer's contours; read
    back, its rasterized mask equals the JAX package's."""
    arr = rng.integers(-500, 1000, size=(6, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr)
    read_both(folder_path=str(tmp_path))
    mask = np.zeros(arr.shape, np.uint8)
    mask[1:5, 3:11, 4:12] = 1
    mask[2, 5:8, 6:9] = 0
    for data in (TData, JData):
        img = data.image["CT 01"]
        img.create_roi(name="Auto", color=[0, 200, 0])
        img.rois["Auto"].convert_mask(mask)
    t_ds = TData.image["CT 01"].create_rtstruct(path=str(tmp_path / "ct"
                                                          / "rs.dcm"))
    assert_same_dataset(t_ds, JData.image["CT 01"].create_rtstruct())
    read_both(folder_path=str(tmp_path))
    np.testing.assert_array_equal(
        TData.image["CT 01"].rois["Auto"].compute_mask(),
        np.asarray(JData.image["CT 01"].rois["Auto"].compute_mask()))


# -- RTDOSE -----------------------------------------------------------------
def dose_case(tmp_path, rng, dose_raw):
    arr = rng.integers(-500, 500, size=dose_raw.shape).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr, spacing=(1, 1),
                           thickness=2.0)
    write_rtdose_file(tmp_path / "ct" / "rd.dcm", dose_raw, info)
    read_both(folder_path=str(tmp_path))
    return TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]


def read_back_bound(src, scaling):
    """How far a grid read back from its RTDOSE may lie from ``src``:
    the writer's rounding (DoseGridScaling / 2), the reader's uint32 ->
    float32 rounding of the stored value (at most 128 below 2^32), its
    float32 DoseGridScaling (2^-24 of the largest dose) and the float32
    rounding of the product (half an ulp of the largest dose)."""
    top = np.float32(np.abs(src).max())
    return scaling * (0.5 + 128) + 1.0001 * float(top) * 2.0 ** -24 \
        + float(np.spacing(top)) / 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_create_rtdose_round_trips_across_packages(tmp_path, writer):
    rng = np.random.default_rng(11)
    dose_raw = np.zeros((8, 24, 24), np.uint32)
    dose_raw[2:6, 6:15, 6:15] = 61234
    dose_raw[3, 8:12, 9:13] = rng.integers(0, 70000, size=(4, 4))
    t, j = dose_case(tmp_path, rng, dose_raw)
    src = np.asarray(t.array).copy()
    t_ds = t.create_rtdose(dose_summation_type="MULTI_PLAN")
    j_ds = j.create_rtdose(dose_summation_type="MULTI_PLAN")
    assert_same_dataset(t_ds, j_ds)
    assert bytes(t_ds.PixelData) == bytes(j_ds.PixelData)
    out = tmp_path / "export"
    out.mkdir()
    dcmwrite(str(out / "rd.dcm"), t_ds if writer == "port" else j_ds)
    read_both(folder_path=str(out))
    back, jback = TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]
    np.testing.assert_array_equal(back.array, np.asarray(jback.array))
    scaling = float(t_ds.DoseGridScaling)
    stored = np.frombuffer(t_ds.PixelData, "<u4").reshape(src.shape)
    assert np.abs(stored * scaling - src.astype(np.float64)).max() \
        <= scaling / 2
    assert np.abs(back.array - src).max() <= read_back_bound(src, scaling)
    np.testing.assert_array_equal(back.origin, jback.origin)
    np.testing.assert_array_equal(back.matrix, jback.matrix)
    assert back.frame_ref == t.frame_ref


def test_create_rtdose_rejects_negative(tmp_path, rng):
    t, j = dose_case(tmp_path, rng, np.full((6, 16, 16), 1000, np.uint32))
    t.array = np.asarray(t.array) - 2.0
    with pytest.raises(ValueError, match="negative"):
        t.create_rtdose()


def test_create_rtdose_from_a_device_tensor(tmp_path, rng):
    """A grid held as a tensor is downloaded once; the dataset equals the
    one written from the numpy grid."""
    t, _ = dose_case(tmp_path, rng, np.full((4, 8, 8), 1234, np.uint32))
    ref = t.create_rtdose()
    t.array = torch.from_numpy(np.asarray(t.array).copy())
    assert_same_dataset(t.create_rtdose(), ref)


def test_create_rtdose_coronal_grid_round_trip(tmp_path):
    """A coronal-acquired grid writes pixel-axis geometry for the
    canonical (z, y, x) array, as the JAX package's writer does."""
    from medicalimageanalysis_tpu.utils.creation import CreateDicomImage

    rng = np.random.default_rng(13)
    arr = rng.integers(-500, 500, size=(6, 16, 16)).astype(np.int16)
    gen = CreateDicomImage(str(tmp_path / "ct"), arr,
                           origin=[-50, -60, -40], spacing=[1.0, 1.0],
                           thickness=2.0)
    gen.orientation = [1, 0, 0, 0, 0, -1]
    gen.run()
    read_both(folder_path=str(tmp_path))
    img = TData.image["CT 01"]
    info = {"frame": img.frame_ref, "origin": img.origin,
            "spacing": [float(img.spacing[0]), float(img.spacing[1])],
            "thickness": float(img.spacing[2])}
    dose_raw = np.zeros(img.array.shape, np.uint32)
    dose_raw[3:9, 2:5, 6:15] = 45000
    write_rtdose_file(tmp_path / "ct" / "rd.dcm", dose_raw, info)
    read_both(folder_path=str(tmp_path))
    t, j = TData.dose["RTDOSE 01"], JData.dose["RTDOSE 01"]
    t_ds = t.create_rtdose(path=str(tmp_path / "rd_out.dcm"))
    assert_same_dataset(t_ds, j.create_rtdose())
    read_both(file_list=[str(tmp_path / "rd_out.dcm")])
    back = TData.dose["RTDOSE 01"]
    np.testing.assert_allclose(back.array, np.asarray(t.array), atol=1e-4)
    np.testing.assert_allclose(back.origin, t.origin, atol=1e-6)
    np.testing.assert_allclose(back.matrix, t.matrix, atol=1e-6)


# -- export_dicom -----------------------------------------------------------
@pytest.mark.parametrize("kind", ["int16", "float", "wide"])
def test_export_dicom_stored_values_equal_jax(tmp_path, rng, kind):
    arr = rng.integers(-800, 1200, size=(5, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr)
    read_both(folder_path=str(tmp_path / "ct"))
    t, j = TData.image["CT 01"], JData.image["CT 01"]
    if kind != "int16":
        values = rng.normal(0, 300, size=arr.shape).astype(np.float32)
        if kind == "wide":
            values = (values * 1000).astype(np.int32)
        t.array, j.array = values.copy(), values.copy()
    t.export_dicom(tmp_path / "t_out")
    j.export_dicom(tmp_path / "j_out")
    from medicalimageanalysis_torch.dicom import dcmread
    tfiles = sorted((tmp_path / "t_out").glob("*.dcm"))
    jfiles = sorted((tmp_path / "j_out").glob("*.dcm"))
    assert len(tfiles) == len(jfiles) == arr.shape[0]
    for tf, jf in zip(tfiles, jfiles):
        a, b = dcmread(str(tf)), dcmread(str(jf))
        assert bytes(a.PixelData) == bytes(b.PixelData)
        # the port's writer keeps DS values at up to 16 characters, the
        # JAX package's at 10 significant digits
        for key in ("RescaleSlope", "RescaleIntercept"):
            x, y = float(getattr(a, key)), float(getattr(b, key))
            assert abs(x - y) <= 5e-10 * abs(y), (key, x, y)
        assert list(a.ImagePositionPatient) == list(b.ImagePositionPatient)
        assert list(a.ImageOrientationPatient) \
            == list(b.ImageOrientationPatient)
    read_both(folder_path=str(tmp_path / "t_out"))
    back = TData.image["CT 01"]
    jback = np.asarray(JData.image["CT 01"].array)
    if kind == "int16":
        np.testing.assert_array_equal(back.array, arr)
        np.testing.assert_array_equal(back.array, jback)
    else:
        # the readers' float32 rescale stored * slope + intercept: XLA
        # fuses it into an FMA, the port does not (ROADMAP.md queue 3),
        # so they agree to an ulp of its largest term
        top = abs(float(a.RescaleSlope)) * 32768 \
            + abs(float(a.RescaleIntercept))
        assert np.abs(back.array - jback).max() \
            <= np.spacing(np.float32(top))
    np.testing.assert_allclose(back.origin, t.origin)
    np.testing.assert_allclose(back.spacing, t.spacing)


def test_export_dicom_keeps_pet_suv_tags(tmp_path):
    from medicalimageanalysis_tpu.utils.creation import CreateDicomImage

    info = Dataset()
    info.RadionuclideTotalDose = 3.5e8
    info.RadionuclideHalfLife = 6586.2
    info.RadiopharmaceuticalStartTime = "080000"
    CreateDicomImage(str(tmp_path / "pt"),
                     np.full((4, 16, 16), 5000, np.int16),
                     spacing=[2.0, 2.0], thickness=3.0).run(
        modality="PT", rescale_slope=1.0,
        extra_tags={"Units": "BQML", "DecayCorrection": "ADMIN",
                    "PatientWeight": 70.0,
                    "RadiopharmaceuticalInformationSequence":
                        Sequence([info])})
    tmia.read_dicoms(folder_path=str(tmp_path / "pt"))
    pt = TData.image[TData.image_list[0]]
    suv = pt.compute_suv()
    pt.export_dicom(str(tmp_path / "out"))
    read_both(folder_path=str(tmp_path / "out"))
    back = TData.image[TData.image_list[0]]
    np.testing.assert_array_equal(back.compute_suv(), suv)
    np.testing.assert_array_equal(
        back.compute_suv(),
        np.asarray(JData.image[JData.image_list[0]].compute_suv()))


def test_export_dicom_without_an_array_raises(tmp_path, rng):
    arr = rng.integers(0, 100, size=(2, 8, 8)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr)
    tmia.read_dicoms(folder_path=str(tmp_path), only_tags=True)
    img = TData.image["CT 01"]
    with pytest.raises(ValueError, match="no array"):
        img.export_dicom(str(tmp_path / "out"))
    with pytest.raises(ValueError, match="no array"):
        img.create_nifti(str(tmp_path / "x.nii"))


# -- NIfTI ------------------------------------------------------------------
MATRICES = {"identity": np.eye(3),
            "rot90_z": np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0],
                                 [0.0, 0.0, 1.0]])}


@pytest.mark.parametrize("ext", ["vol.nii", "vol.nii.gz"])
@pytest.mark.parametrize("dtype", ["int16", "float32", "uint8", "int64"])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_nifti_codec_round_trips_across_packages(tmp_path, ext, dtype,
                                                 matrix):
    rng = np.random.default_rng(1)
    arr = (rng.normal(0, 1e3, size=(5, 12, 10))).astype(dtype)
    spacing, origin = [0.9, 1.1, 2.5], [-50.0, -60.5, 12.25]
    m = MATRICES[matrix]
    for writer, readers in ((tnifti, (tnifti, jnifti)),
                            (jnifti, (tnifti, jnifti))):
        p = tmp_path / ext
        writer.write_nifti_volume(p, arr, spacing, origin, m)
        (a, sp, org, mat), (b, jsp, jorg, jmat) = (
            r.read_nifti_volume(p) for r in readers)
        np.testing.assert_array_equal(a, arr)
        np.testing.assert_array_equal(a, b)
        for x, y in ((sp, jsp), (org, jorg), (mat, jmat)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(sp, spacing, atol=1e-5)
        np.testing.assert_allclose(org, origin, atol=1e-4)
        np.testing.assert_allclose(mat, m, atol=1e-6)


def test_nifti_bool_maps_write_as_uint8(tmp_path):
    mask = np.zeros((3, 6, 6), bool)
    mask[1, 2:4, 2:4] = True
    tnifti.write_nifti_volume(tmp_path / "m.nii", mask, [1, 1, 1],
                              [0, 0, 0], np.eye(3))
    back, _, _, _ = jnifti.read_nifti_volume(tmp_path / "m.nii")
    np.testing.assert_array_equal(back, mask.astype(np.uint8))


def test_image_create_nifti_and_read_nifti_match_jax(tmp_path, rng):
    arr = rng.integers(-500, 1500, size=(6, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr, spacing=(0.5, 1.25),
                    thickness=2.5)
    read_both(folder_path=str(tmp_path))
    t, j = TData.image["CT 01"], JData.image["CT 01"]
    t.create_nifti(str(tmp_path / "t.nii.gz"))
    j.create_nifti(str(tmp_path / "j.nii.gz"))
    assert tnifti.read_nifti_volume(tmp_path / "t.nii.gz")[0].tobytes() \
        == jnifti.read_nifti_volume(tmp_path / "j.nii.gz")[0].tobytes()
    reader = tmia.read_nifti(str(tmp_path / "t.nii.gz"),
                             image_name="FromNifti")
    jmia.read_nifti(str(tmp_path / "t.nii.gz"), image_name="FromNifti")
    img2, jimg2 = TData.image["FromNifti"], JData.image["FromNifti"]
    assert reader.device == torch.device("cpu")
    np.testing.assert_array_equal(img2.array, arr)
    np.testing.assert_array_equal(img2.array, np.asarray(jimg2.array))
    for key in ("origin", "spacing", "matrix", "dimensions"):
        np.testing.assert_array_equal(getattr(img2, key),
                                      getattr(jimg2, key))
    np.testing.assert_allclose(img2.origin, t.origin, atol=1e-4)
    np.testing.assert_allclose(img2.spacing, t.spacing, atol=1e-5)
    # a voxel-aligned map exports too; a mismatched one raises
    mask = (arr > 0).astype(np.uint8)
    t.create_nifti(str(tmp_path / "mask.nii.gz"), values=mask)
    np.testing.assert_array_equal(
        jnifti.read_nifti_volume(tmp_path / "mask.nii.gz")[0], mask)
    with pytest.raises(ValueError, match="values shape"):
        t.create_nifti(str(tmp_path / "x.nii"), values=np.zeros((1, 2, 3)))
    # a name from the file, as the JAX package gives it
    tmia.read_nifti(str(tmp_path / "j.nii.gz"))
    assert "j" in TData.image_list


def test_nifti_byte_flip_fuzz(tmp_path):
    rng = np.random.default_rng(21)
    arr = rng.integers(-500, 1500, size=(4, 10, 10)).astype(np.int16)
    src = tmp_path / "v.nii"
    tnifti.write_nifti_volume(src, arr, [1, 1, 2], [0, 0, 0], np.eye(3))
    good = src.read_bytes()
    mut = tmp_path / "mut.nii"
    for _ in range(60):
        blob = bytearray(good)
        for _ in range(int(rng.integers(1, 12))):
            blob[int(rng.integers(0, len(blob)))] = int(
                rng.integers(0, 256))
        mut.write_bytes(bytes(blob))
        TData.clear()
        try:
            tmia.read_nifti(str(mut))
        except (ValueError, OSError, EOFError):
            pass  # a typed rejection is the contract


# -- MHD ----------------------------------------------------------------------
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("dtype", ["int16", "float32", "uint8"])
def test_mhd_codec_round_trips_across_packages(tmp_path, compressed, dtype):
    rng = np.random.default_rng(4)
    vol = rng.normal(0, 100, size=(4, 8, 6)).astype(dtype)
    direction = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0, 0, 1.0]])
    for writer in (tmhd, jmhd):
        p = writer.write_mhd_volume(str(tmp_path / "v"), vol,
                                    spacing=[0.5, 1.5, 2.5],
                                    origin=[-1.25, 3.5, 7.0],
                                    direction=direction,
                                    compressed=compressed)
        a = tmhd.read_mhd_volume(p)
        b = jmhd.read_mhd_volume(p)
        assert a[0].dtype == vol.dtype
        np.testing.assert_array_equal(a[0], vol)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[3], direction)


def test_mhd_corrupt_raises_clean_valueerror(tmp_path, rng):
    vol = rng.normal(size=(4, 8, 8)).astype(np.float32)
    p = tmp_path / "v.mhd"
    tmhd.write_mhd_volume(str(p), vol, spacing=[1, 1, 2], origin=[0, 0, 0])
    good = p.read_bytes()
    for _ in range(60):
        blob = bytearray(good)
        for _ in range(int(rng.integers(1, 10))):
            blob[int(rng.integers(0, len(blob)))] = int(
                rng.integers(0, 256))
        p.write_bytes(bytes(blob))
        try:
            tmhd.read_mhd_volume(str(p))
        except (ValueError, FileNotFoundError):
            pass
    p.write_bytes(good)
    np.testing.assert_array_equal(tmhd.read_mhd_volume(str(p))[0], vol)


def test_read_mhd_image_matches_jax(tmp_path, rng):
    vol = rng.integers(-1000, 1000, size=(5, 12, 10)).astype(np.int16)
    p = tmhd.write_mhd_volume(str(tmp_path / "scan"), vol,
                              spacing=[0.7, 0.8, 3.0], origin=[1, 2, 3])
    reader = tmia.read_mhd(file=p)
    jmia.read_mhd(file=p)
    assert TData.image_list == JData.image_list == ["scan"]
    assert reader.device == torch.device("cpu")
    t, j = TData.image["scan"], JData.image["scan"]
    np.testing.assert_array_equal(t.array, vol)
    for key in ("origin", "spacing", "matrix", "dimensions"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key))
    tmia.read_mhd(file=p, modality="MR")
    jmia.read_mhd(file=p, modality="MR")
    assert TData.image_list == JData.image_list == ["scan", "MR 02"]


def test_mhd_roi_branch_and_input_mhd_match_jax(tmp_path, rng):
    arr = rng.normal(0, 50, (6, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr, spacing=(1, 1), thickness=2.0)
    read_both(folder_path=str(tmp_path / "ct"))
    t, j = TData.image["CT 01"], JData.image["CT 01"]
    mask = np.zeros(arr.shape, np.uint8)
    mask[2:5, 4:12, 5:13] = 1
    p = tmhd.write_mhd_volume(str(tmp_path / "roi"), mask,
                              spacing=t.spacing, origin=t.origin)
    tmia.read_mhd(file=p, reference_name="CT 01", roi_name="Liver")
    jmia.read_mhd(file=p, reference_name="CT 01", roi_name="Liver")
    np.testing.assert_array_equal(t.rois["Liver"].compute_mask(), mask)
    labels = np.zeros(arr.shape, np.uint8)
    labels[1:3, 2:8, 2:8] = 1
    labels[4:6, 8:14, 8:14] = 2
    p2 = tmhd.write_mhd_volume(str(tmp_path / "labels"), labels,
                               spacing=t.spacing, origin=t.origin)
    tmia.read_mhd(file=p2, reference_name="CT 01", roi_names=["A", "B"])
    jmia.read_mhd(file=p2, reference_name="CT 01", roi_names=["A", "B"])
    t.input_mhd(p2, ["C"], [2])
    j.input_mhd(p2, ["C"], [2])
    for name in ("Liver", "A", "B", "C"):
        np.testing.assert_array_equal(
            t.rois[name].compute_mask(),
            np.asarray(j.rois[name].compute_mask()))
    np.testing.assert_array_equal(t.rois["C"].compute_mask(),
                                  (labels == 2).astype(np.uint8))
    bad = tmhd.write_mhd_volume(str(tmp_path / "bad"),
                                np.zeros((3, 4, 4), np.uint8))
    with pytest.raises(ValueError, match="does not match"):
        tmia.read_mhd(file=bad, reference_name="CT 01", roi_name="X")


def test_mhd_dose_and_dvf_branches_match_jax(tmp_path, rng):
    write_ct_series(tmp_path / "ct", np.zeros((6, 16, 16), np.int16),
                    spacing=(1, 1), thickness=2.0)
    write_ct_series(tmp_path / "mr", np.zeros((6, 16, 16), np.int16),
                    spacing=(1, 1), thickness=2.0, modality="MR")
    read_both(folder_path=str(tmp_path))
    dose_vals = rng.uniform(0, 70, (6, 16, 16)).astype(np.float32)
    p = tmhd.write_mhd_volume(str(tmp_path / "dose"), dose_vals,
                              spacing=[1, 1, 2], origin=[0, 0, 0])
    for pkg in (tmia, jmia):
        pkg.read_mhd(file=p, reference_name="CT 01", dose=True)
        pkg.read_mhd(file=p, reference_name="CT 01", dose=0.5,
                     dose_name="half")
    assert TData.dose_list == JData.dose_list == ["RTDOSE 01", "half"]
    for name in TData.dose_list:
        np.testing.assert_array_equal(TData.dose[name].array,
                                      np.asarray(JData.dose[name].array))
    assert TData.dose["half"].frame_ref == TData.image["CT 01"].frame_ref

    field = rng.normal(0, 1, (6, 16, 16, 3)).astype(np.float32)
    p = tmhd.write_mhd_volume(str(tmp_path / "dvf"), field,
                              spacing=[1, 1, 2], origin=[0, 0, 0])
    for pkg in (tmia, jmia):
        pkg.read_mhd(file=p, reference_name="CT 01", moving_name="MR 02",
                     dvf=True)
    name = "DVF_CT 01_MR 02"
    assert TData.deformable_list == JData.deformable_list == [name]
    t = TData.deformable[name]
    assert isinstance(t.dvf, torch.Tensor)
    np.testing.assert_array_equal(t.dvf.numpy(),
                                  np.asarray(JData.deformable[name].dvf))


def test_registration_export_image_writes_create_image(tmp_path):
    """Rigid.export_image and Deformable.export_image write create_image
    as MHD; each file equals the JAX package's export of the same
    registration (the port's warp kernels' plain versions on the CPU
    against XLA: the tolerance of tests/test_torch_rigid.py and
    tests/test_torch_deformable.py, 1e-3 of the volume's range)."""
    base = make_blob(shape=(8, 24, 24)).astype(np.int16)
    write_ct_series(tmp_path / "ct", base, spacing=(1, 1), thickness=2.0)
    write_ct_series(tmp_path / "mr", np.roll(base, 2, axis=2),
                    spacing=(1, 1), thickness=2.0, modality="MR")
    read_both(folder_path=str(tmp_path))
    m = np.eye(4)
    m[:3, 3] = [1.5, -1.0, 0.5]
    dvf = np.random.default_rng(2).normal(0, 0.5, (8, 24, 24, 3)) \
        .astype(np.float32)
    ref = TData.image["CT 01"]
    kw = dict(origin=ref.origin, spacing=ref.spacing,
              dimensions=ref.dimensions, rigid_matrix=m,
              reference_name="CT 01", moving_name="MR 02", roi_names=[])
    regs = {"rigid": (tmia.Rigid("CT 01", "MR 02", matrix=m, device="cpu"),
                      jmia.Rigid("CT 01", "MR 02", matrix=m)),
            "deformable": (tmia.Deformable(dvf=dvf, device="cpu", **kw),
                           jmia.Deformable(dvf=dvf, **kw))}
    for name, (t, j) in regs.items():
        t.export_image(str(tmp_path / f"t_{name}.mhd"))
        j.export_image(str(tmp_path / f"j_{name}.mhd"))
        a = tmhd.read_mhd_volume(str(tmp_path / f"t_{name}.mhd"))
        b = jmhd.read_mhd_volume(str(tmp_path / f"j_{name}.mhd"))
        np.testing.assert_array_equal(a[0], t.create_image()["array"])
        np.testing.assert_allclose(a[0], b[0], atol=1e-3 * 3001)
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_allclose(x, y, atol=1e-6)
        t.export_image(None)        # no path: nothing written, as JAX's
