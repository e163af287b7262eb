"""NM ingest (SPECT RECON TOMO volumes and planar frame stacks) through
both packages, on the CPU: the port's read/nm.py and read/multiframe.py
against the JAX package's, on the cases of tests/test_nm.py. Each folder
is written once and read by ``read_dicoms`` of each package; the
registries must be equal.

Tolerances: none. Names, arrays (values and dtype), spacing, origin,
orientation matrix, plane and SOP lists are bit-equal.
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.dicom import (Dataset, Sequence, dcmwrite,
                                            generate_uid, uids)


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


def read_both(folder=None, **kw):
    """One read_dicoms of ``folder`` (or ``file_list=``) by each
    package; returns the port's reader."""
    if folder is not None:
        kw["folder_path"] = str(folder)
    jmia.read_dicoms(**kw)
    return tmia.read_dicoms(device="cpu", **kw)


def assert_same_images(ulp=0):
    """The port's image registry equals the JAX package's; float arrays
    within ``ulp`` units in the last place (1 for a rescale slope that
    is not a power of two: XLA fuses raw * slope + intercept into an FMA
    on the CPU, the port rounds twice, ROADMAP.md queue 3)."""
    assert TData.image_list == JData.image_list
    for name in JData.image_list:
        t, j = TData.image[name], JData.image[name]
        if j.array is None:
            assert t.array is None, name
        else:
            ja = np.asarray(j.array)
            assert t.array.dtype == ja.dtype, (name, t.array.dtype)
            if ulp:
                np.testing.assert_array_max_ulp(t.array, ja, maxulp=ulp)
            else:
                np.testing.assert_array_equal(t.array, ja, err_msg=name)
        for attr in ("spacing", "origin", "matrix", "dimensions"):
            np.testing.assert_array_equal(
                np.asarray(getattr(t, attr), np.float64),
                np.asarray(getattr(j, attr), np.float64),
                err_msg=f"{name}.{attr}")
        for attr in ("plane", "modality", "unverified", "rgb"):
            assert getattr(t, attr) == getattr(j, attr), (name, attr)
        assert list(np.atleast_1d(t.sops)) == list(np.atleast_1d(j.sops))


def _base_nm(rows=16, cols=16, frames=6):
    ds = Dataset()
    ds.SOPClassUID = uids.NuclearMedicineImageStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "NM"
    ds.PatientID = "NM1"
    ds.SeriesInstanceUID = generate_uid()
    ds.FrameOfReferenceUID = generate_uid()
    ds.NumberOfFrames = frames
    ds.Rows, ds.Columns = rows, cols
    ds.BitsAllocated = 16
    ds.BitsStored = 16
    ds.HighBit = 15
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    return ds


def _detector(iop=(1, 0, 0, 0, 1, 0), ipp=(0.0, 0.0, 0.0), spacing=None):
    det = Dataset()
    if iop is not None:
        det.ImageOrientationPatient = list(iop)
        det.ImagePositionPatient = list(ipp)
    if spacing is not None:
        det.PixelSpacing = list(spacing)
    return det


def nm_tomo(rng, frames=6, rows=16, cols=16, pitch=-2.0,
            iop=(1, 0, 0, 0, 1, 0), ipp=(-50.0, -60.0, 0.0), extra=None):
    arr = rng.integers(0, 60000, size=(frames, rows, cols)) \
        .astype(np.uint16)
    ds = _base_nm(rows=rows, cols=cols, frames=frames)
    ds.ImageType = ["DERIVED", "SECONDARY", "RECON TOMO", "EMISSION"]
    ds.PatientPosition = "HFS"
    ds.PixelSpacing = [0.5, 0.5]
    ds.SliceThickness = abs(pitch)
    ds.SpacingBetweenSlices = pitch
    ds.NumberOfDetectors = 1
    ds.DetectorInformationSequence = Sequence([_detector(iop, ipp)])
    for key, value in (extra or {}).items():
        setattr(ds, key, value)
    ds.PixelData = arr.astype("<u2").tobytes()
    return arr, ds


def nm_planar(rng, image_type, frames=2, rows=16, cols=16, det=None,
              extra=None):
    arr = rng.integers(0, 60000, size=(frames, rows, cols)) \
        .astype(np.uint16)
    ds = _base_nm(rows=rows, cols=cols, frames=frames)
    ds.ImageType = ["ORIGINAL", "PRIMARY", image_type, "EMISSION"]
    if det is not None:
        ds.DetectorInformationSequence = Sequence(det)
    for key, value in (extra or {}).items():
        setattr(ds, key, value)
    ds.PixelData = arr.astype("<u2").tobytes()
    return arr, ds


def _case_tomo_two_items(rng):
    arr, ds = nm_tomo(rng, frames=4, rows=8, cols=8, pitch=2.0)
    del ds.NumberOfDetectors
    ds.DetectorInformationSequence = Sequence([
        _detector(), _detector((1, 0, 0, 0, -1, 0), (0.0, 0.0, 100.0))])
    return arr, ds


# the cases of tests/test_nm.py (and an oblique detector): each builds
# (written pixels, dataset)
NM_CASES = {
    "tomo_negative_pitch": lambda rng: nm_tomo(rng),
    "tomo_positive_pitch_oblique": lambda rng: nm_tomo(
        rng, pitch=4.42, iop=(0.8, 0.6, 0.0, -0.6, 0.8, 0.0),
        ipp=(12.5, -30.25, 40.0)),
    "tomo_sagittal_detector": lambda rng: nm_tomo(
        rng, pitch=-3.0, iop=(0, 1, 0, 0, 0, -1), ipp=(5.0, -20.0, 30.0)),
    "planar_static_detector_spacing": lambda rng: nm_planar(
        rng, "STATIC", det=[_detector(None, spacing=(2.4, 2.4))]),
    "whole_body_no_geometry": lambda rng: nm_planar(
        rng, "WHOLE BODY", frames=1, extra={"NumberOfFrames": 1}),
    "multi_detector_not_expanded": lambda rng: nm_tomo(
        rng, frames=4, rows=8, cols=8, pitch=2.0,
        extra={"NumberOfDetectors": 2}),
    "gated_not_expanded": lambda rng: nm_tomo(
        rng, frames=8, rows=8, cols=8, pitch=2.0,
        extra={"ImageType": ["DERIVED", "SECONDARY", "RECON GATED TOMO",
                             "EMISSION"]}),
    "number_of_slices_mismatch": lambda rng: nm_tomo(
        rng, frames=8, rows=8, cols=8, pitch=2.0,
        extra={"NumberOfSlices": 4}),
    "two_detector_items": _case_tomo_two_items,
    "degenerate_orientation": lambda rng: nm_tomo(
        rng, frames=4, rows=8, cols=8, pitch=2.0,
        iop=(1, 0, 0, 1, 0, 0)),
    "planar_explicit_unit_spacing": lambda rng: nm_planar(
        rng, "STATIC", rows=8, cols=8,
        det=[_detector(None, spacing=(4.8, 4.8))],
        extra={"PixelSpacing": [1.0, 1.0]}),
    "planar_patient_orientation": lambda rng: nm_planar(
        rng, "WHOLE BODY", frames=1, rows=12, cols=8,
        extra={"NumberOfFrames": 1, "PatientOrientation": ["L", "F"],
               "PixelSpacing": [2.0, 2.0]}),
    "planar_dynamic_sagittal": lambda rng: nm_planar(
        rng, "DYNAMIC", frames=3, rows=10, cols=6,
        extra={"PatientOrientation": ["A", "F"],
               "PixelSpacing": [3.0, 3.0]}),
}


@pytest.mark.parametrize("case", sorted(NM_CASES))
def test_nm_matches_jax(tmp_path, case):
    arr, ds = NM_CASES[case](np.random.default_rng(11))
    (tmp_path / "nm").mkdir()
    dcmwrite(tmp_path / "nm" / "nm.dcm", ds)
    read_both(tmp_path)
    assert TData.image_list == ["NM 01"]
    assert_same_images()
    img = TData.image["NM 01"]
    if img.array.dtype == np.int32:       # a frame stack, in file order
        if img.plane == "Axial":
            np.testing.assert_array_equal(img.array, arr.astype(np.int32))
    else:            # an assembled tomo volume: every count, unwrapped
        assert img.array.dtype == np.float32
        np.testing.assert_array_equal(
            np.sort(img.array.ravel()),
            np.sort(arr.astype(np.float32).ravel()))


@pytest.mark.parametrize("pitch,iop", [
    (-2.0, (1, 0, 0, 0, 1, 0)), (4.42, (1, 0, 0, 0, 1, 0)),
    (4.42, (0.8, 0.6, 0.0, -0.6, 0.8, 0.0))])
def test_nm_tomo_geometry_follows_the_detector(tmp_path, pitch, iop):
    """The tomo volume's geometry is the detector's: in-plane axes the
    detector's row / column vectors, slice spacing |pitch|, and volume
    slice k at origin + k * spacing_z * slice axis holding the frame the
    detector walk put there (frame i at ipp + i * pitch * normal)."""
    ipp = np.array([-50.0, -60.0, 20.0])
    arr, ds = nm_tomo(np.random.default_rng(3), pitch=pitch, iop=iop,
                      ipp=tuple(ipp))
    (tmp_path / "nm").mkdir()
    dcmwrite(tmp_path / "nm" / "tomo.dcm", ds)
    read_both(tmp_path)
    assert_same_images()
    img = TData.image["NM 01"]
    row, col = np.asarray(iop[:3], float), np.asarray(iop[3:], float)
    normal = np.cross(row, col)
    np.testing.assert_allclose(img.matrix[0], row, atol=1e-12)
    np.testing.assert_allclose(img.matrix[1], col, atol=1e-12)
    np.testing.assert_allclose(np.abs(img.matrix[2]), np.abs(normal),
                               atol=1e-12)
    np.testing.assert_allclose(img.spacing, [0.5, 0.5, abs(pitch)],
                               rtol=1e-12)
    frames = ipp[None, :] + np.arange(arr.shape[0])[:, None] * pitch \
        * normal[None, :]
    for k in range(arr.shape[0]):
        pos = np.asarray(img.origin) + k * img.spacing[2] * img.matrix[2]
        i = int(np.argmin(np.linalg.norm(frames - pos, axis=1)))
        np.testing.assert_allclose(frames[i], pos, atol=1e-9)
        np.testing.assert_array_equal(img.array[k],
                                      arr[i].astype(np.float32))


def test_nm_tomo_decodes_once_and_releases_the_parent(tmp_path,
                                                      monkeypatch):
    """The tomo file decodes once for all its frames, and after the
    volume is assembled the shared parent keeps neither its PixelData
    nor its decoded cache."""
    from medicalimageanalysis_torch.dicom import pixels

    calls = []
    decode = pixels.decode_pixel_data

    def counting(ds):
        calls.append(1)
        return decode(ds)

    monkeypatch.setattr(pixels, "decode_pixel_data", counting)
    arr, ds = nm_tomo(np.random.default_rng(4), frames=5, rows=8, cols=8,
                      pitch=2.0)
    (tmp_path / "nm").mkdir()
    dcmwrite(tmp_path / "nm" / "tomo.dcm", ds)
    read_both(tmp_path)
    assert_same_images()
    assert len(calls) <= 1
    parent = TData.image["NM 01"].tags[0]._parent
    assert "PixelData" not in parent
    assert parent._pixel_cache is None
    np.testing.assert_array_equal(TData.image["NM 01"].array,
                                  arr.astype(np.float32))


def test_nm_tomo_only_tags_matches_jax(tmp_path):
    arr, ds = nm_tomo(np.random.default_rng(5), frames=3, rows=8, cols=8,
                      pitch=3.0, ipp=(0.0, 0.0, 10.0))
    (tmp_path / "nm").mkdir()
    dcmwrite(tmp_path / "nm" / "tomo.dcm", ds)
    read_both(tmp_path, only_tags=True)
    assert TData.image["NM 01"].array is None
    assert_same_images()
    # neither package can finish a frame view's deferred load: the SOPs
    # recorded are the frames' (parent UID + ".k"), the file's is the
    # parent's (JAX structure/image.py:1065-1069; ROADMAP.md queue 3)
    for data in (TData, JData):
        with pytest.raises(ValueError, match="no slices matched"):
            data.image["NM 01"].load_array()


def test_nm_tomo_byte_flip_fuzz_matches_jax(tmp_path):
    """Byte-flipped NM RECON TOMO files through the full read_dicoms
    flow of both packages: neither raises, and the registries agree
    (tests/test_nm.py's fuzz, 40 trials)."""
    arr, ds = nm_tomo(np.random.default_rng(6), frames=4)
    good_path = tmp_path / "good.dcm"
    dcmwrite(good_path, ds)
    good = good_path.read_bytes()
    mut_path = tmp_path / "mut.dcm"
    fuzz_rng = np.random.default_rng(78)
    for _ in range(40):
        blob = bytearray(good)
        for _ in range(int(fuzz_rng.integers(1, 16))):
            blob[int(fuzz_rng.integers(0, len(blob)))] = int(
                fuzz_rng.integers(0, 256))
        mut_path.write_bytes(bytes(blob))
        TData.clear()
        JData.clear()
        read_both(file_list=[str(mut_path)])
        assert_same_images()
