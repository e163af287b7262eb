"""Enhanced multi-frame CT / MR / PT ingest and the 12-bit packing,
through both packages on the CPU.

- The port's read/multiframe.py against the JAX package's: one enhanced
  file per case (tests/test_misc_io.py's enhanced CT, and per-frame
  orientation, pixel measures and rescale), read by ``read_dicoms`` of
  each package. The volume also equals the same pixels written as a
  single-frame series. The file decodes once and the parent's pixels are
  released after assembly.
- ops/bitpack.py: ``pack12`` words equal the JAX package's and
  ``unpack12_device`` returns the packed values.

Tolerances: none, but for a PT rescale slope that is not a power of
two, where the volume is within 1 ulp (ROADMAP.md queue 3). Geometry and
SOP lists are bit-equal; the packed words and the unpacked values are
bit-equal.
"""

import numpy as np
import pytest
import torch

from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import bitpack as tbitpack
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.dicom import (Dataset, Sequence, dcmwrite,
                                            generate_uid, uids)
from medicalimageanalysis_tpu.ops import bitpack as jbitpack
from test_torch_nm import assert_same_images, read_both


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


def enhanced(arr, modality="CT", origin=(-50.0, -60.0, -10.0), step=2.0,
             iop=(1, 0, 0, 0, 1, 0), per_frame_iop=False,
             per_frame_measures=False, rescale=(1.0, -1024.0),
             per_frame_rescale=False, order=None):
    """An enhanced multi-frame dataset of ``arr`` (frames, rows, cols)
    uint16: frame i at origin + i * step along the slice normal (frames
    stored in ``order`` when given)."""
    frames = arr.shape[0]
    order = list(range(frames)) if order is None else list(order)
    sop = {"CT": uids.CTImageStorage, "MR": "1.2.840.10008.5.1.4.1.1.4.1",
           "PT": "1.2.840.10008.5.1.4.1.1.130"}[modality]
    ds = Dataset()
    ds.SOPClassUID = sop
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = modality
    ds.PatientID = "E"
    ds.SeriesInstanceUID = generate_uid()
    ds.FrameOfReferenceUID = generate_uid()
    ds.NumberOfFrames = frames
    ds.Rows, ds.Columns = arr.shape[1], arr.shape[2]
    ds.BitsAllocated = 16
    ds.BitsStored = 16
    ds.HighBit = 15
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.SliceThickness = abs(step)

    def orient():
        item = Dataset()
        item.ImageOrientationPatient = list(iop)
        return Sequence([item])

    def measures():
        item = Dataset()
        item.PixelSpacing = [0.5, 0.75]
        item.SliceThickness = abs(step)
        return Sequence([item])

    def transform():
        item = Dataset()
        item.RescaleSlope, item.RescaleIntercept = rescale
        return Sequence([item])

    shared = Dataset()
    if not per_frame_iop:
        shared.PlaneOrientationSequence = orient()
    if not per_frame_measures:
        shared.PixelMeasuresSequence = measures()
    if not per_frame_rescale:
        shared.PixelValueTransformationSequence = transform()
    ds.SharedFunctionalGroupsSequence = Sequence([shared])
    normal = np.cross(np.asarray(iop[:3], float), np.asarray(iop[3:], float))
    per_frame = Sequence()
    for i in order:
        pos = Dataset()
        pos.ImagePositionPatient = [float(v) for v in
                                    np.asarray(origin) + i * step * normal]
        fg = Dataset()
        fg.PlanePositionSequence = Sequence([pos])
        if per_frame_iop:
            fg.PlaneOrientationSequence = orient()
        if per_frame_measures:
            fg.PixelMeasuresSequence = measures()
        if per_frame_rescale:
            fg.PixelValueTransformationSequence = transform()
        per_frame.append(fg)
    ds.PerFrameFunctionalGroupsSequence = per_frame
    ds.PixelData = arr[order].astype("<u2").tobytes()
    return ds


MF_CASES = {
    "ct_shared_groups": dict(),
    "ct_frames_shuffled": dict(order=[3, 0, 5, 1, 4, 2]),
    "ct_per_frame_groups": dict(per_frame_iop=True, per_frame_measures=True,
                                per_frame_rescale=True),
    "ct_descending_frames": dict(step=-2.0),
    "mr_sagittal": dict(modality="MR", iop=(0, 1, 0, 0, 0, -1),
                        rescale=(1.0, 0.0)),
    "pt_fractional_rescale": dict(modality="PT", rescale=(0.37, 1.5)),
}


@pytest.mark.parametrize("case", sorted(MF_CASES))
def test_enhanced_multiframe_matches_jax(tmp_path, case):
    arr = np.random.default_rng(12).integers(0, 2000, size=(6, 16, 12)) \
        .astype(np.uint16)
    (tmp_path / "e").mkdir()
    dcmwrite(tmp_path / "e" / "enhanced.dcm", enhanced(arr, **MF_CASES[case]))
    read_both(tmp_path)
    assert len(TData.image_list) == 1
    # a slope that is not a power of two: 1 ulp (ROADMAP.md queue 3)
    assert_same_images(ulp=1 if case == "pt_fractional_rescale" else 0)
    img = TData.image[TData.image_list[0]]
    assert len(img.sops) == 6
    slope, intercept = MF_CASES[case].get("rescale", (1.0, -1024.0))
    want = (arr.astype(np.float64) * slope + intercept).ravel()
    np.testing.assert_allclose(np.sort(img.array.ravel()), np.sort(want),
                               rtol=1e-6)


def test_enhanced_ct_equals_the_single_frame_series(tmp_path):
    """One enhanced CT file assembles into the volume a classic
    single-frame series of the same pixels gives."""
    vol = np.random.default_rng(13).integers(-1000, 2000, size=(6, 16, 16)) \
        .astype(np.int16)
    info = write_ct_series(tmp_path / "series", vol, spacing=(0.75, 0.5),
                           thickness=2.0)
    (tmp_path / "enhanced").mkdir()
    dcmwrite(tmp_path / "enhanced" / "e.dcm", enhanced(
        (vol.astype(np.int32) + 1024).astype(np.uint16),
        origin=tuple(info["origin"])))
    read_both(tmp_path)
    assert_same_images()
    a, b = (TData.image[n] for n in TData.image_list)
    assert a.array.dtype == b.array.dtype == np.int16
    np.testing.assert_array_equal(a.array, b.array)
    np.testing.assert_array_equal(a.array, vol)
    for attr in ("origin", "spacing", "matrix"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))


def test_enhanced_decodes_once_and_releases_the_parent(tmp_path,
                                                       monkeypatch):
    from medicalimageanalysis_torch.dicom import pixels

    calls = []
    decode = pixels.decode_pixel_data
    monkeypatch.setattr(pixels, "decode_pixel_data",
                        lambda ds: calls.append(1) or decode(ds))
    arr = np.random.default_rng(14).integers(0, 2000, size=(5, 8, 8)) \
        .astype(np.uint16)
    (tmp_path / "e").mkdir()
    dcmwrite(tmp_path / "e" / "e.dcm", enhanced(arr))
    read_both(tmp_path)
    assert_same_images()
    assert len(calls) <= 1
    parent = TData.image[TData.image_list[0]].tags[0]._parent
    assert "PixelData" not in parent and parent._pixel_cache is None


def test_enhanced_only_tags_matches_jax(tmp_path):
    arr = np.random.default_rng(15).integers(0, 2000, size=(4, 8, 8)) \
        .astype(np.uint16)
    (tmp_path / "e").mkdir()
    dcmwrite(tmp_path / "e" / "e.dcm", enhanced(arr))
    read_both(tmp_path, only_tags=True)
    assert TData.image[TData.image_list[0]].array is None
    assert_same_images()


@pytest.mark.parametrize("shape,dtype,lo,span", [
    ((3, 5, 16), np.int16, -1024, 4095),       # the native packer's layout
    ((2, 7, 13), np.int16, -1024, 4000),       # a padded tail
    ((4, 9), np.int32, 100, 4095),
    ((64,), np.uint16, 0, 2047),
    ((2, 3, 8), np.int16, 5, 0),               # a constant volume
])
def test_pack12_and_unpack12_match_jax(shape, dtype, lo, span):
    a = (lo + np.random.default_rng(16).integers(0, span + 1, size=shape)) \
        .astype(dtype)
    packed, jpacked = tbitpack.pack12(a), jbitpack.pack12(a)
    words, base, tail = packed
    np.testing.assert_array_equal(words, jpacked[0])
    assert (base, tail) == jpacked[1:]
    out = tbitpack.unpack12_device(words, base, tail, device="cpu")
    jout = np.asarray(jbitpack.unpack12_device(*jpacked))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(out.numpy(), a.astype(np.float32))
    exact = tbitpack.unpack12_device(torch.from_numpy(words.view(np.int32)),
                                     base, tail, dtype=torch.int32)
    np.testing.assert_array_equal(exact.numpy(), a.astype(np.int32))


@pytest.mark.parametrize("a", [
    np.array([0, 4096], np.int16), np.zeros(0, np.int16),
    np.array([0.5, 1.5], np.float32)], ids=["range", "empty", "float"])
def test_pack12_declines_like_jax(a):
    assert tbitpack.pack12(a) is None and jbitpack.pack12(a) is None
