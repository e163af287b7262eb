"""Planar modalities (DX, CR, MG, RF, XA, US) through both packages, on
the CPU: the port's read/planar.py against the JAX package's, on the
cases of tests/test_misc_io.py and tests/test_nm.py (X-ray, RF, US, the
MG inverse pivot, XA cine) and the reader branches they leave out (the
US regions' spacing, RGB and YBR_FULL_422 echo extraction, a 2-D RF
frame per plane, only_tags).

Tolerances: none. Every array (values and dtype), spacing, origin,
matrix, plane and name is bit-equal to the JAX package's.
"""

import numpy as np
import pytest
import torch

from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.dicom import (Dataset, Sequence, dcmwrite,
                                            generate_uid, uids)
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


def planar_ds(modality, sop_class, arr, bits_stored=16, frames=None,
              samples=1, photometric="MONOCHROME2", **tags):
    """A planar dataset of ``arr`` (uint8 when BitsAllocated is 8, else
    uint16 little-endian) with ``tags`` set on it."""
    ds = Dataset()
    ds.SOPClassUID = sop_class
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = modality
    ds.PatientID = modality + "1"
    ds.SeriesInstanceUID = generate_uid()
    if frames is not None:
        ds.NumberOfFrames = frames
    rows, cols = (arr.shape[-3], arr.shape[-2]) if samples > 1 \
        else (arr.shape[-2], arr.shape[-1])
    ds.Rows, ds.Columns = rows, cols
    eight = arr.dtype == np.uint8
    ds.BitsAllocated = 8 if eight else 16
    ds.BitsStored = 8 if eight else bits_stored
    ds.HighBit = ds.BitsStored - 1
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = samples
    if samples > 1:
        ds.PlanarConfiguration = 0
    ds.PhotometricInterpretation = photometric
    for key, value in tags.items():
        setattr(ds, key, value)
    ds.PixelData = arr.tobytes() if eight else arr.astype("<u2").tobytes()
    return ds


def dx(rng, orientation=("L", "F"), lut="Inverse", bits=16):
    arr = rng.integers(0, 1 << bits, size=(32, 24)).astype(np.uint16)
    tags = {"ImagerPixelSpacing": [0.14, 0.14]}
    if orientation is not None:
        tags["PatientOrientation"] = list(orientation)
    if lut is not None:
        tags["PresentationLUTShape"] = lut
    return planar_ds("DX", uids.DXImageStorage, arr, bits_stored=bits,
                     **tags)


def mg(rng, lut, bits):
    arr = rng.integers(0, 1 << bits, size=(16, 12)).astype(np.uint16)
    return planar_ds("MG", uids.MammographyImageStorage, arr,
                     bits_stored=bits, ImagerPixelSpacing=[0.07, 0.07],
                     PresentationLUTShape=lut)


def cr(rng):
    arr = rng.integers(0, 1024, size=(20, 14)).astype(np.uint16)
    return planar_ds("CR", "1.2.840.10008.5.1.4.1.1.1", arr, bits_stored=10,
                     PixelSpacing=[0.2, 0.25], PatientOrientation=["P", "F"])


def rf(rng, frames=5, two_d=False, orientation=None):
    shape = (16, 20) if two_d else (frames, 16, 20)
    arr = rng.integers(0, 4000, size=shape).astype(np.uint16)
    tags = {"ImagerPixelSpacing": [0.2, 0.2]}
    if orientation is not None:
        tags["PatientOrientation"] = list(orientation)
    return planar_ds("RF", uids.XRayRFImageStorage, arr,
                     frames=None if two_d else frames, **tags)


def xa(rng):
    arr = rng.integers(0, 1024, size=(5, 8, 8)).astype(np.uint16)
    return planar_ds("XA", uids.XRayAngiographicImageStorage, arr,
                     bits_stored=10, frames=5, ImagerPixelSpacing=[0.2, 0.2])


def us_rgb(rng):
    frames = rng.integers(0, 255, size=(3, 16, 16)).astype(np.uint8)
    rgb = np.stack([frames, frames, frames], axis=-1)
    rgb[0, 2, 3] = [255, 0, 0]            # one coloured overlay pixel
    return planar_ds("US", uids.USImageStorage, rgb, frames=3, samples=3,
                     photometric="RGB")


def us_rgb_single(rng):
    frame = rng.integers(0, 255, size=(16, 12)).astype(np.uint8)
    rgb = np.stack([frame, frame, frame], axis=-1)
    rgb[4:6, 2:5, 1] = 9
    return planar_ds("US", uids.USImageStorage, rgb, samples=3,
                     photometric="RGB")


def us_gray(rng, frames=4):
    shape = (frames, 16, 16) if frames > 1 else (16, 16)
    arr = rng.integers(0, 255, size=shape).astype(np.uint8)
    return planar_ds("US", uids.USImageStorage, arr,
                     frames=frames if frames > 1 else None)


def us_regions(rng):
    ds = us_gray(rng)
    region = Dataset()
    region.PhysicalDeltaX = 0.0123456
    region.PhysicalDeltaY = 0.0234567
    ds.SequenceOfUltrasoundRegions = Sequence([region])
    return ds


def us_ybr422(rng):
    frames, rows, cols = 2, 16, 16
    y = rng.integers(30, 220, size=(frames, rows, cols)).astype(np.uint8)
    cb = np.full((frames, rows, cols // 2), 128, np.uint8)
    cr_ = np.full_like(cb, 128)
    cb[:, :4, :2] = 200                   # Doppler-style overlay
    quads = np.empty((frames, rows, cols // 2, 4), np.uint8)
    quads[..., 0] = y[..., 0::2]
    quads[..., 1] = y[..., 1::2]
    quads[..., 2] = cb
    quads[..., 3] = cr_
    ds = planar_ds("US", uids.USImageStorage,
                   np.zeros((rows, cols, 3), np.uint8), frames=frames,
                   samples=3, photometric="YBR_FULL_422")
    ds.PixelData = quads.tobytes()
    return ds


PLANAR_CASES = {
    "dx_coronal_inverse_16bit": lambda rng: dx(rng),
    "dx_sagittal_no_lut": lambda rng: dx(rng, ("A", "F"), None, 12),
    "dx_axial_12bit_inverse": lambda rng: dx(rng, None, "Inverse", 12),
    "cr_sagittal": cr,
    "mg_inverse_16bit": lambda rng: mg(rng, "Inverse", 16),
    "mg_inverse_12bit": lambda rng: mg(rng, "Inverse", 12),
    "mg_standard_uppercase_inverse_12bit": lambda rng: mg(rng, "INVERSE",
                                                           12),
    "mg_identity_12bit": lambda rng: mg(rng, "IDENTITY", 12),
    "rf_cine": lambda rng: rf(rng),
    "rf_2d_axial": lambda rng: rf(rng, two_d=True),
    "rf_2d_coronal": lambda rng: rf(rng, two_d=True,
                                    orientation=("R", "F")),
    "rf_2d_sagittal": lambda rng: rf(rng, two_d=True,
                                     orientation=("P", "F")),
    "xa_cine": xa,
    "us_rgb_overlay": us_rgb,
    "us_rgb_single_frame": us_rgb_single,
    "us_gray_cine": lambda rng: us_gray(rng),
    "us_gray_single": lambda rng: us_gray(rng, frames=1),
    "us_region_spacing": us_regions,
    "us_ybr_full_422": us_ybr422,
}


@pytest.mark.parametrize("case", sorted(PLANAR_CASES))
@pytest.mark.parametrize("only_tags", [False, True],
                         ids=["pixels", "only_tags"])
def test_planar_matches_jax(tmp_path, case, only_tags):
    ds = PLANAR_CASES[case](np.random.default_rng(21))
    (tmp_path / "p").mkdir()
    dcmwrite(tmp_path / "p" / "img.dcm", ds)
    read_both(tmp_path, only_tags=only_tags)
    assert len(TData.image_list) == 1
    assert TData.image_list[0].startswith(ds.Modality + " ")
    assert_same_images()


def test_inverse_pivot_honours_only_the_reference_spelling(tmp_path):
    """The PresentationLUTShape pivot compares against "Inverse" exactly,
    as the JAX package and the reference do (read/dicom.py:1012-1014):
    "Inverse" pivots a 12-bit MG around 4095, the standard's "INVERSE"
    leaves it as stored (ROADMAP.md queue 3)."""
    rng = np.random.default_rng(8)
    arrays = {}
    for k, lut in enumerate(("Inverse", "INVERSE")):
        ds = mg(rng, lut, 12)
        arrays[lut] = np.frombuffer(ds.PixelData, "<u2").reshape(16, 12)
        dcmwrite(tmp_path / f"mg{k}.dcm", ds)
    read_both(tmp_path)
    assert_same_images()
    got = {TData.image[n].tags[0].PresentationLUTShape: TData.image[n].array
           for n in TData.image_list}
    np.testing.assert_array_equal(
        got["Inverse"][0], 4095 - arrays["Inverse"].astype(np.int16))
    np.testing.assert_array_equal(
        got["INVERSE"][0], arrays["INVERSE"].astype(np.int16))


def test_us_keeps_the_grey_echo_and_drops_colour(tmp_path):
    """ReadUS keeps the pixels whose channels agree and zeroes the
    coloured overlay; the regions' spacing is 10 x the rounded deltas
    (cm to mm), x then y."""
    rng = np.random.default_rng(9)
    dcmwrite(tmp_path / "rgb.dcm", us_rgb(rng))
    dcmwrite(tmp_path / "reg.dcm", us_regions(rng))
    read_both(tmp_path)
    assert_same_images()
    for n in TData.image_list:
        img = TData.image[n]
        assert img.array.dtype == np.uint8
        assert list(img.dimensions) == list(img.array.shape)
        if "SequenceOfUltrasoundRegions" in img.tags[0]:
            np.testing.assert_allclose(
                img.spacing, [10 * np.round(0.0123456, 4),
                              10 * np.round(0.0234567, 4), 1.0])
        else:
            assert img.array[0, 2, 3] == 0


def test_planar_folder_names_each_modality(tmp_path):
    """One folder of every planar modality reads in one pass into one
    image each, named as the JAX package names them."""
    rng = np.random.default_rng(10)
    for k, make in enumerate((dx, cr, lambda r: mg(r, "Inverse", 12), rf,
                              xa, us_rgb, us_gray)):
        dcmwrite(tmp_path / f"{k}.dcm", make(rng))
    read_both(tmp_path)
    assert_same_images()
    assert sorted(n.split()[0] for n in TData.image_list) == \
        ["CR", "DX", "MG", "RF", "US", "US", "XA"]
