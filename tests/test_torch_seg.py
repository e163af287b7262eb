"""DICOM SEG in both packages, on the CPU (the cases of tests/test_seg.py):
``Image.create_seg`` (BINARY and FRACTIONAL) and ``read/seg.ReadSEG``
with ``Image.input_seg``; each SEG written by one package and read by the
other, on the same CT series and the same masks.

Tolerances: none. PixelData byte-equal between the writers, datasets
equal element by element with the generated UIDs masked, masks bit-equal.
Rectangular masks, as in the JAX package's tests, where its contour round
trip (``convert_mask`` then rasterization) is exact; the port serves a
SEG's own voxels from the mask cache, which a non-rectangular mask shows
(``test_seg_masks_are_served_from_the_cache``).
"""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.read import seg as tseg
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.dicom import dcmwrite, uids
from medicalimageanalysis_tpu.read import seg as jseg
from test_torch_reg import assert_same_dataset

SHAPE = (6, 16, 16)


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


def ingest_both(tmp_path, rng, shape=SHAPE):
    arr = rng.integers(-200, 200, size=shape).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr)
    read_both(folder_path=str(tmp_path))
    return TData.image["CT 01"], JData.image["CT 01"]


def rect_masks(shape=SHAPE):
    a = np.zeros(shape, np.uint8)
    a[1:4, 2:8, 3:9] = 1
    b = np.zeros(shape, np.uint8)
    b[2:5, 9:14, 8:13] = 1
    return a, b


def add_roi(images, name, color, mask):
    for img in images:
        img.create_roi(name=name, color=color)
        img.rois[name].convert_mask(mask)


def both_segs(images, **kw):
    """create_seg of each package, held equal element by element."""
    t_ds, j_ds = (img.create_seg(**kw) for img in images)
    assert_same_dataset(t_ds, j_ds)
    assert bytes(t_ds.PixelData) == bytes(j_ds.PixelData)
    return t_ds, j_ds


def masks_of(data, name):
    return np.asarray(data.image["CT 01"].rois[name].compute_mask(),
                      np.uint8)


def test_cielab_conversions_equal_jax(rng):
    colors = [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 255],
              [0, 0, 0], [128, 64, 200], [17, 230, 99]] \
        + rng.integers(0, 256, size=(40, 3)).tolist()
    for rgb in colors:
        lab = tseg.rgb_to_cielab_uint16(rgb)
        assert lab == jseg.rgb_to_cielab_uint16(rgb)
        back = tseg.cielab_uint16_to_rgb(lab)
        assert back == jseg.cielab_uint16_to_rgb(lab)
        assert np.max(np.abs(np.array(back) - np.array(rgb))) <= 2


def test_unpack_bits_little_equals_numpy(rng):
    packed = rng.integers(0, 256, size=37).astype(np.uint8)
    for n in (0, 1, 7, 8, 9, 290, 296):
        got = tseg.unpack_bits_little(torch.from_numpy(packed), n)
        np.testing.assert_array_equal(
            got.numpy(), np.unpackbits(packed, bitorder="little")[:n])


@pytest.mark.parametrize("fractional", [False, True],
                         ids=["binary", "fractional"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_seg_round_trips_across_packages(tmp_path, rng, fractional, writer):
    images = ingest_both(tmp_path, rng)
    mask_a, mask_b = rect_masks()
    add_roi(images, "A", [255, 0, 0], mask_a)
    add_roi(images, "B", [0, 128, 255], mask_b)
    t_ds, j_ds = both_segs(images, fractional=fractional)
    assert t_ds.SegmentationType == ("FRACTIONAL" if fractional
                                     else "BINARY")
    assert int(t_ds.NumberOfFrames) == 3 + 3
    dcmwrite(str(tmp_path / "ct" / "seg.dcm"),
             t_ds if writer == "port" else j_ds)
    report = read_both(folder_path=str(tmp_path)).report
    assert not report.failed_series
    for name, mask in (("A", mask_a), ("B", mask_b)):
        np.testing.assert_array_equal(masks_of(TData, name), mask)
        np.testing.assert_array_equal(masks_of(JData, name), mask)
        assert TData.image["CT 01"].rois[name].color \
            == JData.image["CT 01"].rois[name].color
    assert sorted(TData.roi_list) == sorted(JData.roi_list)


def test_fractional_seg_rle_compressed(tmp_path, rng):
    images = ingest_both(tmp_path, rng)
    mask_a, _ = rect_masks()
    add_roi(images, "A", [0, 255, 0], mask_a)
    t_ds, _ = both_segs(images, fractional=True)
    dcmwrite(str(tmp_path / "ct" / "seg.dcm"), t_ds,
             transfer_syntax=uids.RLELossless)
    read_both(folder_path=str(tmp_path))
    np.testing.assert_array_equal(masks_of(TData, "A"), mask_a)
    np.testing.assert_array_equal(masks_of(JData, "A"), mask_a)


def test_seg_fractional_arrays_equal_jax(tmp_path, rng):
    images = ingest_both(tmp_path, rng)
    mask_a, _ = rect_masks()
    add_roi(images, "A", [0, 255, 0], mask_a)
    t_ds, _ = both_segs(images, fractional=True)
    # a soft edge: values 1..255, the mask at value * 2 >= 255
    frames = np.frombuffer(t_ds.PixelData, np.uint8).copy()
    frames[frames > 0] = rng.integers(1, 256, size=int((frames > 0).sum()))
    t_ds.PixelData = frames.tobytes()
    t = tseg.ReadSEG(t_ds, only_tags=False)
    j = jseg.ReadSEG(t_ds, only_tags=False)
    np.testing.assert_array_equal(t.masks[0].numpy(), j.masks[0])
    np.testing.assert_array_equal(t.fractional_arrays[0].numpy(),
                                  j.fractional_arrays[0])


def test_seg_only_load_roi_names(tmp_path, rng):
    images = ingest_both(tmp_path, rng)
    mask_a, mask_b = rect_masks()
    add_roi(images, "A", [255, 0, 0], mask_a)
    add_roi(images, "B", [0, 128, 255], mask_b)
    images[0].create_seg(path=str(tmp_path / "ct" / "seg.dcm"))
    report = read_both(folder_path=str(tmp_path),
                       only_load_roi_names=["B"]).report
    for data in (TData, JData):
        assert "B" in data.image["CT 01"].rois
        assert "A" not in data.image["CT 01"].rois
    # frames of filtered segments are dropped silently, not off-grid
    assert not any("off-grid" in w for w in report.warnings)


def test_unmatched_seg_reported(tmp_path, rng):
    images = ingest_both(tmp_path, rng)
    mask_a, _ = rect_masks()
    add_roi(images, "A", [255, 0, 0], mask_a)
    seg_dir = tmp_path / "seg_only"
    seg_dir.mkdir()
    images[0].create_seg(path=str(seg_dir / "seg.dcm"))
    jreport = jmia.read_dicoms(folder_path=str(seg_dir)).report
    report = tmia.read_dicoms(folder_path=str(seg_dir)).report
    assert len(report.unmatched_segs) == len(jreport.unmatched_segs) == 1
    assert report.summary()["unmatched_segs"] == 1
    assert not TData.image and not JData.image


def test_off_grid_frames_skipped_like_jax(tmp_path, rng):
    images = ingest_both(tmp_path, rng)
    mask_a, _ = rect_masks()
    add_roi(images, "A", [255, 0, 0], mask_a)
    ds, _ = both_segs(images)
    plane = ds.PerFrameFunctionalGroupsSequence[0].PlanePositionSequence[0]
    ipp = [float(v) for v in plane.ImagePositionPatient]
    ipp[2] += 1.3  # 0.52 voxels at 2.5 mm slices: past the quarter snap
    plane.ImagePositionPatient = ipp
    t = tseg.ReadSEG(ds, only_tags=False)
    j = jseg.ReadSEG(ds, only_tags=False)
    assert t.match_image_name == j.match_image_name == "CT 01"
    assert t.skipped_frames == j.skipped_frames == 1
    np.testing.assert_array_equal(t.masks[0].numpy(), j.masks[0])
    assert int(t.masks[0].sum()) == int(mask_a[2:4].sum())
    dcmwrite(str(tmp_path / "ct" / "seg.dcm"), ds)
    report = tmia.read_dicoms(folder_path=str(tmp_path)).report
    assert any("1 off-grid" in w for w in report.warnings)


def test_seg_ingest_byte_flip_fuzz(tmp_path, rng):
    """Corrupt SEGs never escape the tolerant flow; both packages end
    with the same ROIs from each."""
    images = ingest_both(tmp_path, rng)
    mask_a, _ = rect_masks()
    add_roi(images, "A", [255, 0, 0], mask_a)
    seg_path = tmp_path / "ct" / "seg.dcm"
    images[0].create_seg(path=str(seg_path))
    good = seg_path.read_bytes()
    seg_path.unlink()
    ct_files = [str(p) for p in sorted((tmp_path / "ct").glob("*.dcm"))]
    mut = tmp_path / "mut_seg.dcm"
    frng = np.random.default_rng(79)
    for _ in range(40):
        blob = bytearray(good)
        for _ in range(int(frng.integers(1, 16))):
            blob[int(frng.integers(0, len(blob)))] = int(
                frng.integers(0, 256))
        mut.write_bytes(bytes(blob))
        read_both(file_list=ct_files + [str(mut)])
        assert sorted(TData.image["CT 01"].rois) \
            == sorted(JData.image["CT 01"].rois)


def test_transposed_seg_rejected(tmp_path, rng):
    images = ingest_both(tmp_path, rng)
    mask_a, _ = rect_masks()
    add_roi(images, "A", [255, 0, 0], mask_a)
    ds = images[0].create_seg()
    ds.SharedFunctionalGroupsSequence[0].PlaneOrientationSequence[0] \
        .ImageOrientationPatient = [0.0, 1.0, 0.0, 1.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="orientation"):
        tseg.ReadSEG(ds, only_tags=False)
    dcmwrite(str(tmp_path / "ct" / "seg.dcm"), ds)
    report = read_both(folder_path=str(tmp_path)).report
    for data in (TData, JData):
        assert "A" not in data.image["CT 01"].rois
    assert any("ReadSEG" in f["builder"] for f in report.failed_series)


def test_seg_pixel_spacing_mismatch_rejected(tmp_path, rng):
    images = ingest_both(tmp_path, rng)
    mask_a, _ = rect_masks()
    add_roi(images, "A", [255, 0, 0], mask_a)
    ds = images[0].create_seg()
    ds.SharedFunctionalGroupsSequence[0].PixelMeasuresSequence[0] \
        .PixelSpacing = [1.6, 1.6]
    for reader in (tseg.ReadSEG, jseg.ReadSEG):
        with pytest.raises(ValueError, match="PixelSpacing"):
            reader(ds, only_tags=False)


def test_seg_frames_larger_than_the_grid_rejected(tmp_path, rng):
    images = ingest_both(tmp_path, rng)
    mask_a, _ = rect_masks()
    add_roi(images, "A", [255, 0, 0], mask_a)
    ds = images[0].create_seg()
    ds.Rows = 17
    for reader in (tseg.ReadSEG, jseg.ReadSEG):
        with pytest.raises(ValueError, match="exceeds"):
            reader(ds, only_tags=False)


def test_zero_frame_seg_round_trip(tmp_path, rng):
    images = ingest_both(tmp_path, rng)
    add_roi(images, "Empty", [10, 200, 10], np.zeros(SHAPE, np.uint8))
    ds, _ = both_segs(images, path=None)
    assert int(ds.NumberOfFrames) == 0
    dcmwrite(str(tmp_path / "ct" / "seg.dcm"), ds)
    report = read_both(folder_path=str(tmp_path)).report
    assert not report.failed_series
    for data in (TData, JData):
        assert "Empty" in data.image["CT 01"].rois
    assert report.summary()["unmatched_segs"] == 0


def test_seg_conformance_elements_round_trip(tmp_path, rng):
    from medicalimageanalysis_torch.dicom import dcmread

    images = ingest_both(tmp_path, rng)
    mask_a, _ = rect_masks()
    add_roi(images, "A", [255, 0, 0], mask_a)
    images[0].create_seg(path=str(tmp_path / "seg.dcm"), label="my study")
    back = dcmread(str(tmp_path / "seg.dcm"))
    assert str(back.ContentDescription) == "my study"
    assert str(back.ContentLabel) == "SEG"
    seg0 = back.SegmentSequence[0]
    assert str(seg0.SegmentedPropertyCategoryCodeSequence[0].CodeValue) \
        == "123037004"
    assert str(seg0.SegmentedPropertyTypeCodeSequence[0].CodeValue) \
        == "85756007"
    dim = back.DimensionIndexSequence
    assert int(dim[0].DimensionIndexPointer) == 0x0062000B
    assert int(dim[1].DimensionIndexPointer) == 0x00200032
    assert list(back.PerFrameFunctionalGroupsSequence[0]
                .FrameContentSequence[0].DimensionIndexValues) == [1, 2]
    jback = jmia.dicom.dcmread(str(tmp_path / "seg.dcm"))
    assert_same_dataset(back, jback, top=(), anywhere=())


def test_cropped_subwindow_seg(tmp_path, rng):
    from medicalimageanalysis_tpu.ops import geometry as geo

    images = ingest_both(tmp_path, rng)
    mask_a, _ = rect_masks()
    add_roi(images, "A", [255, 0, 0], mask_a)
    ds = images[1].create_seg()
    rows, cols, y0, x0 = 6, 6, 2, 3
    nfr = int(ds.NumberOfFrames)
    flat = np.unpackbits(np.frombuffer(ds.PixelData, np.uint8),
                         bitorder="little")[:nfr * 16 * 16]
    cropped = flat.reshape(nfr, 16, 16)[:, y0:y0 + rows, x0:x0 + cols]
    ds.Rows, ds.Columns = rows, cols
    payload = np.packbits(cropped.reshape(-1), bitorder="little").tobytes()
    ds.PixelData = payload + (b"\x00" if len(payload) % 2 else b"")
    img = images[1]
    m = img.display.compute_matrix_pixel_to_position()
    for item in ds.PerFrameFunctionalGroupsSequence:
        plane = item.PlanePositionSequence[0]
        pix = geo.apply_homogeneous(
            np.asarray(plane.ImagePositionPatient, np.float64),
            img.display.compute_matrix_position_to_pixel())
        new = geo.apply_homogeneous(
            np.array([x0, y0, float(np.round(pix[2]))]), m)
        plane.ImagePositionPatient = [float(v) for v in new]
    dcmwrite(str(tmp_path / "ct" / "seg.dcm"), ds)
    report = read_both(folder_path=str(tmp_path)).report
    assert not report.failed_series
    np.testing.assert_array_equal(masks_of(TData, "A"), mask_a)
    np.testing.assert_array_equal(masks_of(JData, "A"), mask_a)


@pytest.mark.parametrize("orientation, plane", [
    ([1, 0, 0, 0, 0, -1], "Coronal"),
    ([0, 1, 0, 0, 0, -1], "Sagittal"),
    ([np.cos(np.deg2rad(10)), np.sin(np.deg2rad(10)), 0,
      -np.sin(np.deg2rad(10)), np.cos(np.deg2rad(10)), 0], "Axial"),
], ids=["coronal", "sagittal", "oblique_10deg"])
def test_seg_and_export_non_axial_round_trip(tmp_path, rng, orientation,
                                             plane):
    """SEG write / read and export_dicom on coronal, sagittal and 10°
    oblique series: the writers emit the canonical grid's pixel-axis
    geometry. Each package writes; the port reads both."""
    from medicalimageanalysis_tpu.utils.creation import CreateDicomImage

    arr = rng.integers(-200, 200, size=SHAPE).astype(np.int16)
    gen = CreateDicomImage(str(tmp_path / "ct"), arr,
                           origin=[-50, -60, -40], spacing=[1.0, 1.0],
                           thickness=2.0)
    gen.orientation = [float(v) for v in orientation]
    gen.run()
    read_both(folder_path=str(tmp_path))
    images = TData.image["CT 01"], JData.image["CT 01"]
    assert images[0].plane == images[1].plane == plane
    mask = np.zeros(images[0].array.shape, np.uint8)
    mask[1:4, 3:9, 2:10] = 1
    add_roi(images, "A", [255, 0, 0], mask)
    t_ds, j_ds = both_segs(images)
    dcmwrite(str(tmp_path / "ct" / "seg.dcm"), t_ds)
    read_both(folder_path=str(tmp_path))
    np.testing.assert_array_equal(masks_of(TData, "A"), mask)
    np.testing.assert_array_equal(masks_of(JData, "A"), mask)

    timg, jimg = TData.image["CT 01"], JData.image["CT 01"]
    timg.export_dicom(str(tmp_path / "t_export"))
    jimg.export_dicom(str(tmp_path / "j_export"))
    for sub in ("t_export", "j_export"):
        tmia.read_dicoms(folder_path=str(tmp_path / sub))
        back = TData.image["CT 01"]
        np.testing.assert_array_equal(back.array, np.asarray(jimg.array))
        np.testing.assert_allclose(back.origin, jimg.origin, atol=1e-4)
        np.testing.assert_allclose(back.matrix, jimg.matrix, atol=1e-5)
        np.testing.assert_allclose(back.spacing, jimg.spacing, atol=1e-6)


def test_seg_masks_are_served_from_the_cache(tmp_path, rng, monkeypatch):
    """A SEG's voxels go into the image's mask cache: compute_roi_masks
    returns them without rasterizing, even for a mask whose contours
    would not rasterize back to it."""
    from medicalimageanalysis_torch.parallel import batch

    images = ingest_both(tmp_path, rng)
    blob = np.zeros(SHAPE, np.uint8)
    blob[1:5, 3:12, 4:13] = rng.integers(0, 2, size=(4, 9, 9))
    blob[2, 6, 6:11] = 1
    add_roi(images, "Blob", [200, 10, 10], blob)
    images[1].rois["Blob"].compute_mask()
    # the JAX package's masks are what its rasterizer makes of the traced
    # contours; the SEG stores exactly those voxels
    jmask = np.asarray(images[1].rois["Blob"].compute_mask(), np.uint8)
    images[0].rois["Blob"].compute_mask()
    both_segs(images, path=str(tmp_path / "ct" / "seg.dcm"))
    read_both(folder_path=str(tmp_path))

    def refuse(*a, **k):
        raise AssertionError("a SEG ROI was rasterized")

    monkeypatch.setattr(batch, "rasterize_batch", refuse)
    monkeypatch.setattr(batch, "_rasterize_batch_device", refuse)
    got = TData.image["CT 01"].compute_roi_masks(["Blob"])["Blob"]
    np.testing.assert_array_equal(got, jmask)
    np.testing.assert_array_equal(masks_of(TData, "Blob"), jmask)
    assert TData.image["CT 01"].rois["Blob"].contour_position
