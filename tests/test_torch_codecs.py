"""Compressed DICOM in the port on a machine without cv2 (the card's):
8-bit JPEG Baseline decodes through the native sequential-DCT decoder,
bit-equal to the JAX package's ``native.jpeg_dct_decode`` of the same
stream and within 1 of cv2's decode; the syntaxes only cv2 decodes raise
a typed error naming the transfer syntax and cv2. ``sys.modules["cv2"]
= None`` makes ``import cv2`` fail as it does there."""

import sys

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
from medicalimageanalysis_torch import dicom as tdicom
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.dicom import pixels as tpixels
from medicalimageanalysis_torch.dicom import uids
from medicalimageanalysis_torch.dicom.jpegdct import encode_jpeg_dct
from medicalimageanalysis_torch.utils.creation import CreateDicomImage
from medicalimageanalysis_tpu.native import jpeg_dct_decode


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def smooth_u8(n, rows, cols, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols]
    out = []
    for k in range(n):
        a, b = r.uniform(3.0, 7.0, 2)
        out.append((128 + 100 * np.sin(yy / a + k) * np.cos(xx / b))
                   .clip(0, 255).astype(np.uint8))
    return np.stack(out)


def write_jpeg_series(folder, vol):
    """The port's series writer, then each slice re-encoded by the port's
    JPEG encoder (8-bit, SOF0) and written by its dcmwrite as JPEG
    Baseline. Returns the paths and the streams."""
    gen = CreateDicomImage(folder, vol.astype(np.int16), origin=[0, 0, 0],
                           spacing=[0.8, 0.8], thickness=2.0)
    gen.run(rescale_intercept=-100)
    paths, streams = [], []
    for k, sop in enumerate(gen.sops):
        path = folder / f"{k}.dcm"
        ds = tdicom.dcmread(str(path))
        assert ds.SOPInstanceUID == sop
        stream = encode_jpeg_dct(vol[k], precision=8, quant=1)
        ds.BitsAllocated = 8
        ds.BitsStored = 8
        ds.HighBit = 7
        ds.PixelRepresentation = 0
        ds.PixelData = [stream]
        tdicom.dcmwrite(str(path), ds, transfer_syntax=uids.JPEGBaseline8Bit)
        paths.append(str(path))
        streams.append(stream)
    return paths, streams


def test_jpeg_baseline_series_reads_without_cv2(tmp_path, monkeypatch):
    import cv2

    vol = smooth_u8(4, 32, 40, seed=11)
    paths, streams = write_jpeg_series(tmp_path / "jpeg", vol)
    ref = [jpeg_dct_decode(s) for s in streams]
    by_cv2 = [cv2.imdecode(np.frombuffer(s, np.uint8), cv2.IMREAD_UNCHANGED)
              for s in streams]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401,F811
    for path, want, other in zip(paths, ref, by_cv2):
        got = tdicom.dcmread(path).pixel_array
        # the decoder's int32 samples, in the series' uint8
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got.astype(np.int64), want)
        assert np.abs(got.astype(int) - other.astype(int)).max() <= 1
    tmia.read_dicoms(folder_path=str(tmp_path / "jpeg"), device="cpu")
    assert len(TData.image_list) == 1
    img = TData.image[TData.image_list[0]]
    np.testing.assert_array_equal(
        img.array, np.stack(ref).astype(np.int16) - 100)


def test_only_cv2_syntaxes_raise_a_typed_error_without_cv2(monkeypatch):
    """Other encapsulated syntaxes go to cv2 alone; without it they raise
    CodecUnavailableError (an ImportError) naming the syntax and cv2, not
    a bare ModuleNotFoundError."""
    ds = tdicom.Dataset()
    ds.file_meta = tdicom.FileMetaDataset()
    ds.file_meta.TransferSyntaxUID = uids.JPEGBaseline8Bit
    ds.Rows, ds.Columns, ds.SamplesPerPixel = 8, 8, 1
    ds.BitsAllocated, ds.BitsStored, ds.PixelRepresentation = 8, 8, 0
    ds.PixelData = [encode_jpeg_dct(np.full((8, 8), 7, np.uint8),
                                    precision=8)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(tpixels.CodecUnavailableError,
                       match=f"{uids.JPEGBaseline8Bit}.*cv2"):
        tpixels.decode_jpeg_cv2(ds)
    assert issubclass(tpixels.CodecUnavailableError, ImportError)


def test_htj2k_without_cv2_names_the_syntax(monkeypatch):
    """An HT codestream (Rsiz bit 14) that no decoder here but cv2 takes:
    CodecUnavailableError naming the HTJ2K syntax and cv2."""
    from medicalimageanalysis_torch import native as tnative
    from medicalimageanalysis_torch.dicom.jpeg2k_enc import encode_j2k

    frame = (np.arange(64, dtype=np.uint16).reshape(8, 8) * 17) & 0xFFF
    stream = bytearray(encode_j2k(frame, precision=12, levels=1))
    assert bytes(stream[:4]) == b"\xFF\x4F\xFF\x51"
    stream[6] |= 0x40                      # Rsiz: HT capabilities
    ds = tdicom.Dataset()
    ds.file_meta = tdicom.FileMetaDataset()
    ds.file_meta.TransferSyntaxUID = uids.HTJ2KLossless
    ds.Rows, ds.Columns, ds.SamplesPerPixel = 8, 8, 1
    ds.BitsAllocated, ds.BitsStored, ds.PixelRepresentation = 16, 12, 0
    ds.PixelData = [bytes(stream)]
    monkeypatch.setattr(tnative, "j2k_decode", lambda frag: None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(tpixels.CodecUnavailableError,
                       match=f"{uids.HTJ2KLossless}.*cv2"):
        tpixels.decode_jpeg2000(ds)
