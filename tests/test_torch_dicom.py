"""The port's copy of the DICOM core (medicalimageanalysis_torch.dicom and
.native) against the JAX package's: the same files parsed by both give
the same element values and the same ``pixel_array``, bit for bit. Both
native scanners are loaded in this one process, each from its own
library."""

import numpy as np
import pytest
import torch

from helpers import write_ct_series, write_rtstruct
from medicalimageanalysis_torch import dicom as tdicom
from medicalimageanalysis_torch import native as tnative
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_tpu import dicom as jdicom
from medicalimageanalysis_tpu import native as jnative
from medicalimageanalysis_tpu.dicom import uids
from medicalimageanalysis_tpu.utils.creation import CreateDicomImage
from test_deformable_dose import write_rtdose_file


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def values(ds):
    """Every element as (tag, VR, value), sequences recursed, arrays and
    byte strings as bytes."""
    out = []
    for el in ds.elements():
        v = el.value
        if isinstance(v, list) and v and hasattr(v[0], "elements"):
            v = [values(item) for item in v]
        elif isinstance(v, np.ndarray):
            v = (v.dtype.str, v.shape, v.tobytes())
        elif isinstance(v, (bytes, bytearray, memoryview)):
            v = bytes(v)
        out.append((el.tag, el.VR, v))
    return out


def write_file(kind, folder):
    r = np.random.default_rng(9)
    ct = r.integers(-1000, 2000, size=(3, 24, 20)).astype(np.int16)
    if kind == "ct_rle":
        CreateDicomImage(folder / "rle", ct, origin=[0, 0, 0],
                         spacing=[1, 1], thickness=2,
                         transfer_syntax=uids.RLELossless).run()
        return folder / "rle" / "1.dcm"
    info = write_ct_series(folder / "ct", ct, spacing=(1.0, 1.0),
                           thickness=2.0)
    if kind == "ct":
        return folder / "ct" / "1.dcm"
    if kind == "rtstruct":
        sq = np.array([[-95.0, -115.0, -48.0], [-90.0, -115.0, -48.0],
                       [-90.0, -110.0, -48.0]])
        write_rtstruct(folder / "rs.dcm", info, {"A": [(sq, 1)]},
                       pois={"P": [0.0, 1.0, 2.0]})
        return folder / "rs.dcm"
    dose = r.integers(0, 2 ** 32, size=(3, 6, 7), dtype=np.uint64)
    write_rtdose_file(folder / "rd.dcm", dose.astype(np.uint32), info,
                      scaling=1e-8)
    return folder / "rd.dcm"


@pytest.mark.parametrize("kind", ["ct", "rtstruct", "rtdose", "ct_rle"])
def test_both_copies_parse_alike(kind, tmp_path):
    path = str(write_file(kind, tmp_path))
    t, j = tdicom.dcmread(path), jdicom.dcmread(path)
    assert values(t.file_meta) == values(j.file_meta)
    assert values(t) == values(j)
    if kind == "ct_rle":
        assert j.file_meta.TransferSyntaxUID == uids.RLELossless
    if kind != "rtstruct":
        tp, jp = t.pixel_array, j.pixel_array
        assert tp.dtype == jp.dtype and tp.shape == jp.shape
        np.testing.assert_array_equal(tp, jp)
    # the batch scanner of each copy gives the same entry table
    buf = open(path, "rb").read()
    t_scan, j_scan = tnative.scan(buf), jnative.scan(buf)
    assert t_scan is not None and j_scan is not None
    np.testing.assert_array_equal(t_scan[0], j_scan[0])
    assert t_scan[1] == j_scan[1]


def test_port_builds_its_own_scanner_library():
    """The port's scanner is built from its own source into
    build/torch_ext/, never the JAX package's libmiadicom.so."""
    assert tnative.get_lib() is not None
    assert "build/torch_ext/libmia_torch_dicom_" in tnative._SO
    assert tnative._SO != jnative._SO
    assert tnative.get_lib()._name == tnative._SO
