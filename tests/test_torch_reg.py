"""REG ingest and the REG writers in both packages, on the CPU: rigid and
deformable Spatial Registration objects written by the JAX package's test
helpers and by each package's ``create_reg``, read by both.

Tolerances, stated per check:
- rigid matrices: bit-equal between the packages (both invert the same
  float64 file matrix with ``np.linalg.inv``); against the written matrix
  within 1e-12 from the port's writer, which keeps DS values at up to 16
  characters, and within 1e-8 from the JAX package's (10 digits);
- deformable fields: bit-equal (the port's ``np.frombuffer`` decode gives
  the same float32 values the JAX package's ``struct.unpack`` gives; the
  JAX field is those values in float64);
- a field on a rotated grid: within 2 float32 ulp of the JAX package's
  float64 rotation (the port rotates in float64 on the device and keeps
  float32);
- datasets: equal element by element, the UIDs each writer generates
  masked (``assert_same_dataset``).
"""

import struct

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.dicom import dcmread as tdcmread
from medicalimageanalysis_torch.read.reg import decode_vector_grid
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.dicom import (Dataset, Sequence, dcmwrite,
                                            generate_uid, uids)
from test_deformable_dose import write_reg_file

# the UIDs a writer generates; every other element must be equal
GENERATED_TOP = ("SOPInstanceUID", "SeriesInstanceUID")
GENERATED_ANYWHERE = ("DimensionOrganizationUID",)


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


def _values_equal(a, b):
    if isinstance(a, (bytes, bytearray)) or isinstance(b, (bytes,
                                                           bytearray)):
        return bytes(a) == bytes(b)
    try:
        return bool(np.array_equal(np.asarray(a, dtype=object),
                                   np.asarray(b, dtype=object)))
    except Exception:
        return a == b


def assert_same_dataset(a, b, top=GENERATED_TOP, anywhere=GENERATED_ANYWHERE,
                        where="", depth=0):
    """Two datasets equal element by element (tags, VRs, values, nested
    sequences), the generated UIDs (``top`` at the top level,
    ``anywhere`` at any depth) masked."""
    ta, tb = list(a.keys()), list(b.keys())
    assert ta == tb, f"{where}: tags {ta} != {tb}"
    for tag in ta:
        ea, eb = a[tag], b[tag]
        kw = ea.keyword or hex(tag)
        here = f"{where}/{kw}"
        assert ea.VR == eb.VR, f"{here}: VR {ea.VR} != {eb.VR}"
        if kw in anywhere or (depth == 0 and kw in top):
            continue
        if ea.VR == "SQ":
            assert len(ea.value) == len(eb.value), here
            for i, (ia, ib) in enumerate(zip(ea.value, eb.value)):
                assert_same_dataset(ia, ib, top, anywhere,
                                    f"{here}[{i}]", depth + 1)
        else:
            assert _values_equal(ea.value, eb.value), \
                f"{here}: {ea.value!r} != {eb.value!r}"


def two_series(tmp_path, rng, shape=(4, 16, 16), **kw):
    arr = rng.integers(0, 100, size=shape).astype(np.int16)
    info_a = write_ct_series(tmp_path / "a", arr, **kw)
    info_b = write_ct_series(tmp_path / "b", arr, modality="MR", **kw)
    return info_a, info_b


def read_both(folder):
    jmia.read_dicoms(folder_path=str(folder))
    return tmia.read_dicoms(folder_path=str(folder))


def write_deformable_reg(path, info_a, info_b, dvf, pre, orientation=(
        1, 0, 0, 0, 1, 0), origin=(-10.0, -20.0, -30.0),
        resolution=(2.0, 2.0, 5.0)):
    """A deformable REG as tests/test_deformable_dose.py:268 builds it:
    ``dvf`` (Z, Y, X, 3) float32, ``pre`` the 4x4 file matrix."""
    ds = Dataset()
    ds.SOPClassUID = uids.DeformableSpatialRegistrationStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "REG"
    ds.PatientID = "MRN001"

    def series_item(info):
        item = Dataset()
        item.SeriesInstanceUID = info["series_uid"]
        refs = Sequence()
        for sop in info["sops"]:
            r = Dataset()
            r.ReferencedSOPInstanceUID = sop
            refs.append(r)
        item.ReferencedInstanceSequence = refs
        return item

    ds.ReferencedSeriesSequence = Sequence(
        [series_item(info_a), series_item(info_b)])
    pre_item = Dataset()
    pre_item.FrameOfReferenceTransformationMatrix = [
        float(v) for v in np.asarray(pre).reshape(-1)]
    grid = Dataset()
    grid.ImageOrientationPatient = list(orientation)
    grid.ImagePositionPatient = list(origin)
    z, y, x = dvf.shape[:3]
    grid.GridDimensions = [x, y, z]
    grid.GridResolution = list(resolution)
    grid.VectorGridData = np.ascontiguousarray(dvf, "<f4").tobytes()
    dreg = Dataset()
    dreg.PreDeformationMatrixRegistrationSequence = Sequence([pre_item])
    dreg.DeformableRegistrationGridSequence = Sequence([grid])
    ds.DeformableRegistrationSequence = Sequence([dreg])
    dcmwrite(path, ds)


def test_read_reg_rigid_matches_jax(tmp_path, rng):
    info_a, info_b = two_series(tmp_path, rng)
    m = np.eye(4)
    m[:3, 3] = [5.0, -3.0, 2.0]
    write_reg_file(tmp_path / "reg.dcm", info_a, info_b, m)
    reader = read_both(tmp_path)
    assert TData.rigid_list == JData.rigid_list == ["CT 01_MR 02"]
    assert reader.report.rigid_created == ["CT 01_MR 02"]
    t, j = TData.rigid["CT 01_MR 02"], JData.rigid["CT 01_MR 02"]
    np.testing.assert_array_equal(t.matrix, j.matrix)
    np.testing.assert_array_equal(t.matrix, np.linalg.inv(m))
    assert t.slices["moving_sops"] == j.slices["moving_sops"]
    assert t.device == torch.device("cpu")


def test_read_reg_rigid_without_images_registers_nothing(tmp_path, rng):
    info_a, info_b = two_series(tmp_path, rng)
    write_reg_file(tmp_path / "reg.dcm", info_a, info_b, np.eye(4))
    only = [str(tmp_path / "reg.dcm")]
    jmia.read_dicoms(file_list=only)
    reader = tmia.read_dicoms(file_list=only)
    assert TData.rigid_list == JData.rigid_list == []
    assert not reader.report.failed_series


@pytest.mark.parametrize("orientation", [(1, 0, 0, 0, 1, 0),
                                         (0, 1, 0, -1, 0, 0)],
                         ids=["axial", "rotated"])
def test_read_reg_deformable_matches_jax(tmp_path, rng, orientation):
    info_a, info_b = two_series(tmp_path, rng)
    dvf = rng.normal(0, 1.0, size=(4, 8, 6, 3)).astype("<f4")
    pre = np.eye(4)
    pre[:3, 3] = [1.0, 2.0, 3.0]
    write_deformable_reg(tmp_path / "dreg.dcm", info_a, info_b, dvf, pre,
                         orientation=orientation)
    reader = read_both(tmp_path)
    name = "DVF_CT 01_MR 02"
    assert TData.deformable_list == JData.deformable_list == [name]
    assert reader.report.deformable_created == [name]
    t, j = TData.deformable[name], JData.deformable[name]
    assert isinstance(t.dvf, torch.Tensor) and t.dvf.device.type == "cpu"
    assert t.dvf.dtype == torch.float32
    got, ref = t.dvf.numpy(), np.asarray(j.dvf)
    assert got.shape == ref.shape
    if orientation[0] == 1:
        np.testing.assert_array_equal(got, dvf)
        np.testing.assert_array_equal(got, ref)
    else:
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert np.all(np.abs(got - ref) <= 2 * ulp)
    np.testing.assert_array_equal(t.rigid_matrix, j.rigid_matrix)
    np.testing.assert_array_equal(np.asarray(t.origin, np.float64),
                                  np.asarray(j.origin, np.float64))
    np.testing.assert_array_equal(np.asarray(t.spacing, np.float64),
                                  np.asarray(j.spacing, np.float64))


def test_vector_grid_decode_is_bit_equal_to_struct_unpack(rng):
    vals = rng.normal(0, 100, size=4 * 5 * 6 * 3).astype("<f4")
    vals[:6] = [np.nan, np.inf, -np.inf, -0.0, 1e-45, 3.4e38]
    raw = vals.tobytes()
    ref = np.asarray(struct.unpack(f"<{len(raw) // 4}f", raw), np.float32)
    got = decode_vector_grid(raw, (4, 5, 6), torch.device("cpu"))
    assert got.shape == (4, 5, 6, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.uint32),
                                  ref.view(np.uint32))


def test_deformable_reg_names_keep_the_dvf_prefix(tmp_path, rng):
    info_a, info_b = two_series(tmp_path, rng)
    dvf = rng.normal(0, 1.0, size=(2, 3, 4, 3)).astype("<f4")
    for i in range(2):
        write_deformable_reg(tmp_path / f"dreg{i}.dcm", info_a, info_b,
                             dvf, np.eye(4))
    files = [str(tmp_path / f"dreg{i}.dcm") for i in range(2)]
    jmia.read_dicoms(file_list=files)
    tmia.read_dicoms(file_list=files)
    assert TData.deformable_list == JData.deformable_list \
        == ["DVF__Unknown", "DVF__Unknown_1"]


def _rigid_pair(tmp_path, rng):
    two_series(tmp_path, rng)
    read_both(tmp_path)
    return "CT 01", "MR 02"


MATRICES = {
    "rigid": np.array([[0.0, -1.0, 0.0, 5.0], [1.0, 0.0, 0.0, -3.0],
                       [0.0, 0.0, 1.0, 2.0], [0, 0, 0, 1.0]]),
    "rigid_scale": np.diag([1.5, 1.5, 1.5, 1.0]),
    "affine": np.array([[1.0, 0.2, 0.0, 1.0], [0.0, 1.0, 0.0, 0.0],
                        [0.0, 0.0, 0.9, -2.0], [0, 0, 0, 1.0]]),
}


@pytest.mark.parametrize("kind", sorted(MATRICES))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rigid_create_reg_round_trips_across_packages(tmp_path, rng, kind,
                                                      writer):
    ct, mr = _rigid_pair(tmp_path, rng)
    m = MATRICES[kind]
    t_ds = tmia.Rigid(ct, mr, matrix=m, device="cpu").create_reg()
    j_ds = jmia.Rigid(ct, mr, matrix=m).create_reg()
    assert_same_dataset(t_ds, j_ds)
    assert t_ds.RegistrationSequence[1].MatrixRegistrationSequence[0] \
        .MatrixSequence[0].FrameOfReferenceTransformationMatrixType \
        == kind.upper()
    path = tmp_path / "reg.dcm"
    dcmwrite(str(path), t_ds if writer == "port" else j_ds)
    read_both(tmp_path)
    assert TData.rigid_list == JData.rigid_list == ["CT 01_MR 02"]
    t, j = TData.rigid["CT 01_MR 02"], JData.rigid["CT 01_MR 02"]
    np.testing.assert_array_equal(t.matrix, j.matrix)
    np.testing.assert_allclose(t.matrix, m, atol=1e-12)
    # the file the port wrote parses to the same elements in the port
    back = tdcmread(str(path))
    assert back.Modality == "REG" and len(back.ReferencedSeriesSequence) \
        == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fitted_rigid_matrix_precision_through_reg(tmp_path, rng, writer):
    """A fitted matrix (no short decimals): the port writes DS values at
    up to their 16 characters, so it reads back within 1e-12; the JAX
    package's writer keeps 10 significant digits (within 1e-8). Both
    packages read each file to the same matrix."""
    from scipy.spatial.transform import Rotation

    ct, mr = _rigid_pair(tmp_path, rng)
    m = np.eye(4)
    m[:3, :3] = Rotation.from_euler("xyz", [0.37, -1.91, 3.07],
                                    degrees=True).as_matrix()
    m[:3, 3] = [3.987654321098765, -1.2345678901234567, 0.5000000001]
    if writer == "port":
        tmia.Rigid(ct, mr, matrix=m, device="cpu").create_reg(
            path=str(tmp_path / "reg.dcm"))
    else:
        jmia.Rigid(ct, mr, matrix=m).create_reg(path=str(tmp_path
                                                         / "reg.dcm"))
    read_both(tmp_path)
    t, j = TData.rigid["CT 01_MR 02"], JData.rigid["CT 01_MR 02"]
    np.testing.assert_array_equal(t.matrix, j.matrix)
    bound = 1e-12 if writer == "port" else 1e-8
    assert np.abs(t.matrix - m).max() <= bound


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_deformable_create_reg_round_trips_across_packages(tmp_path, rng,
                                                           writer):
    two_series(tmp_path, rng, spacing=(1, 1), thickness=2.0)
    read_both(tmp_path)
    ref = TData.image["CT 01"]
    dvf = rng.normal(0, 1.5, size=tuple(ref.dimensions) + (3,)) \
        .astype(np.float32)
    rig = np.eye(4)
    rig[:3, 3] = [1.0, 2.0, 3.0]
    kw = dict(origin=ref.origin, spacing=ref.spacing,
              dimensions=ref.dimensions, rigid_matrix=rig,
              reference_name="CT 01", moving_name="MR 02", roi_names=[])
    # the port's field on the device (a tensor), the JAX one in numpy
    t_def = tmia.Deformable(dvf=torch.from_numpy(dvf.copy()),
                            device="cpu", **kw)
    j_def = jmia.Deformable(dvf=dvf, **kw)
    t_ds, j_ds = t_def.create_reg(), j_def.create_reg()
    assert_same_dataset(t_ds, j_ds)
    dcmwrite(str(tmp_path / "dreg.dcm"), t_ds if writer == "port" else j_ds)
    read_both(tmp_path)
    name = "DVF_CT 01_MR 02"
    assert TData.deformable_list == JData.deformable_list == [name]
    t, j = TData.deformable[name], JData.deformable[name]
    np.testing.assert_array_equal(t.dvf.numpy(), dvf)
    np.testing.assert_array_equal(np.asarray(j.dvf), dvf)
    np.testing.assert_array_equal(t.rigid_matrix, j.rigid_matrix)
    np.testing.assert_allclose(t.rigid_matrix, rig, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(t.origin, np.float64),
                                  np.asarray(ref.origin, np.float64))


def test_deformable_create_reg_needs_a_field_and_both_images(tmp_path, rng):
    d = tmia.Deformable(device="cpu")
    with pytest.raises(ValueError, match="no DVF"):
        d.create_reg()
    d.dvf = np.zeros((2, 2, 2, 3), np.float32)
    with pytest.raises(ValueError, match="both be loaded"):
        d.create_reg()
    with pytest.raises(ValueError, match="both be loaded"):
        tmia.Rigid("a", "b", device="cpu").create_reg()


def test_readers_raise_without_a_card_unless_the_cpu_is_asked(
        tmp_path, rng, monkeypatch):
    info_a, info_b = two_series(tmp_path, rng)
    write_deformable_reg(tmp_path / "dreg.dcm", info_a, info_b,
                         np.zeros((2, 3, 4, 3), np.float32), np.eye(4))
    set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmia.read_dicoms(folder_path=str(tmp_path))
    from medicalimageanalysis_torch.read.reg import ReadREG
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReadREG(tdcmread(str(tmp_path / "dreg.dcm")), only_tags=False)
    assert TData.deformable_list == []
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    assert TData.deformable["DVF_CT 01_MR 02"].dvf.device.type == "cpu"
