"""The deformable model's field has one home, a float32 tensor on the
Deformable's device: the backend keeps its volumes there, the demons
solver leaves its field there, ``_store_dvf`` inverts it there and every
consumer reads it there. The public ``dvf`` is numpy after a solver,
brought down on its first read (``mia.deformable.dvf_out``) and kept
until the field changes. On the CPU, at the sizes of
tests/test_torch_deformable.py."""

import numpy as np
import pytest
import torch
from scipy import ndimage

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.registration import dvf as dvf_ops
from medicalimageanalysis_torch.ops.registration.demons import (
    demons_registration)
from medicalimageanalysis_torch.structure import deformable as deformable_mod
from medicalimageanalysis_torch.utils.creation import CreateDicomImage
from medicalimageanalysis_torch.utils.deformable.torch_backend import (
    DeformableTorch)
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.structure.deformable import (
    Deformable as JDeformable)

SHAPE = (16, 32, 32)
SPACING = [1.5, 1.5, 2.5]          # [sx, sy, sz] mm
ORIGIN = [-24.0, -20.0, -20.0]
SOLVE = dict(iterations=4, crop=0)


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


def phantom():
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]] \
        .astype(np.float64)
    vol = np.full(SHAPE, -1000.0)
    for (bz, by, bx, rz, ry, rx, hu) in ((8, 16, 16, 5, 10, 11, 1040),
                                         (7, 12, 11, 2.5, 4, 4, -700)):
        vol += hu * np.exp(-((zz - bz) / rz) ** 2 - ((yy - by) / ry) ** 2
                           - ((xx - bx) / rx) ** 2)
    return vol


@pytest.fixture
def names(tmp_path):
    """A CT pair related by a smooth bump, written to ``tmp_path`` and
    read by the port (the CPU); returns (reference name, moving name)."""
    ref = phantom()
    zz, yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1], 0:SHAPE[2]] \
        .astype(np.float64)
    bump = np.exp(-((zz - 8) ** 2 / 40 + (yy - 16) ** 2 / 60
                    + (xx - 16) ** 2 / 60))
    mov = ndimage.map_coordinates(ref, [zz, yy + 1.2 * bump,
                                        xx + 1.5 * bump],
                                  order=1, mode="nearest")
    for name, arr, uid in (("ref", ref, "1.2.3.4.1"),
                           ("mov", mov, "1.2.3.4.2")):
        CreateDicomImage(str(tmp_path / name), np.round(arr).astype(np.int16),
                         series=uid, origin=ORIGIN, spacing=SPACING[:2],
                         thickness=SPACING[2]).run()
    tmia.read_dicoms(folder_path=str(tmp_path), device="cpu")
    return tuple(TData.image_list)


def deformable(names, **kw):
    return tmia.Deformable(reference_name=names[0], moving_name=names[1],
                           roi_names=[], device="cpu", **kw)


def spans_of(call):
    """``call()`` under a CPU profiler: its result and the names of the
    port's spans it entered."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = call()
    return out, [e.name for e in prof.events() if e.name.startswith("mia.")]


def test_backend_keeps_its_volumes_on_the_device(names):
    """The volumes go up in their stored dtype; the resample, the masks,
    the crop and the float32 casts stay tensors on the device."""
    ref, mov = (TData.image[n] for n in names)
    b = DeformableTorch(device="cpu")
    b.create_volume(ref.array, ref.origin, ref.spacing, ref.matrix)
    b.create_volume(mov.array, mov.origin, mov.spacing, mov.matrix,
                    reference=False)
    mask = np.zeros(SHAPE, np.uint8)
    mask[4:12, 8:24, 6:20] = 1
    b.create_volume(mask, ref.origin, ref.spacing, ref.matrix, mask=True)
    b.create_volume(mask, mov.origin, mov.spacing, mov.matrix,
                    reference=False, mask=True)
    assert b.reference_image["array"].dtype == torch.int16
    assert b.reference_mask["array"].dtype == torch.uint8
    b.resample()
    b.mask_crop(margin=2)
    b.blur_mask(sigma=2)
    fixed, moving = b._masked_arrays()
    for t in (b.reference_image["array"], b.moving_image["array"],
              b.reference_mask["array"], b.moving_mask["array"], fixed,
              moving):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert tuple(fixed.shape) == (12, 20, 18)
    assert fixed.dtype == moving.dtype == torch.float32
    # the host's casts, the parent's: the same bits
    want = ref.array[2:14, 6:26, 4:22].astype(np.float32) \
        * b.reference_mask["array"].numpy()
    np.testing.assert_array_equal(fixed.numpy(), want)


@pytest.mark.parametrize("method", ["fast", "demons", "diffeomorphic",
                                    "syn", "biomechanical"])
def test_field_is_never_an_ndarray_from_solver_to_create_image(
        names, method, monkeypatch):
    """``_store_dvf`` and ``invert_dvf`` receive tensors, and nothing
    brings the field down before ``dvf`` is read."""
    seen = []
    store, invert = deformable_mod.Deformable._store_dvf, \
        deformable_mod.invert_dvf

    def store_spy(self, volume):
        seen.append(("store", type(volume["array"])))
        return store(self, volume)

    def invert_spy(field, *args, **kwargs):
        seen.append(("invert", type(field)))
        return invert(field, *args, **kwargs)

    monkeypatch.setattr(deformable_mod.Deformable, "_store_dvf", store_spy)
    monkeypatch.setattr(deformable_mod, "invert_dvf", invert_spy)
    d = deformable(names)
    if method == "biomechanical":
        d.compute_biomechanical(iterations=4, crop=0)
    else:
        d.compute_demons(method=method, **SOLVE)
    _, spans = spans_of(lambda: (d.create_image(), d.update_rois(),
                                 d.compute_jacobian()))
    d.display.compute_deformation(division=2)
    assert seen[0] == ("store", torch.Tensor)
    assert set(seen) == {("store", torch.Tensor), ("invert", torch.Tensor)}
    assert isinstance(d._field, torch.Tensor) \
        and d._field.dtype == torch.float32
    assert d._dvf_array is None and "mia.deformable.dvf_out" not in spans


def test_dvf_reads_lazily_as_numpy_equal_to_the_public_route(names,
                                                             tmp_path):
    """The first read brings the field down once, under its span, and
    later reads take that copy; the bits are those of the numpy route
    (``demons_registration`` then ``invert_dvf`` of the array), and the
    field is the JAX package's within tests/test_torch_deformable.py's
    0.15 mm."""
    d = deformable(names)
    d.compute_demons(method="fast", **SOLVE)
    assert d._dvf_array is None
    first, spans = spans_of(lambda: d.dvf)
    assert spans == ["mia.deformable.dvf_out"]
    again, spans = spans_of(lambda: d.dvf)
    assert again is first and spans == []
    assert isinstance(first, np.ndarray) and first.dtype == np.float32
    assert first.shape == SHAPE + (3,)

    b = d._backend(True, 2)
    b.resample()
    fixed, moving = (a.numpy() for a in b._masked_arrays())
    sampling = demons_registration(fixed, moving, b.reference_image[
        "spacing"], method="fast", iterations=4, device="cpu")
    assert isinstance(sampling, np.ndarray)
    want = dvf_ops.invert_dvf(sampling, b.reference_image["spacing"],
                              device="cpu")
    assert isinstance(want, np.ndarray)
    np.testing.assert_array_equal(first, want)

    jmia.read_dicoms(folder_path=str(tmp_path))
    j_def = JDeformable(reference_name=names[0], moving_name=names[1],
                        roi_names=[])
    j_def.compute_demons(method="fast", **SOLVE)
    assert np.abs(first - np.asarray(j_def.dvf)).max() < 0.15

    # a new solve changes the field: the next read brings the new one
    d.compute_demons(method="fast", iterations=2, crop=0)
    assert d._dvf_array is None
    assert not np.array_equal(d.dvf, first)


def test_assigning_dvf_sets_the_field(names):
    """An array reads back as numpy, a tensor as itself; every consumer
    reads what was assigned, as a Deformable made from that field."""
    rng = np.random.default_rng(7)
    field = (0.5 * rng.standard_normal(SHAPE + (3,))).astype(np.float32)
    ref = TData.image[names[0]]
    d = deformable(names, origin=np.asarray(ref.origin),
                   spacing=tuple(ref.spacing))
    d.compute_demons(method="fast", **SOLVE)
    d.dvf                                        # cached on the host
    d.dvf = field
    assert isinstance(d.dvf, np.ndarray)
    np.testing.assert_array_equal(d.dvf, field)
    assert d._field.dtype == torch.float32 and d._field.device.type == "cpu"
    made = interop.deformable_from_numpy(field, d.origin, d.spacing, *names,
                                         name="made", device="cpu")
    np.testing.assert_array_equal(d.create_image()["array"],
                                  made.create_image()["array"])
    np.testing.assert_array_equal(d.compute_jacobian()["det"],
                                  made.compute_jacobian()["det"])

    tensor = torch.from_numpy(field.copy())
    d.dvf = tensor
    assert d.dvf is tensor and d._field is tensor
    d.dvf = None
    assert d.dvf is None and d._field is None
    with pytest.raises(ValueError, match="no DVF"):
        d.compute_jacobian()
