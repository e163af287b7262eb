"""The Rigid view's overlay kept on the device (``Display.overlay``), on
the CPU: each plane cut there against the same plane sliced on the host
from ``Rigid.create_image``'s numpy, equal bit for bit; ``Display.array``
brought down only when read, once a reslice; the scroll limits read
from the tensor; the ``VIEW`` counter. On the CPU the device is the CPU,
and the cut, the copy and the cast are the calls the card runs."""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.config import config as tconfig
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import resample as tresample
from medicalimageanalysis_torch.structure.rigid import VIEW

SHAPE = (12, 28, 30)
SPACING = [1.5, 1.2, 2.5]            # [sx, sy, sz] mm
PLANES = ("Axial", "Coronal", "Sagittal")
AXIS = {"Axial": 0, "Coronal": 1, "Sagittal": 2}
# rotations (degrees about x, y, z) and translations (mm), in turn
NUDGES = [("rotate", (3.0, -2.0, 5.0)), ("translate", (1.5, -0.5, 2.0)),
          ("rotate", (-4.0, 1.0, 0.0)), ("translate", (-1.0, 2.0, 0.0)),
          ("rotate", (0.0, 0.0, -9.0))]


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    tconfig.use_shear_warp = False
    TData.clear()
    set_default_device(None)


def blob(shift):
    """A noisy HU-like ellipsoid on SHAPE, its centre moved by ``shift``
    voxels (z, y, x)."""
    rng = np.random.default_rng(7)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in SHAPE),
                          indexing="ij")
    c = [(n - 1) / 2 + s for n, s in zip(SHAPE, shift)]
    r2 = (((z - c[0]) / 4) ** 2 + ((y - c[1]) / 8) ** 2
          + ((x - c[2]) / 9) ** 2)
    vol = 1000.0 * np.exp(-r2) - 1000.0 + rng.normal(0, 20, SHAPE)
    return vol.astype(np.int16)


def pair():
    """A Rigid of a shifted, offset overlay onto a reference."""
    interop.image_from_arrays(blob((0.0, 0.0, 0.0)), SPACING,
                              [0.0, 0.0, 0.0], np.eye(3), "CT", "reference")
    interop.image_from_arrays(blob((0.5, 2.0, -1.0)), SPACING,
                              [-3.0, 1.5, 2.5], np.eye(3), "CT", "overlay")
    return tmia.Rigid("reference", "overlay", device="cpu")


def nudge(rigid, kind, v):
    if kind == "rotate":
        rigid.update_rotation(r_x=v[0], r_y=v[1], r_z=v[2])
    else:
        rigid.update_translation(*v)


def host_plane(volume, location, plane):
    """The parent's cut: the host array sliced, then cast to float64."""
    axis = AXIS[plane]
    if not 0 <= location[axis] < volume.shape[axis]:
        return None
    cut = (slice(None),) * axis + (int(location[axis]),)
    return volume[cut].astype(np.double)


def assert_same(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dtype == np.float64 and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("shear", [False, True], ids=["affine", "shear"])
def test_device_planes_equal_host_slices_of_create_image(shear):
    tconfig.use_shear_warp = shear
    rigid = pair()
    display = rigid.display
    for p in PLANES:                          # the first reslice
        rigid.retrieve_array_plane(p)
    # the volume the overlay was resliced from, as the host would hold it
    host = rigid.create_image()["array"]
    for kind, v in NUDGES:
        nudge(rigid, kind, v)
        if kind == "rotate":
            host = rigid.create_image()["array"]
        assert display.shape == host.shape
        for p in PLANES:                      # at the reference's planes
            got = rigid.retrieve_array_plane(p)
            assert_same(got, host_plane(host, display.slice_location, p))
        last = [n - 1 for n in host.shape]
        for location in ([0, 0, 0], last, [n // 2 for n in host.shape],
                         [-1, -1, -1], [n for n in host.shape]):
            display.slice_location = list(location)
            for p in PLANES:
                got = rigid.retrieve_array_plane(p, solo=True)
                assert_same(got, host_plane(host, location, p))
        # one axis out of range, the others in
        display.slice_location = [host.shape[0], 0, -1]
        assert rigid.retrieve_array_plane("Axial", solo=True) is None
        assert rigid.retrieve_array_plane("Sagittal", solo=True) is None
        assert_same(rigid.retrieve_array_plane("Coronal", solo=True),
                    host_plane(host, [0, 0, 0], "Coronal"))
    assert display.overlay is not None and display._array is None


def test_a_nudge_cycle_brings_no_volume_down():
    rigid = pair()
    before = dict(VIEW)
    shown = sum(rigid.retrieve_array_plane(p) is not None for p in PLANES)
    for kind, v in NUDGES:
        nudge(rigid, kind, v)
        shown += sum(rigid.retrieve_array_plane(p) is not None
                     for p in PLANES)
    rotations = sum(kind == "rotate" for kind, _ in NUDGES)
    assert shown > 0
    assert VIEW["volume_reads"] == before["volume_reads"]
    assert VIEW["reslices"] - before["reslices"] == 1 + rotations
    assert VIEW["planes"] - before["planes"] == shown


def test_array_is_read_once_a_reslice_and_equals_create_image():
    rigid = pair()
    rigid.update_rotation(r_x=2.0, r_z=-6.0)
    before = VIEW["volume_reads"]
    a = rigid.display.array
    b = rigid.display.array
    assert VIEW["volume_reads"] == before + 1
    assert a is b and isinstance(a, np.ndarray) and a.dtype == np.float32
    assert np.array_equal(a, rigid.create_image()["array"])
    # a translation keeps the overlay, and so the read
    rigid.update_translation(1.0, 0.0, -2.0)
    assert rigid.display.array is a
    assert VIEW["volume_reads"] == before + 1
    # a rotation reslices: the next read brings the new overlay down
    rigid.update_rotation(r_y=4.0)
    c = rigid.display.array
    assert VIEW["volume_reads"] == before + 2
    assert np.array_equal(c, rigid.create_image()["array"])


def test_scroll_max_is_read_from_the_overlay_without_a_copy():
    rigid = pair()
    before = VIEW["volume_reads"]
    rigid.update_rotation(r_x=-3.0, r_y=7.0, r_z=11.0)
    shape = rigid.create_image()["array"].shape
    assert rigid.display.scroll_max == [n - 1 for n in shape]
    assert [rigid.retrieve_scroll_max(p) for p in PLANES] \
        == [n - 1 for n in shape]
    assert rigid.display.shape == shape
    rigid.update_translation(2.0, -1.0, 0.5)
    assert rigid.display.scroll_max == [n - 1 for n in shape]
    assert VIEW["volume_reads"] == before


def test_array_setter_replaces_and_clears_the_overlay():
    rigid = pair()
    display = rigid.display
    rigid.update_rotation(r_z=5.0)
    held = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    before = dict(VIEW)
    display.array = held
    assert display.overlay is None and display.array is held
    display.compute_scroll_max()
    assert display.scroll_max == [n - 1 for n in SHAPE]
    display.slice_location = [3, 4, 5]
    for p in PLANES:
        assert_same(display.compute_array_slice(p),
                    host_plane(held, [3, 4, 5], p))
    assert VIEW == before                     # cut on the host, no read
    display.array = None
    assert display.shape is None and display.array is None
    # an empty display reslices on the next plane asked for
    assert rigid.retrieve_array_plane("Axial") is not None
    assert VIEW["reslices"] == before["reslices"] + 1
    assert display.overlay is not None


@pytest.mark.parametrize("shear", [False, True], ids=["affine", "shear"])
def test_reslice_transform_is_reslice_tensor_brought_down(shear):
    tconfig.use_shear_warp = shear
    vol = blob((1.0, -2.0, 0.5))
    T = np.eye(4)
    T[:3, :3] = np.array([[0.99, -0.12, 0.05], [0.12, 0.99, 0.0],
                          [-0.05, 0.01, 0.998]])
    T[:3, 3] = [1.5, -2.0, 0.75]
    args = (vol, np.eye(3), SPACING, [0.0, 0.0, 0.0], T, SPACING)
    on_host = tresample.reslice_transform(*args, device="cpu")
    kept = tresample.reslice_tensor(*args, device="cpu")
    assert isinstance(on_host["array"], np.ndarray)
    assert isinstance(kept["array"], torch.Tensor)
    assert np.array_equal(on_host["array"], kept["array"].numpy())
    for key in ("origin", "spacing", "dimensions"):
        assert np.array_equal(on_host[key], kept[key]), key
