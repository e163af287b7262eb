"""The pooled ROI masks cropped and bit-packed on the device
(``Image._roi_mask_cache_pack``, ops/bitpack.packbits_device) on the CPU:
the packed bytes equal ``np.packbits``, the bboxes equal the host's
``any`` projections, every cache entry equals the one the host path
(``_roi_mask_cache_put`` of ``rasterize_batch``'s masks) makes, and
``compute_roi_masks`` equals that path and the JAX package's, bit for
bit, in all three planes. Tolerance 0 throughout: the masks are
integers. The JAX package rasterizes with its device backend here, as on
its chip: its host cv2 backend parts from it on polygons that cross the
grid's low faces (negative vertices), and the port follows the device
backend."""

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
import medicalimageanalysis_tpu as jmia
from helpers import write_ct_series
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops import rasterize as traster
from medicalimageanalysis_torch.ops.bitpack import (packbits_device,
                                                    unpackbits_device)
from medicalimageanalysis_torch.parallel import batch as tbatch
from medicalimageanalysis_torch.structure import image as timage
from medicalimageanalysis_tpu.data import Data as JData
from medicalimageanalysis_tpu.structure.roi import Roi as JRoi
from medicalimageanalysis_tpu.utils.convert import contour as jcontour

SHAPE = (9, 26, 30)                    # CT (z, y, x)
ORIGIN = (-14.0, -12.0, -8.0)
SPACING = (1.0, 1.0)
THICK = 2.0
PLANES = ("Axial", "Coronal", "Sagittal")


@pytest.fixture(autouse=True)
def torch_env(monkeypatch):
    monkeypatch.setattr(jcontour, "_pick_raster_backend",
                        lambda *args, **kwargs: "device")
    TData.clear()
    JData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    JData.clear()
    set_default_device(None)


# -- the packing ---------------------------------------------------------
def bits_of(kind, n, seed=0):
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "ones":
        return np.ones(n, np.uint8)
    return np.random.default_rng(seed + n).integers(0, 2, n).astype(np.uint8)


@pytest.mark.parametrize("kind", ["zeros", "ones", "random"])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 8 * 37 + 3])
def test_packbits_device_equals_numpy(n, kind):
    bits = bits_of(kind, n)
    packed, counts = packbits_device([torch.from_numpy(bits)])
    want = np.packbits(bits)
    assert packed.dtype == torch.uint8 and counts == [want.size]
    np.testing.assert_array_equal(packed.numpy(), want)
    # and back: np.unpackbits of the first n bits
    np.testing.assert_array_equal(unpackbits_device(packed, n).numpy(),
                                  bits)


def test_packbits_device_of_strided_crops_one_after_another():
    """Crops of a (B, Z, Y, X) volume, each strided and of a length not a
    multiple of 8, packed in one call: each crop's bytes are its own
    ``np.packbits``, back to back."""
    vol = np.random.default_rng(4).integers(0, 2, (3, 6, 9, 11)) \
        .astype(np.uint8)
    t = torch.from_numpy(vol).movedim(1, 2)           # (3, 9, 6, 11) view
    cuts = [(0, slice(1, 4), slice(0, 5), slice(2, 9)),
            (1, slice(0, 9), slice(3, 4), slice(0, 11)),
            (2, slice(5, 6), slice(2, 3), slice(7, 8))]
    packed, counts = packbits_device([t[c] for c in cuts])
    wants = [np.packbits(np.ascontiguousarray(t[c].numpy())) for c in cuts]
    assert counts == [w.size for w in wants]
    np.testing.assert_array_equal(packed.numpy(), np.concatenate(wants))


# -- the bboxes and the cache entries ------------------------------------
def host_entry(image, name, mask):
    """The entry the host path makes of ``mask``, the image's own cache
    left as it was."""
    kept = getattr(image, "_roi_mask_cache", None)
    image._roi_mask_cache = {}
    try:
        image._roi_mask_cache_put(name, image.rois[name], mask)
        return image._roi_mask_cache[name]
    finally:
        image._roi_mask_cache = kept


def assert_same_entry(got, want):
    assert got[0] == want[0] and got[1] == want[1] and got[4] == want[4]
    assert got[2] == want[2]
    if want[3] is None:
        assert got[3] is None
    else:
        assert got[3].dtype == want[3].dtype and got[3].flags.owndata
        np.testing.assert_array_equal(got[3], want[3])


def row(case):
    m = np.zeros(SHAPE, np.uint8)
    Z, Y, X = SHAPE
    if case == "interior":
        m[2:6, 4:20, 7:23] = np.random.default_rng(1).integers(
            0, 2, (4, 16, 16))
        m[2, 4, 7] = m[5, 19, 22] = 1
    elif case == "faces":
        m[0, 5, 5] = m[Z - 1, 6, 6] = m[3, 0, 7] = m[4, Y - 1, 8] = 1
        m[5, 9, 0] = m[6, 10, X - 1] = 1
    elif case == "corner":
        m[Z - 1, Y - 1, X - 1] = 1
    elif case == "full":
        m[:] = 1
    return m


@pytest.mark.parametrize("case", ["interior", "faces", "corner", "full",
                                  "empty"])
def test_device_bbox_and_entry_equal_the_host_path(case):
    """One row of each case beside an interior row: the device's bbox
    equals the host's ``any`` projections, and each entry equals
    ``_roi_mask_cache_put``'s, an empty ROI's too."""
    image = interop.image_from_arrays(np.zeros(SHAPE, np.int16),
                                      [1.0, 1.0, 2.0], [0.0, 0.0, 0.0],
                                      np.eye(3), "CT", "CT")
    for name in ("A", "B"):
        image.create_roi(name=name)
    masks = np.stack([row(case), row("interior")])
    before = dict(timage.MASKS)
    image._roi_mask_cache_pack(["A", "B"], torch.from_numpy(masks))
    for name, mask in zip(("A", "B"), masks):
        assert_same_entry(image._roi_mask_cache[name],
                          host_entry(image, name, mask))
        if mask.any():
            zs, ys, xs = (np.flatnonzero(mask.any(axis=a))
                          for a in ((1, 2), (0, 2), (0, 1)))
            assert image._roi_mask_cache[name][2] == (
                zs[0], zs[-1] + 1, ys[0], ys[-1] + 1, xs[0], xs[-1] + 1)
    packed = [e[3] for e in image._roi_mask_cache.values()
              if e[3] is not None]
    assert timage.MASKS["device_packs"] - before["device_packs"] == \
        len(packed)
    assert timage.MASKS["packed_bytes"] - before["packed_bytes"] == \
        sum(p.nbytes for p in packed)


# -- compute_roi_masks against the host path and the JAX package -----------
def star(r, a0, b0, n, rmin, rmax):
    th = np.sort(r.uniform(0, 2 * np.pi, n))
    rad = r.uniform(rmin, rmax, n)
    return a0 + rad * np.cos(th), b0 + rad * np.sin(th)


def contours_mm(plane, seed):
    """Three ROIs of star polygons in ``plane`` (Edge's crossing a face
    of the grid), as (N, 3) mm contours on whole slices."""
    r = np.random.default_rng(seed)
    Z, Y, X = SHAPE
    out = {}
    for k, name in enumerate(("Lung", "Cord", "Edge")):
        cs = []
        for _ in range(3 + k):
            # the in-plane axis a: x, or y in the Sagittal plane; Edge's
            # polygons are centred on the face a = 0
            a_max = Y if plane == "Sagittal" else X
            a0 = 0.5 if name == "Edge" else r.uniform(6, a_max - 6)
            if plane == "Axial":
                a, b = star(r, a0, r.uniform(6, Y - 6),
                            int(r.integers(4, 14)), 1.0, 7.0)
                s = int(r.integers(0, Z))
                pix = np.stack([a, b, np.full_like(a, s)], 1)
            elif plane == "Coronal":
                a, b = star(r, a0, r.uniform(2, Z - 2),
                            int(r.integers(4, 14)), 1.0, 4.0)
                s = int(r.integers(0, Y))
                pix = np.stack([a, np.full_like(a, s), b], 1)
            else:
                a, b = star(r, a0, r.uniform(2, Z - 2),
                            int(r.integers(4, 14)), 1.0, 4.0)
                s = int(r.integers(0, X))
                pix = np.stack([np.full_like(a, s), a, b], 1)
            cs.append(np.asarray(ORIGIN) + pix * [SPACING[0], SPACING[1],
                                                  THICK])
        out[name] = cs
    return out


def both_images(tmp_path, plane, seed=0):
    """The same CT in both packages with the same contoured ROIs in
    ``plane``, and a ROI with no contours in each."""
    ct = np.zeros(SHAPE, np.int16)
    write_ct_series(tmp_path / "ct", ct, origin=ORIGIN, spacing=SPACING,
                    thickness=THICK)
    jmia.read_dicoms(folder_path=str(tmp_path))
    tmia.read_dicoms(folder_path=str(tmp_path))
    t, j = TData.image["CT 01"], JData.image["CT 01"]
    contours = contours_mm(plane, seed)
    interop.rois_from_numpy(t, contours, plane=plane)
    for name, cs in contours.items():
        j.rois[name] = JRoi(j, position=cs, name=name, plane=plane)
    t.create_roi(name="Stub")
    j.create_roi(name="Stub")
    return t, j, list(contours)


def host_path(image, names):
    """The masks and entries the pooled path made before it kept them on
    the device: ``rasterize_batch``'s whole masks, each scanned by
    ``_roi_mask_cache_put``."""
    plane = image.rois[names[0]].plane
    dims = tuple(int(v) for v in image.dimensions)
    masks = tbatch.rasterize_batch(
        [image.rois[n].contour_pixel for n in names], dims, plane=plane)
    return ({n: masks[i] for i, n in enumerate(names)},
            {n: host_entry(image, n, masks[i]) for i, n in enumerate(names)})


@pytest.mark.parametrize("plane", PLANES)
def test_compute_roi_masks_equals_the_host_path_and_jax(tmp_path, plane):
    t, j, contoured = both_images(tmp_path, plane)
    before = dict(timage.MASKS)
    got = t.compute_roi_masks()
    want, entries = host_path(t, contoured)
    jgot = j.compute_roi_masks()
    assert set(got) == set(jgot) == set(contoured) | {"Stub"}
    for n in contoured:
        assert got[n].dtype == np.uint8 and got[n].shape == SHAPE
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        np.testing.assert_array_equal(got[n], np.asarray(jgot[n]),
                                      err_msg=n)
        assert_same_entry(t._roi_mask_cache[n], entries[n])
        assert got[n].any(), n
    assert not got["Stub"].any()
    face = want["Edge"][:, 0] if plane == "Sagittal" else \
        want["Edge"][:, :, 0]
    assert face.any()                                  # it meets a face
    assert timage.MASKS["device_packs"] - before["device_packs"] == 3
    assert timage.MASKS["full_reads"] - before["full_reads"] == 1  # Stub


@pytest.mark.parametrize("plane", PLANES)
def test_a_sub_list_of_names_equals_the_whole(tmp_path, plane):
    t, j, contoured = both_images(tmp_path, plane, seed=1)
    sub = [contoured[2], contoured[0]]
    got = t.compute_roi_masks(sub)
    assert list(got) == sub
    assert set(t._roi_mask_cache) == set(sub)
    jgot = j.compute_roi_masks(sub)
    want, _ = host_path(t, contoured)
    for n in sub:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        np.testing.assert_array_equal(got[n], np.asarray(jgot[n]))
    whole = t.compute_roi_masks()
    for n in contoured:
        np.testing.assert_array_equal(whole[n], want[n], err_msg=n)


def test_returned_masks_are_separate_writable_arrays(tmp_path):
    t, _, contoured = both_images(tmp_path, "Axial")
    got = t.compute_roi_masks()
    a, b = contoured[0], contoured[1]
    kept = {n: got[n].copy() for n in got}
    assert all(got[n].flags.writeable and got[n].flags.c_contiguous
               for n in got)
    assert not np.shares_memory(got[a], got[b])
    got[a][:] = 1
    np.testing.assert_array_equal(got[b], kept[b])
    np.testing.assert_array_equal(t.rois[a].compute_mask(), kept[a])
    again = t.compute_roi_masks()
    np.testing.assert_array_equal(again[a], kept[a])
    assert not np.shares_memory(again[a], got[a])


def test_no_whole_mask_and_two_copies_a_plane_group(tmp_path, monkeypatch):
    """Contoured ROIs in two planes: nothing but the projections and the
    packed crops comes down, two copies a plane group, and no whole mask
    reaches the host."""
    t, _, contoured = both_images(tmp_path, "Axial")
    coronal = contours_mm("Coronal", 3)
    interop.rois_from_numpy(t, {"C" + n: cs for n, cs in coronal.items()},
                            plane="Coronal")
    del t.rois["Stub"]
    real = torch.Tensor.cpu
    copies = []

    def counted(self, *args, **kwargs):
        copies.append(tuple(self.shape))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    before = dict(timage.MASKS)
    t.compute_roi_masks()
    monkeypatch.setattr(torch.Tensor, "cpu", real)
    Z, Y, X = SHAPE
    assert len(copies) == 4
    assert copies[0] == copies[2] == (3, Z + Y + X)
    assert all(len(c) == 1 for c in copies[1::2])
    assert timage.MASKS["full_reads"] == before["full_reads"]
    assert timage.MASKS["device_packs"] - before["device_packs"] == 6


def test_a_planted_flip_reaches_the_returned_mask(tmp_path, monkeypatch):
    """The benchmark's planted mask fault, one voxel of the first ROI
    flipped in ``rasterize_polygons_grouped``'s output, comes out in the
    mask compute_roi_masks returns and in the cache."""
    t, _, contoured = both_images(tmp_path, "Axial")
    clean, _ = host_path(t, contoured)
    real = traster.rasterize_polygons_grouped

    def flipped(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0, out.shape[1] // 2, 10, 10] ^= 1
        return out

    monkeypatch.setattr(traster, "rasterize_polygons_grouped", flipped)
    got = t.compute_roi_masks()
    first = contoured[0]
    diff = np.argwhere(got[first] != clean[first])
    assert diff.tolist() == [[SHAPE[0] // 2, 10, 10]]
    np.testing.assert_array_equal(t.rois[first].compute_mask(), got[first])
    for n in contoured[1:]:
        np.testing.assert_array_equal(got[n], clean[n])
