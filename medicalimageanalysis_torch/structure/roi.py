"""Roi: contours and masks for one structure on one image.

Port of medicalimageanalysis_tpu/structure/roi.py. Masks rasterize on the
device through utils/convert/contour -> ops/rasterize and are cached,
bit-packed, on the owning Image. Meshes, mesh-only masks, slice
interpolation and mask -> contour conversion raise naming their
ROADMAP.md items.
"""

from __future__ import annotations

import random
from functools import partial

import numpy as np

from ..ops import geometry as geo
from .common import waits

__all__ = ["random_color", "Roi"]


def random_color(rgb_255=True):
    """Random RGB tuple, 0-255 ints or 0-1 floats
    (reference structure/roi.py:26-59)."""
    if rgb_255:
        return (random.randint(0, 255), random.randint(0, 255),
                random.randint(0, 255))
    return (random.random(), random.random(), random.random())


_waits = partial(waits, "Roi")


class Roi(object):
    """Region of Interest: physical contours + pixel contours."""

    def __setattr__(self, name, value):
        # Mask-shaping state: any rebind invalidates this ROI's entry in
        # the owning Image's pooled-mask cache. In-place mutation of a
        # bound contour list is not tracked; rebind the attribute.
        if name in ("contour_pixel", "mesh", "plane"):
            object.__setattr__(self, "_mask_rev",
                               getattr(self, "_mask_rev", 0) + 1)
        object.__setattr__(self, name, value)

    def __init__(self, image, position=None, name=None, color=None,
                 visible=False, filepaths=None, plane=None):
        self.image = image

        self.name = name
        self.visible = visible
        self.color = color
        self.filepaths = filepaths

        self.plane = plane if plane is not None else self.image.plane

        if position is not None:
            self.contour_position = position
            self.contour_pixel = self.convert_position_to_pixel(position)
        else:
            self.contour_position = None
            self.contour_pixel = None

        if color is None:
            self.color = random_color()

        self.mesh = None
        self.volume = None
        self.com = None
        self.bounds = None

        self.fixed_name = False
        self.visual = {"2d": None, "3d": None, "opacity": None,
                       "multicolor": None}
        self.misc = {}

    def clear(self):
        self.contour_position = None
        self.contour_pixel = None
        self.mesh = None
        self.volume = None
        self.com = None
        self.bounds = None
        self.fixed_name = False
        self.visual = {"2d": None, "3d": None, "opacity": None,
                       "multicolor": None}
        self.misc = {}

    # -- coordinate conversion (reference structure/roi.py:162-207) -----
    def convert_position_to_pixel(self, position=None):
        """Physical mm -> pixel; output contours are closed by repeating
        the first point (reference structure/roi.py:178-184)."""
        m = self.image.display.compute_matrix_position_to_pixel()
        pixel = []
        for pos in position:
            pos = np.asarray(pos, dtype=np.float64)
            p = geo.apply_homogeneous(pos, m)
            pixel.append(np.vstack((p, p[0, :])))
        return pixel

    def convert_pixel_to_position(self, pixel=None):
        m = self.image.display.compute_matrix_pixel_to_position()
        position = []
        for pix in pixel:
            position.append(geo.apply_homogeneous(
                np.asarray(pix, dtype=np.float64), m))
        return position

    def _mesher(self):
        from ..utils.convert.contour import ContourToDiscreteMesh
        return ContourToDiscreteMesh(
            contour_pixel=self.contour_pixel, spacing=self.image.spacing,
            origin=self.image.origin, dimensions=self.image.dimensions,
            matrix=self.image.matrix, plane=self.plane)

    # -- mask / contour ops (reference structure/roi.py:332-584) ---------
    def compute_contour(self, slice_location, offset=0):
        """Closed in-plane loops at one slice index
        (reference structure/roi.py:332-382)."""
        contour_list = []
        if self.contour_pixel is None:
            return contour_list

        if self.plane == "Axial":
            axis, cols = 2, (0, 1)
        elif self.plane == "Coronal":
            axis, cols = 1, (0, 2)
        else:
            axis, cols = 0, (1, 2)

        locs = [np.round(c[0, axis]).astype(int) for c in self.contour_pixel]
        keep_idx = np.argwhere(np.asarray(locs) == slice_location)
        for idx in keep_idx:
            c = self.contour_pixel[idx[0]]
            two_d = np.column_stack((c[:, cols[0]] + offset,
                                     c[:, cols[1]] + offset))
            closed = np.vstack((two_d, two_d[0:1, :]))
            contour_list.append(closed)
        return contour_list

    def compute_mask(self):
        """Rasterized (Z, Y, X) uint8 mask on the image grid.

        Served from the owning Image's mask cache (bbox-cropped,
        bit-packed; invalidated whenever this ROI's contours or plane
        rebind). On a cache miss, if the image holds other uncached
        contoured ROIs, the whole group rasterizes in one pooled device
        pass (``Image.compute_roi_masks``). A ROI that is not the one
        registered under its name on the image is rasterized but not
        cached, so the pooled entry of the registered ROI survives."""
        img = self.image
        cached = img._roi_mask_cache_get(self.name, self)
        if cached is not None:
            return cached
        registered = img.rois.get(self.name) is self
        if self._has_contours() \
                and not getattr(img, "_pooled_raster_active", False):
            others = [
                n for n, r in img.rois.items()
                if r is not self and r._has_contours()
                and img._roi_mask_cache_get(n, r, reconstruct=False)
                is None]
            if others:
                img.compute_roi_masks(
                    roi_names=others + ([self.name] if registered else []))
                cached = img._roi_mask_cache_get(self.name, self)
                if cached is not None:
                    return cached
        mask = self._compute_mask_impl()
        if registered:
            img._roi_mask_cache_put(self.name, self, mask)
        return mask

    def _has_contours(self):
        return self.contour_pixel is not None and len(self.contour_pixel) > 0

    def _compute_mask_impl(self):
        """The raw single-ROI rasterization, no cache interaction: from
        the contours, or all zeros without any. A mesh-only ROI (no
        contours) raises: voxelizing a mesh waits for the mesh slice."""
        if self._has_contours():
            return self._mesher().mask
        if self.mesh is not None:
            raise NotImplementedError(
                "Roi.compute_mask of a mesh-only ROI is not ported yet: "
                "mesh voxelization — ROADMAP.md queue 1, item 9 (mesh)")
        return np.zeros(tuple(int(v) for v in self.image.dimensions),
                        dtype=np.uint8)

    def create_mask_volume(self):
        """Mask + grid geometry bundle (replaces create_sitk_mask,
        reference structure/roi.py:488-509, without SimpleITK)."""
        return {"array": self.compute_mask(),
                "spacing": np.asarray(self.image.spacing, dtype=float),
                "origin": np.asarray(self.image.origin, dtype=float),
                "matrix": np.asarray(self.image.matrix, dtype=float)}

    create_sitk_mask = create_mask_volume

    add_mesh = _waits("add_mesh", "item 9, mesh")
    create_mesh = _waits("create_mesh", "item 9, mesh")
    create_discrete_mesh = _waits("create_discrete_mesh", "item 9, mesh")
    create_display_mesh = _waits("create_display_mesh", "item 9, mesh")
    create_decimate_mesh = _waits("create_decimate_mesh", "item 9, mesh")
    create_cluster_mesh = _waits("create_cluster_mesh", "item 9, mesh")
    compute_mesh_slice = _waits("compute_mesh_slice", "item 9, mesh")
    update_mesh = _waits("update_mesh", "item 9, mesh")
    update_pixel = _waits("update_pixel", "item 9, mesh")
    interpolate_slices = _waits("interpolate_slices",
                                "item 10, utils/roi interpolation")
    convert_mask = _waits("convert_mask",
                          "item 6, MaskToContour without cv2")
