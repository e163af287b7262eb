"""Contour -> mask conversion.

Port of medicalimageanalysis_tpu/utils/convert/contour.py (``_plane_split``,
``_rasterize_plane``, ``ContourToMask``, the mask half of
``ContourToDiscreteMesh``). Contours rasterize through the port's
ops/rasterize on the device, always: the cv2 host backend and the
tunnel-rate choice between backends are not carried over (the card's
machine has no cv2). Meshes (marching cubes) and ``MaskToContour`` (a
contour tracer without cv2) raise naming their ROADMAP items.
"""

from __future__ import annotations

import numpy as np

from ...ops import geometry as geo

__all__ = ["ContourToDiscreteMesh", "ContourToMask", "MaskToContour"]


def _plane_split(contour_pixel, plane):
    """Split (N, 3) pixel contours into 2D polygons + slice indices per
    the reference's per-plane conventions
    (reference utils/convert/contour.py:82-116)."""
    polys = []
    slices = []
    for c in contour_pixel:
        c = np.asarray(c)
        if plane == "Axial":
            poly = c[:, 0:2]
            slices.append(int(np.round(c[0, 2])))
        elif plane == "Coronal":
            poly = np.stack((c[:, 0], c[:, 2]), axis=1)
            slices.append(int(np.round(c[0, 1])))
        else:
            poly = c[:, 1:]
            slices.append(int(np.round(c[0, 0])))
        polys.append(poly)
    return polys, slices


def plane_canvas(dimensions, plane):
    """(S, H, W, axis): slice count, canvas rows and columns, and the
    array axis the slices stack along, for a (d0, d1, d2) grid."""
    d0, d1, d2 = (int(d) for d in dimensions[:3])
    if plane == "Axial":
        return d0, d1, d2, 0
    if plane == "Coronal":
        return d1, d0, d2, 1
    return d2, d0, d1, 2


def _rasterize_plane(contour_pixel, dimensions, plane, device=None):
    """Rasterize contours into a (d0, d1, d2) uint8 numpy mask with XOR
    semantics, on ``device`` (default: ``default_device()``)."""
    from ...ops.rasterize import rasterize_polygons

    polys, slices = _plane_split(contour_pixel, plane)
    S, H, W, axis = plane_canvas(dimensions, plane)
    out = rasterize_polygons(polys, slices, S, H, W, device=device)
    if axis:
        out = np.moveaxis(out, 0, axis)
    return (out > 0).astype(np.uint8)


class ContourToDiscreteMesh(object):
    """Contours -> mask (reference utils/convert/contour.py:24-162). The
    surface mesh waits for the mesh slice."""

    def __init__(self, contour_position=None, contour_pixel=None,
                 spacing=None, origin=None, dimensions=None, matrix=None,
                 plane="Axial", mask=None, device=None):
        self.contour_position = contour_position
        self.contour_pixel = contour_pixel
        self.spacing = spacing
        self.origin = origin
        self.dimensions = dimensions
        self.plane = plane
        self.device = device

        self.mask = mask

        self.matrix = np.identity(3) if matrix is None else matrix

        if self.contour_pixel is None and self.mask is None:
            self.convert_to_pixel_spacing()

        if self.mask is None:
            self.compute_mask()

    def convert_to_pixel_spacing(self):
        m = geo.position_to_pixel_matrix(self.matrix, self.spacing,
                                         self.origin)
        self.contour_pixel = [
            geo.apply_homogeneous(np.asarray(pos), m)
            for pos in self.contour_position]

    def compute_mask(self):
        self.mask = _rasterize_plane(self.contour_pixel, self.dimensions,
                                     self.plane, device=self.device)

    def compute_mesh(self, *args, **kwargs):
        raise NotImplementedError(
            "ContourToDiscreteMesh.compute_mesh is not ported yet: "
            "marching cubes and surface smoothing — ROADMAP.md queue 1, "
            "item 9 (mesh)")


class ContourToMask(object):
    """Physical contours -> mask, converting through the image direction
    matrix (reference utils/convert/contour.py:165-252)."""

    def __init__(self, contour_position=None, contour_pixel=None,
                 spacing=None, origin=None, dimensions=None, matrix=None,
                 plane="Axial", device=None):
        self.contour_position = contour_position
        self.contour_pixel = contour_pixel
        self.spacing = spacing
        self.origin = origin
        self.dimensions = dimensions
        self.matrix = matrix
        self.plane = plane
        self.device = device

        self.mask = None

    def create_mask(self):
        if self.contour_pixel is None:
            self.convert_to_pixel_spacing()
        self.compute_mask()
        return self.mask

    def convert_to_pixel_spacing(self):
        m = geo.position_to_pixel_matrix(self.matrix[0:3, 0:3]
                                         if np.asarray(self.matrix).shape
                                         == (4, 4) else self.matrix,
                                         self.spacing, self.origin)
        self.contour_pixel = [
            geo.apply_homogeneous(np.asarray(pos), m)
            for pos in self.contour_position]

    def compute_mask(self):
        self.mask = _rasterize_plane(self.contour_pixel, self.dimensions,
                                     self.plane, device=self.device)


class MaskToContour(object):
    """Mask -> per-slice contours. The JAX package traces boundaries with
    cv2.findContours, which the card's machine does not have."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MaskToContour is not ported yet: it needs a contour tracer "
            "without cv2 — ROADMAP.md queue 1, item 6 (structure layer)")
