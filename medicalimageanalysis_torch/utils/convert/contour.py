"""Contour <-> mask <-> mesh conversion.

Port of medicalimageanalysis_tpu/utils/convert/contour.py (``_plane_split``,
``_rasterize_plane``, ``ContourToMask``, ``ContourToDiscreteMesh``,
``MaskToContour`` with ``_trace_with_holes``). Contours rasterize through
the port's ops/rasterize on the device, always: the cv2 host backend and
the tunnel-rate choice between backends are not carried over (the card's
machine has no cv2). Meshes come from ops/marching_cubes and
utils/mesh/surface on the device. Boundaries are traced on the host by
the port's own C++ border follower (native.trace_external), which gives
``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``'s contours
point for point. ``ModelToMask`` waits for the mesh slice.
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
    """Contours -> mask -> surface mesh
    (reference utils/convert/contour.py:24-162)."""

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

    def compute_mesh(self, discrete=False, smoothing_iterations=20,
                     smoothing_relaxation=.5, smoothing_distance=1):
        """Mask -> physical-space mesh on ``device``. discrete=True
        returns the raw (blocky) isosurface; otherwise constrained
        smoothing follows."""
        from ...ops.marching_cubes import mask_to_mesh
        from ..mesh.surface import constrained_smooth

        mesh = mask_to_mesh(self.mask, self.spacing, self.origin,
                            self.matrix, device=self.device)
        if not discrete and mesh.number_of_points > 0:
            mesh = constrained_smooth(
                mesh, iterations=smoothing_iterations,
                relaxation=smoothing_relaxation,
                max_distance=smoothing_distance, device=self.device)
        return mesh


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


def _trace_with_holes(slice_u8):
    """All boundary contours of a 2D mask, nesting-exact for the XOR
    rasterizer: external contours of the hole-filled mask, then the same
    for the hole region, so hole boundaries are traced on hole pixels
    (a hole traced on its foreground pixels and XOR-rasterized would
    remove a one-pixel ring of foreground each round trip). Islands
    inside holes come from the recursion."""
    from scipy import ndimage

    from ...native import trace_external

    inside = slice_u8 > 0
    filled = ndimage.binary_fill_holes(inside)
    out = list(trace_external(filled))
    inner = filled & ~inside
    if inner.any():
        out += _trace_with_holes(inner)
    return out


class MaskToContour(object):
    """Mask -> per-slice pixel contours -> physical contours
    (reference utils/convert/contour.py:255-328), holes traced too
    (``_trace_with_holes``): identical to the reference for hole-free
    masks, and annular masks survive the round trip through the XOR
    rasterizer."""

    def __init__(self, mask=None, spacing=None, origin=None, matrix=None,
                 plane="axial"):
        self.mask = mask
        self.spacing = spacing
        self.origin = origin
        self.matrix = matrix
        self.plane = plane

        self.contour_position = []
        self.contour_pixel = []

    def create_contours(self):
        self.compute_pixel()
        if self.spacing is not None and self.origin is not None \
                and self.matrix is not None:
            self.compute_position()
        return self.contour_pixel, self.contour_position

    def compute_pixel(self):
        axis = {"axial": 0, "coronal": 1}.get(self.plane.lower(), 2)
        stack = np.moveaxis(np.asarray(self.mask) > 0, axis, 0)
        for i in np.nonzero(stack.reshape(stack.shape[0], -1).any(1))[0]:
            for contour in _trace_with_holes(stack[i]):
                if len(contour) > 2:
                    n = contour.shape[0]
                    xyz = np.zeros((n, 3), dtype=np.int32)
                    if axis == 0:
                        xyz[:, 0] = contour[:, 0]
                        xyz[:, 1] = contour[:, 1]
                        xyz[:, 2] = i
                    elif axis == 1:
                        xyz[:, 0] = contour[:, 0]
                        xyz[:, 1] = i
                        xyz[:, 2] = contour[:, 1]
                    else:
                        xyz[:, 0] = i
                        xyz[:, 1] = contour[:, 0]
                        xyz[:, 2] = contour[:, 1]
                    self.contour_pixel.append(xyz)

    def compute_position(self):
        m = geo.pixel_to_position_matrix(self.matrix, self.spacing,
                                         self.origin)
        for pix in self.contour_pixel:
            self.contour_position.append(
                geo.apply_homogeneous(np.asarray(pix, dtype=np.float64), m))
