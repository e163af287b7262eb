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
point for point. ``ModelToMask`` cuts meshes plane by plane on the host
(``TriMesh.slice_plane`` over z-span buckets of the faces) and fills the
cuts with the same rasterizer in one pooled pass.
"""

from __future__ import annotations

import numpy as np

from ...ops import geometry as geo

__all__ = ["ContourToDiscreteMesh", "ContourToMask", "MaskToContour",
           "ModelToMask"]


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


class ModelToMask(object):
    """Mesh(es) -> fake image volume (reference
    utils/convert/contour.py:331-461). Used by the 3MF pipeline.

    The mask is all zeros by default, as in the reference; with
    ``empty_array=False`` each model's cut on each slice (its loops
    joined into one polygon, as the reference hands cv2.fillPoly) is
    filled by the port's rasterizer on ``device`` (default: the card),
    one pooled pass for all models and slices, and the models' fills add
    up."""

    def __init__(self, models, origin=None, spacing=None, dims=None,
                 slice_locations=None, matrix=None, empty_array=True,
                 convert=True, device=None):
        self.models = models
        self.empty_array = empty_array
        self.device = device

        self.spacing = spacing
        self.origin = origin
        self.dims = dims
        self.slice_locations = slice_locations

        self.matrix = np.identity(4) if matrix is None else matrix

        self.bounds = None
        self.contours = []
        self.mask = None

        if convert:
            self.compute_bounds()
            self.compute_contours()
            self.compute_mask()

    def compute_bounds(self):
        """Joint bbox + 5-voxel pad; auto spacing [1,1,3] or [1,1,5] by
        extent (reference utils/convert/contour.py:385-411)."""
        model_bounds = [model.GetBounds() for model in self.models]
        model_min = np.min(model_bounds, axis=0)
        model_max = np.max(model_bounds, axis=0)
        mm = [model_min[0], model_max[1], model_min[2], model_max[3],
              model_min[4], model_max[5]]

        if mm[1] - mm[0] < 512 and mm[3] - mm[2] < 512:
            if mm[5] - mm[4] < 450:
                self.spacing = [1, 1, 3]
            elif mm[5] - mm[4] < 750:
                self.spacing = [1, 1, 5]

        if self.spacing is not None:
            self.bounds = [
                int(mm[0] - 5 * self.spacing[0]),
                int(mm[1] + 5 * self.spacing[0]),
                int(mm[2] - 5 * self.spacing[1]),
                int(mm[3] + 5 * self.spacing[1]),
                int(mm[4] - 5 * self.spacing[2]),
                int(mm[5] + 5 * self.spacing[2])]
            self.origin = [self.bounds[0], self.bounds[2], self.bounds[4]]
            self.slice_locations = list(
                range(self.bounds[4], self.bounds[5], self.spacing[2]))
            self.dims = [len(self.slice_locations),
                         self.bounds[3] - self.bounds[2] + 1,
                         self.bounds[1] - self.bounds[0] + 1]

    def compute_contours(self):
        """Per-z mesh plane cuts -> 2D pixel polygons
        (reference utils/convert/contour.py:413-433). Faces are bucketed
        by z-span once, so each plane cut touches only its crossing
        candidates; slice locations in any order (descending feet-first
        positions, duplicates) bucket against a sorted copy."""
        slocs = np.asarray(self.slice_locations, np.float64)
        n_s = slocs.shape[0]
        need_sort = n_s > 1 and not bool(np.all(np.diff(slocs) >= 0))
        if need_sort:
            sort_idx = np.argsort(slocs, kind="stable")
            slocs_sorted = slocs[sort_idx]
            slot_of = np.empty(n_s, np.int64)
            slot_of[sort_idx] = np.arange(n_s)
        else:
            slocs_sorted = slocs
            slot_of = None
        for model in self.models:
            com = model.center
            org_bounds = model.GetBounds()
            # plane s crosses a face iff fzmin <= s < fzmax (slice_plane's
            # d > 0 predicate)
            fz = model.points[:, 2][model.faces]
            lo = np.searchsorted(slocs_sorted, fz.min(axis=1), "left")
            hi = np.searchsorted(slocs_sorted, fz.max(axis=1), "left")
            counts = hi - lo
            total = int(counts.sum())
            fidx = np.repeat(np.arange(counts.shape[0]), counts)
            cum = np.cumsum(counts)
            planes = np.repeat(lo, counts) + (
                np.arange(total) - np.repeat(cum - counts, counts))
            order = np.argsort(planes, kind="stable")
            fidx = fidx[order]
            bounds_at = np.searchsorted(planes[order], np.arange(n_s + 1))
            model_contours = []
            for jj, s in enumerate(self.slice_locations):
                loops = []
                if org_bounds[4] < s < org_bounds[5]:
                    slot = int(slot_of[jj]) if need_sort else jj
                    cands = fidx[bounds_at[slot]:bounds_at[slot + 1]]
                    loops = model.slice_plane(
                        normal=[0, 0, 1], origin=[com[0], com[1], s],
                        candidate_faces=cands)
                if loops:
                    pts = np.concatenate(loops, axis=0)
                    model_contours.append(
                        (pts[:, 0:2] - (self.bounds[0], self.bounds[2]))
                        / self.spacing[0:2])
                else:
                    model_contours.append([])
            self.contours.append(model_contours)

    def compute_mask(self):
        """(dims) int8 mask: zeros with ``empty_array`` (the reference
        default), else the per-model, per-slice fills added
        (reference utils/convert/contour.py:435-446)."""
        from ...ops.rasterize import rasterize_polygons_grouped

        S, H, W = (int(d) for d in self.dims[:3])
        self.mask = np.zeros((S, H, W), np.int8)
        if self.empty_array:
            return
        grouped = []
        for model_contours in self.contours:
            keep = [jj for jj in range(len(self.slice_locations))
                    if len(model_contours[jj]) > 0]
            grouped.append(([np.asarray(model_contours[jj]) for jj in keep],
                            keep))
        fills = rasterize_polygons_grouped(grouped, S, H, W,
                                           device=self.device)
        self.mask = fills.sum(axis=0, dtype=np.int64).astype(np.int8)

    def save_image(self, export_path):
        """Write the mask as an MHD volume (reference wrote via sitk)."""
        from ...read.mhd import write_mhd_volume
        write_mhd_volume(export_path, self.mask, spacing=self.spacing,
                         origin=[self.bounds[0], self.bounds[2],
                                 self.bounds[4]])
