"""Roi: contours, masks and meshes for one structure on one image.

Port of medicalimageanalysis_tpu/structure/roi.py. Masks rasterize on the
device through utils/convert/contour -> ops/rasterize and are cached,
bit-packed, on the owning Image. Meshes come from the device's marching
tetrahedra and smoothing (ops/marching_cubes, utils/mesh/surface) into a
host TriMesh; mask -> contour conversion runs the port's border tracer.
A mesh-only ROI's mask is the mesh voxelized on the card by ray parity
(ops/voxelize) and goes into the mask cache like any other.
"""

from __future__ import annotations

import random

import numpy as np

from ..ops import geometry as geo

__all__ = ["random_color", "Roi"]


def random_color(rgb_255=True):
    """Random RGB tuple, 0-255 ints or 0-1 floats
    (reference structure/roi.py:26-59)."""
    if rgb_255:
        return (random.randint(0, 255), random.randint(0, 255),
                random.randint(0, 255))
    return (random.random(), random.random(), random.random())


class Roi(object):
    """Region of Interest: physical contours + pixel contours + mesh."""

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

    def add_mesh(self, mesh):
        self.mesh = mesh
        self.volume = mesh.volume
        self.com = mesh.center
        self.bounds = mesh.bounds

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

    # -- meshing (reference structure/roi.py:209-330) -------------------
    def create_mesh(self, smoothing_iterations=20, smoothing_relaxation=.5,
                    smoothing_distance=1):
        self.add_mesh(self._mesher().compute_mesh(
            smoothing_iterations=smoothing_iterations,
            smoothing_relaxation=smoothing_relaxation,
            smoothing_distance=smoothing_distance))

    def create_discrete_mesh(self):
        self.add_mesh(self._mesher().compute_mesh(discrete=True))

    def create_display_mesh(self, iterations=20, angle=60, passband=0.001):
        from ..utils.mesh.surface import Refinement
        refine = Refinement(self.mesh)
        self.mesh = refine.smooth(iterations=iterations, angle=angle,
                                  passband=passband)

    def create_decimate_mesh(self, percent=None, set_mesh=False):
        if percent is None:
            points = np.round(10 * np.sqrt(self.mesh.number_of_points))
            percent = 1 - (points / self.mesh.number_of_points)
        mesh = self.mesh.decimate(percent)
        if set_mesh:
            self.mesh = mesh
        return mesh

    def create_cluster_mesh(self, points=None, set_mesh=False):
        from ..utils.mesh.surface import Refinement
        refine = Refinement(self.mesh)
        mesh = refine.cluster(points=points)
        if set_mesh:
            self.mesh = mesh
        return mesh

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
        the contours, else from the mesh (:meth:`_mask_from_mesh`), else
        all zeros."""
        if self._has_contours():
            return self._mesher().mask
        if self.mesh is not None:
            return self._mask_from_mesh()
        return np.zeros(tuple(int(v) for v in self.image.dimensions),
                        dtype=np.uint8)

    def _mask_from_mesh(self):
        """Voxelize ``self.mesh`` on the image grid by exact ray-casting
        parity over the faces (utils/convert/voxelize, on the image's
        device): plane slicing and rasterization would shatter a
        non-welded surface, where face-level parity is immune."""
        from ..utils.convert.voxelize import voxelize_mesh

        img = self.image
        p2pix = geo.position_to_pixel_matrix(img.matrix, img.spacing,
                                             img.origin)
        pts = np.asarray(self.mesh.points, np.float64)
        pts_pixel = pts @ p2pix[:3, :3].T + p2pix[:3, 3]
        return voxelize_mesh(pts_pixel, self.mesh.faces, img.dimensions,
                             plane=self.plane,
                             device=img._compute_device())

    def create_mask_volume(self):
        """Mask + grid geometry bundle (replaces create_sitk_mask,
        reference structure/roi.py:488-509, without SimpleITK)."""
        return {"array": self.compute_mask(),
                "spacing": np.asarray(self.image.spacing, dtype=float),
                "origin": np.asarray(self.image.origin, dtype=float),
                "matrix": np.asarray(self.image.matrix, dtype=float)}

    create_sitk_mask = create_mask_volume

    def compute_mesh_slice(self, location=None, slice_plane=None, offset=0,
                           return_pixel=False):
        """Mesh-plane cross-section -> polylines (-> 2D pixel paths)
        (reference structure/roi.py:406-486)."""
        matrix = np.linalg.inv(self.image.display.matrix)
        if slice_plane == "Axial":
            normal = matrix[:3, 2]
        elif slice_plane == "Coronal":
            normal = matrix[:3, 1]
        else:
            normal = matrix[:3, 0]

        if self.mesh is None:
            return [], []
        polylines = self.mesh.slice_plane(normal=normal, origin=location)

        if not return_pixel:
            return polylines, None
        if not polylines:
            return [], None
        pixels = self.convert_position_to_pixel(position=polylines)
        pixel_corrected = []
        for pixel in pixels:
            if slice_plane == "Axial":
                pixel_corrected.append(pixel[:, :2] + offset)
            elif slice_plane == "Coronal":
                pixel_corrected.append(
                    np.column_stack((pixel[:, 0] + offset,
                                     pixel[:, 2] + offset)))
            else:
                pixel_corrected.append(pixel[:, 1:] + offset)
        return pixel_corrected, None

    def interpolate_slices(self):
        """Fill uncontoured slices between contoured ones by shape-based
        signed-distance interpolation (utils/roi/interpolate), then
        rebuild contours and meshes from the filled mask."""
        from ..utils.roi.interpolate import interpolate_mask_slices

        if self.contour_position is None:
            return
        axis = {"Axial": 0, "Coronal": 1}.get(self.plane, 2)
        self.convert_mask(interpolate_mask_slices(self.compute_mask(),
                                                  axis=axis))

    def convert_mask(self, mask):
        """Mask -> contours -> meshes (reference structure/roi.py:511-535)."""
        from ..utils.convert.contour import MaskToContour
        mask_to_contour = MaskToContour(
            mask, spacing=self.image.spacing, origin=self.image.origin,
            matrix=self.image.matrix, plane=self.plane)
        self.contour_pixel, self.contour_position = \
            mask_to_contour.create_contours()

        if len(self.contour_pixel) > 0:
            self.create_discrete_mesh()
            self.create_display_mesh()
        else:
            self.mesh = None
            self.volume = None
            self.com = None
            self.bounds = None

    def update_pixel(self, pixel, plane="Axial"):
        self.plane = plane
        self.contour_pixel = pixel
        if pixel is not None and len(pixel) > 0:
            self.contour_position = self.convert_pixel_to_position(pixel=pixel)
            self.create_discrete_mesh()
            self.create_display_mesh()
        else:
            self.contour_pixel = None
            self.contour_position = None
            self.mesh = None

    def update_mesh(self, mesh):
        self.mesh = mesh
        self.volume = mesh.volume
        self.com = mesh.center
        self.bounds = mesh.bounds
        self.contour_pixel = None
        self.contour_position = None
