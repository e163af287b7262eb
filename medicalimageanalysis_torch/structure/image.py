"""Image domain object + Display view state.

Port of medicalimageanalysis_tpu/structure/image.py: ``Image`` with its
ROI/POI containers, RTSTRUCT intake, the token-keyed bit-packed ROI mask
cache and the pooled ``compute_roi_masks`` (always one device pass per
slicing plane), ``compute_roi_statistics``, ``create_volume``,
``load_array`` (the pixels of a series read with ``only_tags=True``), and
the ``Display`` matrices, slice location, ``compute_slice`` and the
off-axis reslice (``compute_offaxis_array``, the warp kernel's ``affine``
mode on the card). The metadata, geometry and view mixins are in
structure/common.py. The array stays a numpy array, like the JAX
package's. The external contour, margin and boolean ROIs are here too,
and the image analysis: ``resample_to``, ``create_rotated_volume`` and
``compute_projection`` (the ``affine`` mode), ``compute_suv`` and
``compute_mtv_tlg``, ``correct_bias`` (ops/n4) and ``compute_radiomics``
(ops/radiomics), on the image's device. The IO slice: ``input_seg`` (a
SEG's masks into the ROIs and the mask cache) and ``input_mhd``; the
writers ``create_rtstruct``, ``create_seg``, ``create_nifti`` and
``export_dicom``; ``save_image`` / ``load_image`` with the ROI and POI
folders.
"""

from __future__ import annotations

import copy
import itertools
import json
import os

import numpy as np

from ..config import config
from ..data import Data
from ..dicom import generate_uid
from ..ops import geometry as geo
from ..telemetry import trace
from .common import (GeometryQueriesMixin, MetadataMixin, ViewOpsMixin,
                     host_array)
from .poi import Poi
from .roi import Roi

__all__ = ["Display", "Image"]

# Process-global monotonic ids for the ROI mask cache — never reused,
# unlike id(), which CPython recycles after a Roi is freed.
_ROI_CACHE_TOKENS = itertools.count(1)


class Display(object):
    """Slice viewing state + coordinate spaces
    (reference structure/image.py:39-306)."""

    def __init__(self, image):
        self.image = image

        self.matrix = copy.deepcopy(self.image.matrix)
        self.spacing = copy.deepcopy(self.image.spacing)
        self.origin = copy.deepcopy(self.image.origin)

        self.slice_location = self.image.compute_center(position=False,
                                                        zyx=True)
        self.scroll_max = [self.image.dimensions[0] - 1,
                           self.image.dimensions[1] - 1,
                           self.image.dimensions[2] - 1]
        self.secondary_array = None
        self.misc = {}

    def compute_matrix_pixel_to_position(self):
        return geo.pixel_to_position_matrix(self.matrix, self.spacing,
                                            self.origin)

    def compute_matrix_position_to_pixel(self):
        return geo.position_to_pixel_matrix(self.matrix, self.spacing,
                                            self.origin)

    def compute_array(self, slice_plane):
        """2D slice at the current slice_location on a standard plane."""
        source = self.image.array if self.secondary_array is None \
            else self.secondary_array
        if slice_plane == "Axial":
            array = source[self.slice_location[0], :, :]
        elif slice_plane == "Coronal":
            array = source[:, self.slice_location[1], :]
        else:
            array = source[:, :, self.slice_location[2]]
        return np.asarray(array).astype(np.float32)

    def compute_index_positions(self, xyz):
        m = self.compute_matrix_pixel_to_position()
        return geo.apply_homogeneous([xyz[0], xyz[1], xyz[2]], m)

    def compute_offaxis_array(self):
        """Off-axis reslice through the current display matrix
        (reference structure/image.py:160-215; the device warp instead of
        vtkImageReslice). The resliced volume becomes ``secondary_array``,
        which ``compute_array`` and ``compute_slice`` then read."""
        from ..ops.resample import reslice_rotation

        loc = np.flip(self.slice_location)
        base_position_matrix = self.compute_matrix_pixel_to_position()
        slice_position = geo.apply_homogeneous(
            [loc[0], loc[1], loc[2]], base_position_matrix)

        resliced, new_origin = reslice_rotation(
            self.image.array, self.image.matrix, self.image.spacing,
            self.image.origin, self.matrix,
            background=config.background_fill)
        self.origin = np.asarray(new_origin)

        dimensions = (resliced.shape[2], resliced.shape[1],
                      resliced.shape[0])
        position_to_pixel_matrix = self.compute_matrix_position_to_pixel()
        location = geo.apply_homogeneous(slice_position,
                                         position_to_pixel_matrix)
        self.slice_location = list(
            np.flip(np.round(location)).astype(np.int32))
        self.scroll_max = [dimensions[2] - 1, dimensions[1] - 1,
                           dimensions[0] - 1]
        for i in range(3):
            if self.slice_location[i] > dimensions[2 - i] - 1:
                self.slice_location[i] = dimensions[2 - i] - 1
            if self.slice_location[i] < 0:
                self.slice_location[i] = 0

        self.secondary_array = resliced

    def compute_scroll_max(self):
        if self.secondary_array is not None:
            self.scroll_max = [self.secondary_array.shape[0] - 1,
                               self.secondary_array.shape[1] - 1,
                               self.secondary_array.shape[2] - 1]
        else:
            self.scroll_max = [self.image.dimensions[0] - 1,
                               self.image.dimensions[1] - 1,
                               self.image.dimensions[2] - 1]

    def compute_slice(self, slice_plane):
        """2D slice + its physical placement (replaces compute_vtk_slice,
        reference structure/image.py:234-284, minus the VTK container)."""
        source = self.image.array if self.secondary_array is None \
            else self.secondary_array
        if slice_plane == "Axial":
            location = [0, 0, self.slice_location[0]]
            array_slice = source[self.slice_location[0], :, :]
        elif slice_plane == "Coronal":
            location = [0, self.slice_location[1], 0]
            array_slice = source[:, self.slice_location[1], :]
        else:
            location = [self.slice_location[2], 0, 0]
            array_slice = source[:, :, self.slice_location[2]]
        m = self.compute_matrix_pixel_to_position()
        origin = geo.apply_homogeneous(location, m)
        return {"array": np.asarray(array_slice), "origin": origin,
                "spacing": self.spacing, "matrix": self.matrix}

    compute_vtk_slice = compute_slice

    def update_slice_location(self, scroll, slice_plane):
        if slice_plane == "Axial":
            self.slice_location[0] = scroll
        elif slice_plane == "Coronal":
            self.slice_location[1] = scroll
        else:
            self.slice_location[2] = scroll


class Image(MetadataMixin, GeometryQueriesMixin, ViewOpsMixin):
    """Volume + identity metadata + geometry + ROI/POI containers.

    ``image`` is a builder (read/volume3d.Read3D, or the namespace
    interop.image_from_arrays makes) carrying image_set, array,
    image_name, modality, filepaths, sops, plane, spacing, dimensions,
    orientation, origin, image_matrix, unverified, skipped_slice, rgb,
    and optionally the ``device`` it was assembled on.
    """

    def __init__(self, image):
        self.rois = {}
        self.pois = {}

        self.tags = image.image_set
        self.array = image.array

        self.image_name = image.image_name
        self.modality = image.modality

        self.patient_name = self.get_patient_name()
        self.mrn = self.get_mrn()
        self.birthdate = self.get_birthdate()
        self.date = self.get_date()
        self.time = self.get_time()
        self.local_uid = generate_uid()
        self.series_uid = self.get_series_uid()
        self.acq_number = self.get_acq_number()
        self.frame_ref = self.get_frame_ref()
        self.window = self.get_window()

        self.filepaths = image.filepaths
        self.sops = image.sops
        self.device = getattr(image, "device", None)

        self.plane = image.plane
        self.spacing = image.spacing
        self.dimensions = image.dimensions
        self.orientation = image.orientation
        self.origin = image.origin
        self.matrix = image.image_matrix

        self.unverified = image.unverified
        self.skipped_slice = image.skipped_slice
        self.rgb = image.rgb

        self.camera_position = None

        self.visual = {"colormap": "gray", "bounds": None}
        self.misc = {}

        self.display = Display(self)

    # -- intake --------------------------------------------------------
    def input_rtstruct(self, rtstruct):
        """Populate ROIs/POIs from a parsed RTSTRUCT (reference
        structure/image.py:389-413)."""
        for ii, roi_name in enumerate(rtstruct.roi_names):
            if roi_name not in self.rois \
                    or self.rois[roi_name].contour_position is None:
                self.rois[roi_name] = Roi(
                    self, position=rtstruct.contours[ii], name=roi_name,
                    color=rtstruct.roi_colors[ii], visible=False,
                    filepaths=rtstruct.filepaths)

        for ii, poi_name in enumerate(rtstruct.poi_names):
            if poi_name not in self.pois \
                    or self.pois[poi_name].point_position is None:
                self.pois[poi_name] = Poi(
                    self, position=rtstruct.points[ii], name=poi_name,
                    color=rtstruct.poi_colors[ii], visible=False,
                    filepaths=rtstruct.filepaths)

        Data.match_rois()
        Data.match_pois()

    def add_roi(self, roi_name=None, color=None, visible=False, path=None,
                contour=None, plane="Axial"):
        self.rois[roi_name] = Roi(self, position=contour, name=roi_name,
                                  color=color, visible=visible,
                                  filepaths=path, plane=plane)
        Data.match_rois()

    def add_poi(self, poi_name=None, color=None, visible=False, path=None,
                point=None):
        self.pois[poi_name] = Poi(self, position=point, name=poi_name,
                                  color=color, visible=visible,
                                  filepaths=path)
        Data.match_pois()

    def create_roi(self, name=None, color=None, visible=False, filepath=None):
        self.rois[name] = Roi(self, name=name, color=color, visible=visible,
                              filepaths=filepath)
        Data.match_rois()

    # -- grid bundle (replaces create_sitk_image, image.py:906-930) -----
    def create_volume(self, empty=False):
        """Array + geometry bundle (the SimpleITK-image equivalent)."""
        arr = np.zeros([int(d) for d in self.dimensions][::-1],
                       dtype=np.uint8) if empty else np.asarray(self.array)
        return {"array": arr,
                "origin": np.asarray(self.origin, dtype=float),
                "spacing": np.asarray(self.spacing, dtype=float),
                "direction": np.asarray(self.matrix, dtype=float)}

    create_sitk_image = create_volume

    def load_array(self):
        """The pixels of an image read with ``only_tags=True`` (JAX
        structure/image.py:1053-1083): re-reads the recorded
        ``filepaths``, orders the datasets by ``sops``, re-assembles the
        volume on the image's device and fills ``self.array``. Raises
        ValueError for missing files or unmatched SOPs."""
        if self.array is not None:
            return self.array
        if not self.filepaths or any(f is None for f in self.filepaths):
            raise ValueError("no filepaths recorded; cannot load array")
        from ..dicom import dcmread
        from ..read.volume3d import Read3D

        try:
            datasets = [dcmread(f) for f in self.filepaths]
            by_sop = {ds.SOPInstanceUID: ds for ds in datasets}
            ordered = [by_sop[sop] for sop in self.sops if sop in by_sop]
            if not ordered:
                raise ValueError("no slices matched the recorded SOPs")
            rebuilt = Read3D(ordered, only_tags=False, register=False,
                             device=self.device)
        except ValueError:
            raise
        except Exception as e:
            # files changed or corrupted since the only_tags pass: a typed
            # error instead of whatever the rebuild hit
            raise ValueError(
                f"deferred pixel load failed for {self.image_name!r}: "
                f"{type(e).__name__}: {e}") from e
        self.array = rebuilt.array
        self.window = self.get_window()
        self.display = Display(self)
        return self.array

    # -- ROI statistics --------------------------------------------------
    def compute_roi_statistics(self, roi_name, values=None):
        """First-order statistics of a value map inside an ROI (HU on CT,
        anything voxel-aligned): min/max/mean/median/std + volume_cc +
        voxel count; NaN statistics for an empty ROI."""
        from ..utils.metrics import voxel_volume_cc

        mask = np.asarray(self.rois[roi_name].compute_mask()) > 0
        vals = np.asarray(self.array if values is None else values,
                          np.float32)
        if vals.shape != mask.shape:
            raise ValueError(
                f"compute_roi_statistics: values shape {vals.shape} "
                f"!= image grid {mask.shape}")
        inside = vals[mask]
        voxel_cc = voxel_volume_cc(self.spacing)
        empty = inside.size == 0
        nan = float("nan")
        return {
            "ROI": roi_name,
            "voxels": int(inside.size),
            "volume_cc": float(inside.size * voxel_cc),
            "min": nan if empty else float(inside.min()),
            "max": nan if empty else float(inside.max()),
            "mean": nan if empty else float(inside.mean()),
            "median": nan if empty else float(np.median(inside)),
            "std": nan if empty else float(inside.std()),
        }

    # -- pooled ROI-mask cache -------------------------------------------
    # Masks are cached bbox-cropped and bit-packed, keyed on
    # (roi._mask_cache_token, roi._mask_rev): both wholesale Roi
    # replacement and any contour/plane rebind (Roi.__setattr__)
    # invalidate. The token is a process-global monotonic id assigned on
    # first cache contact, never id(roi): CPython reuses a freed Roi's
    # address, and an id()-keyed cache could serve a deleted ROI's mask
    # for its replacement.

    @staticmethod
    def _roi_cache_key(roi):
        tok = getattr(roi, "_mask_cache_token", None)
        if tok is None:
            tok = next(_ROI_CACHE_TOKENS)
            object.__setattr__(roi, "_mask_cache_token", tok)
        return (tok, getattr(roi, "_mask_rev", 0))

    @trace("mia.rois.cache")
    def _roi_mask_cache_get(self, name, roi, reconstruct=True):
        cache = getattr(self, "_roi_mask_cache", None)
        ent = cache.get(name) if cache else None
        if ent is None or ent[0] != self._roi_cache_key(roi):
            return None
        if not reconstruct:
            return True
        _, shape, bbox, payload, packed = ent
        out = np.zeros(shape, np.uint8)
        if bbox is not None:
            z0, z1, y0, y1, x0, x1 = bbox
            if packed:
                n = (z1 - z0) * (y1 - y0) * (x1 - x0)
                crop = np.unpackbits(payload, count=n).reshape(
                    z1 - z0, y1 - y0, x1 - x0)
            else:
                crop = payload
            out[z0:z1, y0:y1, x0:x1] = crop
        return out

    @trace("mia.rois.cache")
    def _roi_mask_cache_put(self, name, roi, mask):
        if getattr(self, "_roi_mask_cache", None) is None:
            self._roi_mask_cache = {}
        mask = np.asarray(mask, np.uint8)
        key = self._roi_cache_key(roi)
        zs = np.flatnonzero(mask.any(axis=(1, 2)))
        if zs.size == 0:
            self._roi_mask_cache[name] = (key, mask.shape, None, None,
                                          True)
            return
        ys = np.flatnonzero(mask.any(axis=(0, 2)))
        xs = np.flatnonzero(mask.any(axis=(0, 1)))
        bbox = (int(zs[0]), int(zs[-1]) + 1, int(ys[0]),
                int(ys[-1]) + 1, int(xs[0]), int(xs[-1]) + 1)
        crop = mask[bbox[0]:bbox[1], bbox[2]:bbox[3], bbox[4]:bbox[5]]
        # packbits collapses any nonzero to 1: exact only for binary
        # masks; a non-binary mask caches the raw crop instead
        if crop.max() <= 1:
            payload, packed = np.packbits(crop), True
        else:
            payload, packed = crop.copy(), False
        self._roi_mask_cache[name] = (key, mask.shape, bbox, payload,
                                      packed)

    @trace("mia.rois.masks")
    def compute_roi_masks(self, roi_names=None):
        """Every (or the named) contoured ROI rasterized in one pooled
        device pass per slicing plane (parallel/batch.rasterize_batch),
        bit-identical to the per-ROI path; ROIs without contours take
        their own ``_compute_mask_impl``. Cached masks are served from
        the cache. Returns {name: (Z, Y, X) uint8}."""
        from ..parallel.batch import rasterize_batch

        names = list(roi_names if roi_names is not None else self.rois)
        dims = tuple(int(v) for v in self.dimensions)
        out = {}
        plane_of = {}
        self._pooled_raster_active = True
        try:
            for n in names:
                roi = self.rois[n]
                cached = self._roi_mask_cache_get(n, roi)
                if cached is not None:
                    out[n] = cached
                elif roi._has_contours():
                    plane_of[n] = roi.plane
                else:
                    out[n] = np.asarray(roi._compute_mask_impl(), np.uint8)
                    self._roi_mask_cache_put(n, roi, out[n])
            for plane in sorted(set(plane_of.values())):
                group = [n for n in names if plane_of.get(n) == plane]
                with trace("mia.rois.rasterize"):
                    masks = rasterize_batch(
                        [self.rois[n].contour_pixel for n in group], dims,
                        plane=plane)
                for i, n in enumerate(group):
                    out[n] = masks[i]
                    self._roi_mask_cache_put(n, self.rois[n], out[n])
        finally:
            self._pooled_raster_active = False
        return {n: out[n] for n in names}

    # -- derived ROIs ------------------------------------------------------
    def create_roi_from_margin(self, name, source, margin_mm, color=None,
                               backend="device"):
        """New ROI = ``source`` expanded/contracted by an exact Euclidean
        mm margin (scalar or per-axis [mx, my, mz]; negative contracts),
        through utils/roi/margin.expand_mask (on the card by default;
        backend='scipy' on the host). Returns the new Roi."""
        from ..utils.roi.margin import expand_mask

        mask = expand_mask(self.rois[source].compute_mask(), self.spacing,
                           margin_mm, backend=backend)
        self.create_roi(name=name, color=color or self.rois[source].color)
        self.rois[name].convert_mask(mask)
        return self.rois[name]

    def create_roi_from_boolean(self, name, op, roi_a, roi_b, color=None):
        """New ROI = boolean combination of two ROIs ('union' |
        'intersect' | 'subtract' | 'xor'). Returns the new Roi."""
        from ..utils.roi.margin import combine_masks

        mask = combine_masks(op, self.rois[roi_a].compute_mask(),
                             self.rois[roi_b].compute_mask())
        self.create_roi(name=name, color=color or self.rois[roi_a].color)
        self.rois[name].convert_mask(mask)
        return self.rois[name]

    def create_external(self, name="External", color=None, visible=False,
                        filepaths=None, threshold=-250):
        """Threshold (on the card) -> largest component -> contours -> ROI
        + mesh (reference structure/image.py:961-994)."""
        from ..utils.image.threshold import external
        from ..utils.roi.contour import contours_from_mask

        if color is None:
            color = [0, 255, 0]
        if name not in self.rois:
            self.rois[name] = Roi(self, name=name, color=color,
                                  visible=visible, filepaths=filepaths)

        mask = external(self.array, threshold=threshold, only_mask=True,
                        device=self.device)
        contours = contours_from_mask(mask.astype(np.uint8))
        positions = self.rois[name].convert_pixel_to_position(pixel=contours)

        self.rois[name].contour_pixel = contours
        self.rois[name].contour_position = positions
        self.rois[name].create_discrete_mesh()
        return self.rois[name]

    # -- image analysis ----------------------------------------------------
    def _compute_device(self):
        """The device this image's compute runs on: the one it was
        assembled on, else ``default_device()``."""
        from ..device import default_device

        return self.device if self.device is not None else default_device()

    def resample_to(self, other, values=None, background=-3001.0):
        """Resample this image's volume onto another image's grid (JAX
        structure/image.py:510-540): one composed pixel -> pixel matrix,
        one ``affine`` launch on the card. Both grids must share a frame
        of reference; across studies compose a Rigid and use
        ``Rigid.create_image``.

        other: Image/Dose object or a registered image name; values: an
        optional voxel-aligned map to resample instead of ``self.array``
        (a SUV map, or an ROI mask with ``background=0``). Returns
        float32 on the other grid."""
        from ..ops.resample import affine_resample, compose_pixel_matrix

        if isinstance(other, str):
            other = Data.image[other]
        vals = np.asarray(self.array if values is None else values,
                          np.float32)
        if vals.shape != tuple(self.dimensions):
            raise ValueError(
                f"resample_to: values shape {vals.shape} != image "
                f"grid {tuple(self.dimensions)}")
        A = compose_pixel_matrix(self.matrix, self.spacing, self.origin,
                                 other.matrix, other.spacing,
                                 other.origin)
        out = affine_resample(vals, A, tuple(int(n) for n in
                                             other.dimensions),
                              background=float(background),
                              device=self._compute_device())
        return out.cpu().numpy()

    def _rotation_pixel_matrix(self, angles, center):
        """The output -> input pixel matrix of an Euler rotation (degrees,
        zyx order) about ``center`` (mm) onto this image's own grid: the
        map of ``create_rotated_volume`` and the rotated projections."""
        from ..ops.resample import compose_pixel_matrix
        from ..utils.image.transform import euler_transform

        t = euler_transform(angles=angles, rotation_center=center, zyx=True)
        return compose_pixel_matrix(self.matrix, self.spacing, self.origin,
                                    self.matrix, self.spacing, self.origin,
                                    phys_transform=t.as_matrix4())

    def compute_projection(self, mode="mip", axis="y", angles=None,
                           center=None, mu_water_mm=0.02):
        """2D projection of the volume (JAX structure/image.py:1097-1152):
        ``mip``, ``mean``, or ``drr`` (parallel-beam digitally
        reconstructed radiograph: mu = mu_water (1 + HU/1000) clamped at
        0, detector signal 1 - exp(-sum mu dl)). Optional Euler
        ``angles`` (degrees, zyx) rotate about ``center`` (default the
        volume center) through the ``affine`` mode, with the rotated-in
        corners clamped to air. ``axis`` is the array axis integrated:
        'z' | 'y' | 'x'. The reduction runs on the image's device.
        Returns a 2D float32 array."""
        import torch

        from ..ops.resample import affine_resample

        try:
            ax = {"z": 0, "y": 1, "x": 2}[axis]
        except KeyError:
            raise ValueError(f"compute_projection: axis {axis!r} not "
                             "in ('z', 'y', 'x')") from None
        if mode not in ("mip", "mean", "drr"):
            raise ValueError(f"compute_projection: mode {mode!r} not "
                             "in ('mip', 'mean', 'drr')")

        dev = self._compute_device()
        vol = torch.as_tensor(np.asarray(self.array, np.float32),
                              device=dev)
        if angles is not None and np.any(np.asarray(angles)):
            if center is None:
                center = np.asarray(self.compute_center(), np.float64)
            A = self._rotation_pixel_matrix(angles, center)
            vol = clamp_to_air(affine_resample(
                vol, A, tuple(vol.shape),
                background=float(config.background_fill)))
        return project(vol, mode, ax, self.spacing, mu_water_mm) \
            .cpu().numpy()

    def create_rotated_volume(self, angles=(0, 0, 10), roi_name="Liver",
                              center=None):
        """Euler-rotate the volume about an ROI's mesh center (or
        ``center``, mm) and resample onto the same grid with background
        0 (JAX structure/image.py:1155-1176): one ``affine`` launch on
        the card. Returns float32."""
        from ..ops.resample import affine_resample

        if center is None:
            center = self.rois[roi_name].mesh.center
        A = self._rotation_pixel_matrix(angles, center)
        out = affine_resample(np.asarray(self.array, np.float32), A,
                              self.array.shape, background=0.0,
                              device=self._compute_device())
        return out.cpu().numpy()

    create_rotated_sitk_image = create_rotated_volume

    def compute_suv(self):
        """SUV body-weight map of a PT volume (JAX
        structure/image.py:384-477): SUVbw = activity [Bq/mL] x weight
        [g] / decayed dose [Bq], the dose decayed from injection to the
        series time for DecayCorrection=START (ADMIN needs no factor).
        Requires Units=BQML. The tags are read on the host; the map is
        computed on the image's device. Returns a float32 (Z, Y, X)
        array."""
        import torch

        if self.modality != "PT":
            raise ValueError("compute_suv: PT volumes only, this "
                             f"image is {self.modality}")
        scale = suv_scale(self.tags)
        vol = torch.as_tensor(np.asarray(self.array, np.float32),
                              device=self._compute_device())
        return (vol * torch.tensor(np.float32(scale), device=vol.device)) \
            .cpu().numpy()

    def compute_mtv_tlg(self, roi_name, suv=None, threshold=2.5,
                        relative=False):
        """Metabolic tumor volume and total lesion glycolysis inside an
        ROI (JAX structure/image.py:607-655). ``threshold`` is an
        absolute SUV cutoff, or a fraction of the ROI's SUVmax with
        ``relative=True`` (the common 41 %-of-max segmentation). The
        ROI's values, their maximum, the cut and the count run on the
        image's device; the voxels above the cut are summed in float32
        on the host in numpy's order, so every figure equals the JAX
        package's. Returns {'mtv_cc', 'tlg', 'suv_max',
        'suv_mean_in_mtv', 'threshold'} as python floats."""
        import torch

        from ..utils.metrics import voxel_volume_cc

        if suv is None:
            suv = self.compute_suv()
        suv = np.asarray(suv, np.float32)
        mask = np.asarray(self.rois[roi_name].compute_mask()) > 0
        if suv.shape != mask.shape:
            raise ValueError(
                f"compute_mtv_tlg: SUV shape {suv.shape} != image "
                f"grid {mask.shape}")
        dev = self._compute_device()
        inside = torch.as_tensor(suv, device=dev)[
            torch.as_tensor(mask, device=dev)]
        if inside.numel() == 0:
            return {"mtv_cc": 0.0, "tlg": 0.0, "suv_max": 0.0,
                    "suv_mean_in_mtv": 0.0,
                    # relative cuts are undefined without a max
                    "threshold": (float("nan") if relative
                                  else float(threshold))}
        suv_max = float(inside.max())
        cut = float(threshold) * (suv_max if relative else 1.0)
        hot = inside[inside >= cut].cpu().numpy()
        voxel_cc = voxel_volume_cc(self.spacing)
        return {
            "mtv_cc": float(hot.size * voxel_cc),
            "tlg": float(hot.sum() * voxel_cc) if hot.size else 0.0,
            "suv_max": suv_max,
            "suv_mean_in_mtv": float(hot.mean()) if hot.size else 0.0,
            "threshold": cut,
        }

    def correct_bias(self, mask_roi=None, shrink=4,
                     control_spacing_mm=None, return_field=False,
                     in_place=False, **kwargs):
        """N4-style MR bias field correction (JAX
        structure/image.py:574-605) through ops/n4.n4_bias_correction on
        the image's device. mask_roi: optional ROI name bounding the fit
        (default: all positive voxels); control_spacing_mm: floor of the
        B-spline control spacing in mm (per axis); in_place: replace
        ``self.array`` with the corrected float32 map. Returns the
        corrected volume, or (corrected, field) with ``return_field``."""
        from ..ops.n4 import n4_bias_correction

        mask = None
        if mask_roi is not None:
            mask = np.asarray(self.rois[mask_roi].compute_mask()) > 0
        if control_spacing_mm is not None:
            sx, sy, sz = [float(s) for s in self.spacing]
            kwargs["min_control_spacing"] = [
                control_spacing_mm / sz, control_spacing_mm / sy,
                control_spacing_mm / sx]
        kwargs.setdefault("device", self._compute_device())
        out = n4_bias_correction(self.array, mask=mask, shrink=shrink,
                                 return_field=return_field, **kwargs)
        if in_place:
            self.array = out[0] if return_field else out
        return out

    def compute_radiomics(self, roi_name, values=None, bin_width=None,
                          n_bins=32, families=None, alpha=0):
        """The radiomics panel of one ROI (JAX structure/image.py:771-793)
        through ops/radiomics.compute_radiomics: texture matrices counted
        on the image's device, formulas in host float64. ``values``
        overrides the intensity map (e.g. ``compute_suv()``); discretise
        with ``bin_width`` or ``n_bins``. Returns {family: {feature:
        value}, 'meta': {...}}."""
        from ..ops.radiomics import ALL_FAMILIES, compute_radiomics

        mask = np.asarray(self.rois[roi_name].compute_mask()) > 0
        vals = np.asarray(self.array if values is None else values,
                          np.float32)
        if vals.shape != mask.shape:
            raise ValueError(
                f"compute_radiomics: values shape {vals.shape} != "
                f"image grid {mask.shape}")
        out = compute_radiomics(
            vals, mask, self.spacing, bin_width=bin_width,
            n_bins=n_bins, alpha=alpha,
            families=ALL_FAMILIES if families is None else families,
            device=self._compute_device())
        out["meta"]["ROI"] = roi_name
        return out

    # -- SEG and MHD intake ------------------------------------------------
    def input_seg(self, seg):
        """ROIs from a parsed DICOM SEG (read/seg.ReadSEG; JAX
        structure/image.py:233-248): each new ROI takes its mask, one
        download of the mask the reader built on the device, through
        ``convert_mask`` (contours and meshes, as the JAX package's) and
        into the bit-packed mask cache, so ``compute_mask`` and
        ``compute_roi_masks`` serve the SEG's own voxels without
        rasterizing. A name that already holds contours keeps them."""
        for ii, roi_name in enumerate(seg.roi_names):
            if not (roi_name not in self.rois
                    or self.rois[roi_name].contour_position is None):
                continue
            roi = Roi(self, name=roi_name, color=seg.roi_colors[ii],
                      visible=False, filepaths=seg.filepaths)
            self.rois[roi_name] = roi
            if ii < len(seg.masks):
                mask = host_array(seg.masks[ii], np.uint8)
                roi.convert_mask(mask)
                self._roi_mask_cache_put(roi_name, roi, mask)
        Data.match_rois()

    def input_mhd(self, filename, roi_names, values, plane="Axial"):
        """Label volume -> one ROI per label value (JAX
        structure/image.py:198-210), through ``convert_mask``."""
        from ..read.mhd import read_mhd_volume

        roi_array, _, _, _ = read_mhd_volume(filename)
        for ii, roi_name in enumerate(roi_names):
            if roi_name not in self.rois:
                self.rois[roi_name] = Roi(self, name=roi_name, visible=True,
                                          filepaths=filename, plane=plane)
            roi_mask = roi_array == values[ii]
            self.rois[roi_name].convert_mask(roi_mask)

    # -- DICOM, NIfTI exports (JAX structure/image.py:268-388, 795-1047) ----
    def _reference_items(self, uids):
        """(sop_class, Sequence of this series' SOP references)."""
        from ..dicom import Dataset, Sequence

        sop_class = uids.MODALITY_SOP_CLASS.get(self.modality,
                                                uids.CTImageStorage)
        refs = Sequence()
        for sop in (self.sops or []):
            r = Dataset()
            r.ReferencedSOPClassUID = sop_class
            r.ReferencedSOPInstanceUID = sop
            refs.append(r)
        return sop_class, refs

    def create_rtstruct(self, roi_names=None, poi_names=None, path=None,
                        label="medicalimageanalysis_tpu"):
        """An RTSTRUCT dataset of this image's ROIs (their
        ``contour_position``; a ROI made from a mask has the port's
        tracer's contours) and POIs. Returns the Dataset; writes a
        Part-10 file when ``path`` is given."""
        from ..dicom import Dataset, Sequence, dcmwrite, uids

        if roi_names is None:
            roi_names = [n for n, r in self.rois.items()
                         if r.contour_position is not None]
        if poi_names is None:
            poi_names = [n for n, p in self.pois.items()
                         if p.point_position is not None]

        ds = Dataset()
        ds.SOPClassUID = uids.RTStructureSetStorage
        ds.SOPInstanceUID = generate_uid()
        ds.Modality = "RTSTRUCT"
        ds.StructureSetLabel = label
        ds.PatientID = self.mrn if self.mrn != "missing" else ""
        if isinstance(self.patient_name, list):
            ds.PatientName = "^".join(self.patient_name)
        ds.SeriesInstanceUID = generate_uid()
        ds.StudyInstanceUID = self.get_study_uid()
        ds.FrameOfReferenceUID = self.frame_ref

        # the referenced frame-of-reference chain
        sop_class, imgs = self._reference_items(uids)
        series_item = Dataset()
        series_item.SeriesInstanceUID = self.series_uid
        series_item.ContourImageSequence = imgs
        study_item = Dataset()
        study_item.RTReferencedSeriesSequence = Sequence([series_item])
        for_item = Dataset()
        for_item.ReferencedFrameOfReferenceUID = self.frame_ref
        for_item.RTReferencedStudySequence = Sequence([study_item])
        ds.ReferencedFrameOfReferenceSequence = Sequence([for_item])

        m = self.display.compute_matrix_position_to_pixel()
        roi_seq = Sequence()
        contour_seq = Sequence()
        obs_seq = Sequence()
        number = 0
        for name in list(roi_names) + list(poi_names):
            number += 1
            s = Dataset()
            s.ROINumber = number
            s.ROIName = name
            s.ReferencedFrameOfReferenceUID = self.frame_ref
            s.ROIGenerationAlgorithm = "MANUAL"
            roi_seq.append(s)

            obs = Dataset()
            obs.ObservationNumber = number
            obs.ReferencedROINumber = number
            obs.RTROIInterpretedType = "ORGAN" if name in roi_names \
                else "MARKER"
            obs_seq.append(obs)

            item = Dataset()
            item.ReferencedROINumber = number
            cs = Sequence()
            if name in self.rois and name in roi_names:
                roi = self.rois[name]
                item.ROIDisplayColor = [int(v) for v in
                                        (roi.color or [128, 128, 128])]
                for contour in (roi.contour_position or []):
                    contour = np.asarray(contour, dtype=float)
                    c = Dataset()
                    c.ContourGeometricType = "CLOSED_PLANAR"
                    c.NumberOfContourPoints = contour.shape[0]
                    c.ContourData = [float(v) for v in contour.reshape(-1)]
                    # reference the nearest slice SOP by z pixel index
                    pix = geo.apply_homogeneous(contour[0], m)
                    z = int(np.clip(np.round(pix[2]), 0,
                                    len(self.sops or [1]) - 1))
                    if self.sops:
                        ci = Dataset()
                        ci.ReferencedSOPClassUID = sop_class
                        ci.ReferencedSOPInstanceUID = self.sops[z]
                        c.ContourImageSequence = Sequence([ci])
                    cs.append(c)
            else:
                poi = self.pois[name]
                item.ROIDisplayColor = [int(v) for v in
                                        (poi.color or [128, 128, 128])]
                c = Dataset()
                c.ContourGeometricType = "POINT"
                point = np.asarray(poi.point_position,
                                   dtype=float).reshape(-1)
                c.ContourData = [float(v) for v in point[:3]]
                c.NumberOfContourPoints = 1
                cs.append(c)
            item.ContourSequence = cs
            contour_seq.append(item)

        ds.StructureSetROISequence = roi_seq
        ds.ROIContourSequence = contour_seq
        ds.RTROIObservationsSequence = obs_seq

        if path is not None:
            dcmwrite(path, ds)
        return ds

    def create_seg(self, roi_names=None, path=None, fractional=False,
                   label="medicalimageanalysis_tpu"):
        """A DICOM SEG (Segmentation Storage) dataset of this image's ROIs:
        BINARY 1-bit frames packed LSB-first by default, 8-bit PROBABILITY
        frames with ``fractional=True``; one frame per non-empty (segment,
        slice). The masks come from one pooled pass
        (``compute_roi_masks``). Returns the Dataset; writes a Part-10
        file when ``path`` is given."""
        from ..dicom import Dataset, Sequence, dcmwrite, uids
        from ..read.seg import rgb_to_cielab_uint16

        if roi_names is None:
            roi_names = [n for n, r in self.rois.items()
                         if r.contour_position is not None]
        if not roi_names:
            raise ValueError("create_seg: no ROIs with contours")

        ds = Dataset()
        ds.SOPClassUID = uids.SegmentationStorage
        ds.SOPInstanceUID = generate_uid()
        ds.Modality = "SEG"
        ds.SeriesDescription = label
        ds.ContentLabel = "SEG"
        ds.ContentDescription = label
        ds.ContentCreatorName = "medicalimageanalysis_tpu"
        ds.PatientID = self.mrn if self.mrn != "missing" else ""
        if isinstance(self.patient_name, list):
            ds.PatientName = "^".join(self.patient_name)
        ds.SeriesInstanceUID = generate_uid()
        ds.StudyInstanceUID = self.get_study_uid()
        ds.FrameOfReferenceUID = self.frame_ref

        nz, ny, nx = (int(self.dimensions[0]), int(self.dimensions[1]),
                      int(self.dimensions[2]))
        ds.Rows, ds.Columns = ny, nx
        ds.SamplesPerPixel = 1
        ds.PhotometricInterpretation = "MONOCHROME2"
        ds.PixelRepresentation = 0
        if fractional:
            ds.SegmentationType = "FRACTIONAL"
            ds.SegmentationFractionalType = "PROBABILITY"
            ds.MaximumFractionalValue = 255
            ds.BitsAllocated = ds.BitsStored = 8
            ds.HighBit = 7
        else:
            ds.SegmentationType = "BINARY"
            ds.BitsAllocated = ds.BitsStored = 1
            ds.HighBit = 0

        # the referenced source series
        _, insts = self._reference_items(uids)
        ref_series = Dataset()
        ref_series.SeriesInstanceUID = self.series_uid
        ref_series.ReferencedInstanceSequence = insts
        ds.ReferencedSeriesSequence = Sequence([ref_series])

        # shared functional groups: the grid's pixel-axis plane tags for
        # the canonical (z, y, x) array
        iop, pixel_spacing = geo.grid_plane_tags(self.matrix, self.spacing)
        measures = Dataset()
        measures.PixelSpacing = pixel_spacing
        measures.SliceThickness = float(self.spacing[2])
        measures.SpacingBetweenSlices = float(self.spacing[2])
        orient = Dataset()
        orient.ImageOrientationPatient = iop
        shared = Dataset()
        shared.PixelMeasuresSequence = Sequence([measures])
        shared.PlaneOrientationSequence = Sequence([orient])
        ds.SharedFunctionalGroupsSequence = Sequence([shared])

        # dimension organization (PS3.3 C.7.6.17): frames index by
        # (segment, plane position)
        dim_uid = generate_uid()
        dim_org = Dataset()
        dim_org.DimensionOrganizationUID = dim_uid
        ds.DimensionOrganizationSequence = Sequence([dim_org])
        dim_seg = Dataset()
        dim_seg.DimensionOrganizationUID = dim_uid
        dim_seg.DimensionIndexPointer = 0x0062000B  # ReferencedSegmentNumber
        dim_seg.FunctionalGroupPointer = 0x0062000A
        dim_pos = Dataset()
        dim_pos.DimensionOrganizationUID = dim_uid
        dim_pos.DimensionIndexPointer = 0x00200032  # ImagePositionPatient
        dim_pos.FunctionalGroupPointer = 0x00209113
        ds.DimensionIndexSequence = Sequence([dim_seg, dim_pos])

        def _code(value, meaning):
            c = Dataset()
            c.CodeValue = value
            c.CodingSchemeDesignator = "SCT"
            c.CodeMeaning = meaning
            return c

        masks = self.compute_roi_masks(roi_names=list(roi_names))
        m = self.display.compute_matrix_pixel_to_position()
        seg_seq = Sequence()
        per_frame = Sequence()
        frame_payloads = []
        for number, name in enumerate(roi_names, start=1):
            roi = self.rois[name]
            s = Dataset()
            s.SegmentNumber = number
            s.SegmentLabel = name
            s.SegmentAlgorithmType = "MANUAL"
            s.SegmentedPropertyCategoryCodeSequence = Sequence(
                [_code("123037004", "Anatomical Structure")])
            s.SegmentedPropertyTypeCodeSequence = Sequence(
                [_code("85756007", "Tissue")])
            s.RecommendedDisplayCIELabValue = rgb_to_cielab_uint16(
                roi.color or [128, 128, 128])
            seg_seq.append(s)

            mask = np.asarray(masks[name], np.uint8)
            if mask.shape != (nz, ny, nx):
                raise ValueError(
                    f"create_seg: ROI '{name}' mask shape "
                    f"{mask.shape} != image grid {(nz, ny, nx)}")
            zs = np.flatnonzero(mask.reshape(nz, -1).any(axis=1))
            for z in zs:
                item = Dataset()
                ident = Dataset()
                ident.ReferencedSegmentNumber = number
                item.SegmentIdentificationSequence = Sequence([ident])
                content = Dataset()
                content.DimensionIndexValues = [number, int(z) + 1]
                item.FrameContentSequence = Sequence([content])
                plane = Dataset()
                ipp = geo.apply_homogeneous(
                    np.array([0.0, 0.0, float(z)]), m)
                plane.ImagePositionPatient = [float(v) for v in ipp]
                item.PlanePositionSequence = Sequence([plane])
                per_frame.append(item)
            if zs.size:
                frame_payloads.append(mask[zs])

        ds.SegmentSequence = seg_seq
        ds.PerFrameFunctionalGroupsSequence = per_frame
        ds.NumberOfFrames = len(per_frame)

        flat = np.concatenate([f.reshape(-1) for f in frame_payloads]) \
            if frame_payloads else np.zeros(0, dtype=np.uint8)
        if fractional:
            payload = (flat * 255).astype(np.uint8).tobytes()
        else:
            # contiguous bit packing across frames, LSB-first,
            # end-of-data padding only (PS3.5 8.1.1)
            payload = np.packbits(flat, bitorder="little").tobytes()
        if len(payload) % 2:
            payload += b"\x00"
        ds.PixelData = payload

        if path is not None:
            dcmwrite(path, ds)
        return ds

    def create_nifti(self, path, values=None):
        """Write this volume (or a voxel-aligned ``values`` map: SUV, a
        mask) as NIfTI-1 .nii / .nii.gz, the reader's exact inverse: the
        sform carries the full LPS grid, float maps keep their type."""
        from ..read.nifti import write_nifti_volume

        if self.array is None and values is None:
            raise ValueError("no array to export (only_tags image?)")
        arr = host_array(self.array if values is None else values)
        if self.array is not None and values is not None \
                and arr.shape != tuple(np.shape(self.array)):
            raise ValueError(
                f"create_nifti: values shape {arr.shape} != image "
                f"grid {tuple(np.shape(self.array))}")
        write_nifti_volume(path, arr, self.spacing, self.origin,
                           self.matrix)

    def export_dicom(self, output_dir, description=""):
        """Write this volume as a .dcm slice series with its geometry and
        identity (utils/creation.CreateDicomImage). A float or
        out-of-range array is quantised to int16 in float64 as the JAX
        package does: slope (max - min) / 64000, centred on the
        intercept, rounded half to even. A PT series keeps its SUV tags,
        so ``compute_suv`` works after a round trip."""
        from ..utils.creation import CreateDicomImage

        if self.array is None:
            raise ValueError("no array to export (only_tags image?)")
        arr = host_array(self.array)
        slope, intercept = 1, 0
        needs_rescale = arr.size and (
            np.issubdtype(arr.dtype, np.floating)
            or float(arr.min()) < -32768 or float(arr.max()) > 32767)
        if needs_rescale:
            amin, amax = float(arr.min()), float(arr.max())
            if amax > amin:
                slope = (amax - amin) / 64000.0
                intercept = (amax + amin) / 2.0
            else:
                slope, intercept = 1.0, amin
            arr = np.round((arr.astype(np.float64) - intercept)
                           / slope).astype(np.int16)
        extra = {}
        src = self.tags[0] if self.tags else None
        if src is not None and self.modality == "PT":
            for kw in ("Units", "DecayCorrection", "SeriesTime",
                       "AcquisitionTime", "PatientWeight",
                       "RadiopharmaceuticalInformationSequence"):
                v = src.get(kw) if kw != \
                    "RadiopharmaceuticalInformationSequence" \
                    else getattr(src, kw, None)
                if v is not None:
                    extra[kw] = v
        gen = CreateDicomImage(
            output_dir, arr,
            series=self.series_uid if self.series_uid != "00000.00000"
            else None,
            frame=self.frame_ref if self.frame_ref != "00000.00000"
            else None,
            origin=[float(v) for v in self.origin],
            spacing=[float(self.spacing[0]), float(self.spacing[1])],
            thickness=float(self.spacing[2]))
        # the array is canonical (z, y, x): slices are z-planes, so the
        # written IOP is the pixel-axis directions (matrix rows 0 / 1)
        gen.orientation = geo.grid_plane_tags(self.matrix, self.spacing)[0]
        name = self.patient_name
        gen.run(patient_name="^".join(name) if isinstance(name, list)
                else str(name),
                patient_id=self.mrn, modality=self.modality,
                description=description, rescale_slope=slope,
                rescale_intercept=intercept, extra_tags=extra)
        return gen

    # -- persistence: json + npy folders (JAX structure/image.py:1178-1295)
    def save_image(self, path, rois=True, pois=True):
        """``{path}/{image_name}/`` with meta.json, array.npy (one
        download) and the ROI / POI folders."""
        base = os.path.join(str(path), self.image_name)
        os.makedirs(base, exist_ok=True)
        meta = {
            "image_name": self.image_name, "modality": self.modality,
            "patient_name": self.patient_name, "mrn": self.mrn,
            "birthdate": self.birthdate, "date": str(self.date),
            "time": str(self.time), "series_uid": self.series_uid,
            "acq_number": str(self.acq_number), "frame_ref": self.frame_ref,
            "window": [float(w) for w in self.window], "plane": self.plane,
            "spacing": np.asarray(self.spacing, dtype=float).tolist(),
            "dimensions": np.asarray(self.dimensions).astype(int).tolist(),
            "orientation": np.asarray(self.orientation,
                                      dtype=float).tolist(),
            "origin": np.asarray(self.origin, dtype=float).tolist(),
            "matrix": np.asarray(self.matrix, dtype=float).tolist(),
            "unverified": self.unverified,
            "skipped_slice": list(self.skipped_slice or []),
            "rgb": bool(self.rgb),
            "sops": list(self.sops or []),
            "filepaths": [str(f) for f in (self.filepaths or [])],
        }
        with open(os.path.join(base, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        if self.array is not None:
            np.save(os.path.join(base, "array.npy"), host_array(self.array))
        if rois:
            self.save_rois(base)
        if pois:
            self.save_pois(base)

    def save_rois(self, path, create_main_folder=False):
        base = os.path.join(str(path), "rois") if not create_main_folder \
            else os.path.join(str(path), self.image_name, "rois")
        for name, roi in self.rois.items():
            if roi.contour_position is None:
                continue
            folder = os.path.join(base, name)
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(folder, "roi.json"), "w") as f:
                json.dump({"name": name, "color": list(roi.color or []),
                           "visible": bool(roi.visible),
                           "plane": roi.plane}, f)
            for ii, c in enumerate(roi.contour_position):
                np.save(os.path.join(folder, f"contour_{ii:04d}.npy"),
                        np.asarray(c))

    def save_pois(self, path, create_main_folder=False):
        base = os.path.join(str(path), "pois") if not create_main_folder \
            else os.path.join(str(path), self.image_name, "pois")
        for name, poi in self.pois.items():
            if poi.point_position is None:
                continue
            folder = os.path.join(base, name)
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(folder, "poi.json"), "w") as f:
                json.dump({"name": name, "color": list(poi.color or []),
                           "visible": bool(poi.visible)}, f)
            np.save(os.path.join(folder, "point.npy"),
                    np.asarray(poi.point_position))

    def load_rois(self, roi_path):
        """ROI folders of :meth:`save_rois`; a name that already holds
        contours loads as ``name_2``, ``name_3``, ... (JAX's suffixes)."""
        for entry in sorted(os.listdir(roi_path)):
            folder = os.path.join(roi_path, entry)
            if not os.path.isdir(folder):
                continue
            with open(os.path.join(folder, "roi.json")) as f:
                meta = json.load(f)
            name = meta["name"]
            ii = 1
            while name in self.rois and \
                    self.rois[name].contour_position is not None:
                ii += 1
                name = f"{meta['name']}_{ii}"
            contours = [np.load(os.path.join(folder, f))
                        for f in sorted(os.listdir(folder))
                        if f.startswith("contour_")]
            self.rois[name] = Roi(self, position=contours, name=name,
                                  color=meta.get("color"),
                                  visible=meta.get("visible", False),
                                  filepaths=folder,
                                  plane=meta.get("plane"))
        Data.match_rois()

    def load_pois(self, poi_path):
        """POI folders of :meth:`save_pois`, suffixed like ROIs."""
        for entry in sorted(os.listdir(poi_path)):
            folder = os.path.join(poi_path, entry)
            if not os.path.isdir(folder):
                continue
            with open(os.path.join(folder, "poi.json")) as f:
                meta = json.load(f)
            name = meta["name"]
            ii = 1
            while name in self.pois and \
                    self.pois[name].point_position is not None:
                ii += 1
                name = f"{meta['name']}_{ii}"
            point = np.load(os.path.join(folder, "point.npy"))
            self.pois[name] = Poi(self, position=point, name=name,
                                  color=meta.get("color"),
                                  visible=meta.get("visible", False),
                                  filepaths=folder)
        Data.match_pois()

    @classmethod
    def load_image(cls, image_path, rois=True, pois=True, device=None):
        """An Image rebuilt from a :meth:`save_image` folder and
        registered (utils/creation.image_from_saved); its compute runs on
        ``device`` (default: the card)."""
        from ..utils.creation import image_from_saved
        return image_from_saved(image_path, rois=rois, pois=pois,
                                device=device)


def clamp_to_air(vol):
    """A rotated volume's rotated-in corners carry the -3001 fill, below
    air, which would bias a mean, MIP or DRR: clamp to -1000 HU (JAX
    structure/image.py:1141)."""
    import torch

    return torch.clamp(vol, min=-1000.0)


def project(vol, mode, ax, spacing, mu_water_mm=0.02):
    """The reduction of ``Image.compute_projection`` along array axis
    ``ax`` of the (Z, Y, X) float32 tensor ``vol``, on its device: 'mip',
    'mean', or 'drr' with steps of the axis' spacing (mm)."""
    import torch

    if mode == "mip":
        return vol.amax(dim=ax)
    if mode == "mean":
        return vol.mean(dim=ax)
    dl = float(spacing[{0: 2, 1: 1, 2: 0}[ax]])
    mu = torch.clamp(mu_water_mm * (1.0 + vol / 1000.0), min=0.0)
    return 1.0 - torch.exp(-mu.sum(dim=ax) * dl)


def _tm_seconds(t):
    """DICOM TM "HHMMSS.frac" with its legal truncations (PS3.5 6.2) ->
    seconds; DT offsets are stripped by :func:`_dt_time` first."""
    t = str(t).strip()
    hh = int(t[0:2]) if len(t) >= 2 else 0
    mm = int(t[2:4]) if len(t) >= 4 else 0
    ss = float(t[4:]) if len(t) > 4 else 0.0
    return hh * 3600 + mm * 60 + ss


def _dt_time(t):
    """DICOM DT "YYYYMMDDHHMMSS.frac&ZZXX" -> its time part: the UTC
    offset is dropped (injection and scan share the site clock, so it
    cancels in the difference), then the date."""
    t = str(t).strip()
    for sign in ("+", "-"):
        cut = t.find(sign)
        if cut > 0:
            t = t[:cut]
            break
    return t[8:]


def suv_scale(tags):
    """weight [g] / decayed dose [Bq] from a PT series' datasets (JAX
    structure/image.py:399-470, on the host): Units must be BQML;
    DecayCorrection START decays the injected dose from the
    radiopharmaceutical start (DT preferred over TM) to SeriesTime (else
    the earliest AcquisitionTime), a negative interval crossing
    midnight; ADMIN takes the dose as given. Raises ValueError naming
    what is missing or unsupported."""
    ds = tags[0]
    units = str(ds.get("Units", "") or "")
    if units != "BQML":
        raise ValueError(
            f"compute_suv: Units={units or '<missing>'} — only "
            "BQML (decay-corrected activity concentration) is "
            "convertible")
    seq = getattr(ds, "RadiopharmaceuticalInformationSequence", None)
    if not seq:
        raise ValueError("compute_suv: no Radiopharmaceutical"
                         "InformationSequence")
    info = seq[0]
    dose = info.get("RadionuclideTotalDose")
    half_life = info.get("RadionuclideHalfLife")
    weight = ds.get("PatientWeight")
    for name, v in (("RadionuclideTotalDose", dose),
                    ("RadionuclideHalfLife", half_life),
                    ("PatientWeight", weight)):
        if v is None:
            raise ValueError(f"compute_suv: missing {name}")
    dose, half_life = float(dose), float(half_life)
    weight_g = float(weight) * 1000.0

    decay = str(ds.get("DecayCorrection", "START") or "START")
    if decay == "ADMIN":
        decayed_dose = dose
    elif decay == "START":
        start_dt = info.get("RadiopharmaceuticalStartDateTime")
        start_tm = info.get("RadiopharmaceuticalStartTime")
        if start_dt:
            inj_s = _tm_seconds(_dt_time(start_dt))
        elif start_tm is not None:
            inj_s = _tm_seconds(start_tm)
        else:
            raise ValueError("compute_suv: missing "
                             "radiopharmaceutical start time")
        scan = ds.get("SeriesTime")
        if scan is None:
            # the earliest acquisition across slices (QIBA's scan-start
            # reference; tags[0] is position-sorted, not time-sorted)
            acqs = [s.get("AcquisitionTime") for s in tags]
            acqs = [a for a in acqs if a is not None]
            if not acqs:
                raise ValueError("compute_suv: missing SeriesTime/"
                                 "AcquisitionTime")
            scan = min(acqs, key=_tm_seconds)
        dt = _tm_seconds(scan) - inj_s
        if dt < 0:  # crossed midnight (times are date-less TM)
            dt += 86400.0
        decayed_dose = dose * 2.0 ** (-dt / half_life)
    else:
        raise ValueError(
            f"compute_suv: DecayCorrection={decay} not supported "
            "(START or ADMIN)")
    return weight_g / decayed_dose
