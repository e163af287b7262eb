"""Deformable registration object + Display.

Port of medicalimageanalysis_tpu/structure/deformable.py (``Display``,
:70-240, and ``Deformable``, :240-940). DVFs are (Z, Y, X, 3) float32
fields in mm, in the point-displacement convention (update_rois adds d(p)
to moving points; create_image inverts to get the sampling field). A
Deformable keeps its field in one place, a float32 tensor on ``device``,
whatever made it, and every consumer reads that tensor. The public
``dvf`` is numpy where a solver (or an array) made the field, brought
down on its first read and kept until the field changes, and the tensor
itself where a REG, MHD, ``load_deformable``, TPS (or a tensor) made it;
``ratio`` scales the field for fractional-deformation display.

The compute runs on ``device`` (default: the card when present): the
solvers, the inversion, and the deformed reslice, whose inverse field is
sampled by the warp kernel's ``coords`` mode and whose image by its
``disp`` mode. As in the JAX package, ``compute_demons`` resamples the
moving image on image geometry alone, without ``rigid_matrix``;
``compute_bspline`` and ``create_image`` apply it.

``update_dose`` and ``update_mask`` warp a dose grid or a moving-grid
mask onto the reference grid through the same two stages (rigid resample
by the ``affine`` mode, then the inverted field by the ``coords`` and
``disp`` modes). ``update_rois`` and ``update_pois`` carry ROI meshes
and POIs through the rigid inverse and the field (ops/registration/dvf.
sample_dvf_at_points: the ``coords`` mode with B = 3). The ``Display``
holds the frames at fractional ratios (``compute_deformation``: one
rigid resample for all frames, then each frame's inversion and warp)
and the field's component planes, behind the ``retrieve_*`` queries.
``create_reg`` writes the field as a deformable REG, ``export_image``
the deformed image as MHD, ``save_deformable`` / ``load_deformable`` a
json + npy folder. ``compute_tps`` fits a thin-plate spline through
matched POIs and keeps its dense field on the device. With
``roi_names`` held by both images, the registrations are masked by the
ROIs' mask unions (``roi_mask_union``; a mesh-only ROI adds its
voxelized mesh). The Display's ``compute_mesh_slice`` cuts the deformed
ROI mesh, warping it first through ``update_rois``.
"""

from __future__ import annotations

import copy
import json
import os
import weakref

import numpy as np
import torch

from ..config import config
from ..data import Data
from ..device import as_f32, default_device, full_float32
from ..dicom import generate_uid
from ..ops import geometry as geo
from ..ops.registration.dvf import invert_dvf, sample_dvf_at_points
from ..ops.resample import affine_resample, compose_pixel_matrix
from ..ops.warp import affine_coords, field_warp, warp_disp
from ..telemetry import trace
from ..utils.mesh.trimesh import _SliceResult
from .common import host_array, mesh_cut_pixels

__all__ = ["Display", "Deformable"]


def _jacobian_det(d, inv_spacing):
    """det(I + grad d) per voxel: central differences of the mm
    point-displacement field d (Z, Y, X, 3); inv_spacing [1/sx, 1/sy,
    1/sz]."""
    gz = torch.gradient(d, dim=0)[0] * inv_spacing[2]
    gy = torch.gradient(d, dim=1)[0] * inv_spacing[1]
    gx = torch.gradient(d, dim=2)[0] * inv_spacing[0]
    # J[i, j] = delta_ij + dd_i/dx_j, columns (x, y, z)
    a = 1.0 + gx[..., 0]
    b, c = gy[..., 0], gz[..., 0]
    p, q = gx[..., 1], gz[..., 1]
    e = 1.0 + gy[..., 1]
    g, h = gx[..., 2], gy[..., 2]
    i = 1.0 + gz[..., 2]
    return (a * (e * i - q * h) - b * (p * i - q * g)
            + c * (p * h - e * g))


class Display(object):
    """Deformation view state: the frames at fractional ratios and the
    field's component planes (JAX structure/deformable.py:70-240)."""

    def __init__(self, deformable):
        # a weak reference back: the Deformable owns its Display, and a
        # cycle would hold the field on the device until the collector ran
        self._deformable = weakref.ref(deformable)

        self.origin = None
        self.spacing = None
        self.array = []
        self.image = None
        self.matrix = np.identity(3)

        self.slice_location = [0, 0, 0]
        self.scroll_max = None
        self.offset = {"Axial": [0, 0], "Coronal": [0, 0],
                       "Sagittal": [0, 0]}
        self.misc = {}

        self.compute_scroll_max()

    @property
    def deformable(self):
        return self._deformable()

    def compute_array(self, slice_plane, portion=0):
        array_slice = None
        if slice_plane == "Axial":
            if 0 <= self.slice_location[0] < self.array[portion].shape[0]:
                array_slice = self.array[portion][
                    self.slice_location[0], :, :].astype(np.double)
        elif slice_plane == "Coronal":
            if 0 <= self.slice_location[1] < self.array[portion].shape[1]:
                array_slice = self.array[portion][
                    :, self.slice_location[1], :].astype(np.double)
        else:
            if 0 <= self.slice_location[2] < self.array[portion].shape[2]:
                array_slice = self.array[portion][
                    :, :, self.slice_location[2]].astype(np.double)
        return array_slice

    def compute_deformation(self, division=1):
        """Append the frames at ratios 1/division .. 1 (JAX
        structure/deformable.py:107-118), each equal to
        ``create_image(ratio=...)``: the moving image is resampled
        (``affine``) once for every frame, then each frame inverts its
        scaled field and warps (``coords`` and ``disp``) on the card; the
        frames come back as numpy arrays."""
        d = self.deformable
        ref = Data.image[d.reference_name]
        resampled = d._rigid_resampled_moving()
        for ii in range(division):
            warped = d._warp_resampled_to_reference(
                resampled, config.background_fill,
                ratio=(ii + 1) / division)
            self.array += [warped.cpu().numpy()]
        self.spacing = tuple(np.asarray(ref.spacing))
        self.origin = np.asarray(ref.origin)
        self.compute_offset()
        self.compute_scroll_max()

    def compute_grid(self, slice_plane="Axial", vector="x"):
        """A component plane of the field at the slice location (JAX
        structure/deformable.py:120-131), cut on the device."""
        dvf = self.deformable._field
        if slice_plane == "Axial":
            dvf_plane = dvf[self.slice_location[0], :, :, :]
        elif slice_plane == "Coronal":
            dvf_plane = dvf[:, self.slice_location[1], :, :]
        else:
            dvf_plane = dvf[:, :, self.slice_location[2], :]
        comp = {"x": 0, "y": 1}.get(vector, 2)
        return host_array(dvf_plane[:, :, comp], np.float32)

    def compute_matrix_pixel_to_position(self):
        return geo.pixel_to_position_matrix(self.matrix, self.spacing,
                                            self.origin)

    def compute_matrix_position_to_pixel(self):
        return geo.position_to_pixel_matrix(self.matrix, self.spacing,
                                            self.origin)

    def compute_mesh_slice(self, roi_name=None, location=None,
                           slice_plane=None, return_pixel=False):
        """Deformed-ROI-mesh plane cut (JAX structure/deformable.py:140):
        a ROI not warped yet goes through ``Deformable.update_rois`` (one
        ``coords`` launch on the card) first. Returns the loops as a
        ``_SliceResult``, or with ``return_pixel`` their in-plane pixel
        paths; [] without the mesh."""
        if self.deformable.rois.get(roi_name) is None:
            self.deformable.update_rois(roi_name=roi_name)
        mesh = self.deformable.rois.get(roi_name)
        if mesh is None:
            return []

        normal = np.identity(3)[:3, {"Axial": 2, "Coronal": 1}.get(
            slice_plane, 0)]
        loops = mesh.slice_plane(normal=normal, origin=location)
        if not return_pixel:
            return _SliceResult(loops)
        return mesh_cut_pixels(self, loops, slice_plane)

    def compute_offset(self):
        if self.deformable.reference_name is not None:
            pos = Data.image[self.deformable.reference_name].origin
            self.offset["Axial"][0] = (self.origin[0] - pos[0]) \
                / self.spacing[0]
            self.offset["Axial"][1] = (self.origin[1] - pos[1]) \
                / self.spacing[1]
            self.offset["Coronal"][0] = (self.origin[0] - pos[0]) \
                / self.spacing[0]
            self.offset["Coronal"][1] = (self.origin[2] - pos[2]) \
                / self.spacing[2]
            self.offset["Sagittal"][0] = (self.origin[1] - pos[1]) \
                / self.spacing[1]
            self.offset["Sagittal"][1] = (self.origin[2] - pos[2]) \
                / self.spacing[2]

    def compute_slice_location(self, position=None):
        if position is None:
            src = Data.image[self.deformable.reference_name].display
            source_location = np.flip(src.slice_location)
            position = src.compute_index_positions(source_location)
        self.slice_location = np.flip(np.round(
            (position - self.origin) / self.spacing).astype(np.int32))

    def compute_slice_origin(self, slice_plane):
        slice_origin = None
        if slice_plane == "Axial" \
                and 0 <= self.slice_location[0] <= self.scroll_max[0]:
            location = np.asarray([0, 0, self.slice_location[0]])
            slice_origin = self.origin + location * self.spacing
        elif slice_plane == "Coronal" \
                and 0 <= self.slice_location[1] <= self.scroll_max[1]:
            location = np.asarray([0, self.slice_location[1], 0])
            slice_origin = self.origin + location * self.spacing
        elif slice_plane == "Sagittal" \
                and 0 <= self.slice_location[2] <= self.scroll_max[2]:
            location = np.asarray([self.slice_location[2], 0, 0])
            slice_origin = self.origin + location * self.spacing
        return slice_origin

    def compute_scroll_max(self):
        if len(self.array) == 0:
            if self.deformable.dimensions is not None:
                self.scroll_max = np.asarray(
                    self.deformable.dimensions) - 1
        else:
            self.scroll_max = [self.array[-1].shape[0] - 1,
                               self.array[-1].shape[1] - 1,
                               self.array[-1].shape[2] - 1]

    def convert_position_to_pixel(self, position=None):
        m = self.compute_matrix_position_to_pixel()
        return [geo.apply_homogeneous(np.asarray(p, dtype=np.float64), m)
                for p in position]

    def update_slice_location(self, scroll, slice_plane):
        if slice_plane == "Axial":
            self.slice_location[0] = scroll
        elif slice_plane == "Coronal":
            self.slice_location[1] = scroll
        else:
            self.slice_location[2] = scroll


class Deformable(object):
    """Non-rigid registration record: DVF + rigid pre-transform."""

    def __init__(self, dvf=None, origin=None, spacing=None, dimensions=None,
                 roi_names=None, rigid_matrix=None, dvf_matrix=None,
                 registration_name=None, reference_name=None,
                 moving_name=None, reference_sops=None, moving_sops=None,
                 reference_meshes=None, moving_meshes=None, device=None):
        self.reference_name = reference_name
        self.reference_sops = reference_sops
        self.moving_name = moving_name
        self.moving_sops = moving_sops
        self.roi_names = roi_names
        self.rigid_rois = dict.fromkeys(Data.roi_list)
        self.rois = dict.fromkeys(Data.roi_list)
        self.reference_mesh = reference_meshes
        self.moving_mesh = moving_meshes
        self.local_uid = generate_uid()
        self.device = default_device() if device is None \
            else torch.device(device)

        self.modality = None
        self._field = None              # the field: float32 on self.device
        self._dvf_on_host = False       # ``dvf`` reads it as numpy
        self._dvf_array = None          # that numpy, once read
        if dvf_matrix is not None \
                and not np.allclose(dvf_matrix, np.identity(3), atol=1e-3):
            self.dvf, self.spacing, self.origin, self.dimensions = \
                self.correct_dvf_direction(dvf, spacing, origin, dvf_matrix)
        else:
            self.dvf = dvf
            self.origin = origin
            self.spacing = spacing
            self.dimensions = dimensions

        self.rigid_matrix = np.identity(4) if rigid_matrix is None \
            else rigid_matrix

        self.deformable_name = self.add_deformable(registration_name)

        self.display = Display(self)
        if self._field is not None:
            self.update_rois()

    @property
    def dvf(self):
        """The (Z, Y, X, 3) float32 mm field: numpy where a solver or an
        array made it, brought down from the device on the first read
        (``mia.deformable.dvf_out``) and kept until the field changes;
        the device tensor itself where a REG, MHD, load, TPS or a tensor
        made it. Assigning sets the field; to change the field, assign
        (writing into the numpy copy need not reach it)."""
        return self._host_field() if self._dvf_on_host else self._field

    @dvf.setter
    def dvf(self, value):
        self._set_field(None if value is None
                        else as_f32(value, self.device),
                        on_host=not isinstance(value, torch.Tensor))

    def _set_field(self, field, on_host):
        self._field = field
        self._dvf_on_host = on_host
        self._dvf_array = None

    def _host_field(self):
        """The field as float32 numpy, for ``dvf`` and the writers: the
        copy already brought down, else one download (kept when ``dvf``
        reads numpy)."""
        if self._field is None or self._dvf_array is not None:
            return self._dvf_array
        with trace("mia.deformable.dvf_out"):
            array = self._field.cpu().numpy()
        if self._dvf_on_host:
            self._dvf_array = array
        return array

    def add_deformable(self, deformable_name):
        """'DVF_{ref}_{mov}[_N]' naming with collision suffixing."""
        if deformable_name is None:
            if self.reference_name is None and self.moving_name is None:
                deformable_name = "DVF_Unknown"
            else:
                deformable_name = ("DVF_" + str(self.reference_name) + "_"
                                   + str(self.moving_name))
            if deformable_name in Data.deformable_list:
                n = 1
                while f"{deformable_name}_{n}" in Data.deformable_list:
                    n += 1
                deformable_name = f"{deformable_name}_{n}"

        Data.deformable[deformable_name] = self
        Data.deformable_list += [deformable_name]
        return deformable_name

    def compute_aspect(self, slice_plane):
        if slice_plane == "Axial":
            return np.round(self.spacing[0] / self.spacing[1], 2)
        if slice_plane == "Coronal":
            return np.round(self.spacing[0] / self.spacing[2], 2)
        return np.round(self.spacing[1] / self.spacing[2], 2)

    @trace("mia.deformable.setup")
    def _backend(self, modality_gradient, sigma):
        """Common setup: reference/moving volumes, the cross-modality
        correction, and the ROI mask union + blur (JAX
        structure/deformable.py:325-365): each name of ``roi_names`` whose
        ROI both images hold (with contours or a mesh) adds its mask to
        the reference's and the moving image's union; the unions go in as
        the backend's masks, blurred by ``sigma``. A mesh-only ROI's mask
        is its mesh voxelized on the card."""
        from ..utils.deformable.torch_backend import DeformableTorch

        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        backend = DeformableTorch(device=self.device)
        backend.create_sitk_image(ref.array, ref.origin, ref.spacing,
                                  ref.matrix)
        backend.create_sitk_image(mov.array, mov.origin, mov.spacing,
                                  mov.matrix, reference=False)
        if ref.modality != mov.modality and modality_gradient:
            backend.cross_modality_correction()

        ref_mask, mov_mask = self.roi_mask_union()
        if ref_mask is not None and mov_mask is not None:
            backend.create_sitk_image(ref_mask, ref.origin, ref.spacing,
                                      ref.matrix, mask=True)
            backend.create_sitk_image(mov_mask, mov.origin, mov.spacing,
                                      mov.matrix, reference=False,
                                      mask=True)
            if sigma is not None:
                backend.blur_mask(sigma=sigma)
        return backend

    def roi_mask_union(self):
        """(reference, moving) sums of the masks of the ``roi_names``
        that both images hold, as the JAX package's ``_backend`` adds
        them (uint8 masks, so an overlap counts twice); (None, None)
        when no name matches."""
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        ref_mask = mov_mask = None
        for roi_name in (self.roi_names or []):
            ref_roi = ref.rois.get(roi_name)
            mov_roi = mov.rois.get(roi_name)
            if ref_roi is None or mov_roi is None:
                continue
            if (ref_roi.mesh is not None
                    or ref_roi.contour_pixel is not None) \
                    and (mov_roi.mesh is not None
                         or mov_roi.contour_pixel is not None):
                rm = ref_roi.compute_mask()
                mm = mov_roi.compute_mask()
                ref_mask = rm if ref_mask is None else ref_mask + rm
                mov_mask = mm if mov_mask is None else mov_mask + mm
        return ref_mask, mov_mask

    @trace("mia.deformable.store")
    def _store_dvf(self, dvf_volume):
        """Store in point-displacement convention: invert the sampling
        field the solvers return on the device and keep it there;
        ``dvf`` reads it as numpy."""
        self.origin = np.asarray(dvf_volume["origin"])
        self.spacing = tuple(dvf_volume["spacing"])
        self._set_field(invert_dvf(as_f32(dvf_volume["array"], self.device),
                                   dvf_volume["spacing"]), on_host=True)
        self.dimensions = np.asarray(self._field.shape[:3])

    def compute_biomechanical(self, modality_gradient=True, sigma=2,
                              smooth=True, std=1, iterations=50,
                              intensity_threshold=0.001, step=2.0,
                              elastic_lambda=0.2, crop=5):
        """Linear-elastic demons: symmetric forces with a Navier-Cauchy
        grad(div u) relaxation step per iteration (``elastic_lambda``)."""
        backend = self._backend(modality_gradient, sigma)
        backend.resample()
        self._store_dvf(backend.biomechanical(
            smooth=smooth, std=std, iterations=iterations,
            intensity_threshold=intensity_threshold, step=step,
            elastic_lambda=elastic_lambda, crop=crop))

    def compute_bspline(self, modality_gradient=True, sigma=2,
                        control_spacing=None, mesh_size=None,
                        gradient=1e-5, iterations=100, crop=5):
        """B-spline FFD on the moving image resampled through
        ``rigid_matrix`` onto the reference grid."""
        backend = self._backend(modality_gradient, sigma)
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        A = compose_pixel_matrix(mov.matrix, mov.spacing, mov.origin,
                                 ref.matrix, ref.spacing, ref.origin,
                                 phys_transform=self.rigid_matrix)
        resampled = affine_resample(mov.array, A, ref.array.shape,
                                    background=0.0, device=self.device)
        backend.create_sitk_image(resampled, ref.origin, ref.spacing,
                                  ref.matrix, reference=False)
        backend.resample()
        self._store_dvf(backend.bspline(
            control_spacing=control_spacing, mesh_size=mesh_size,
            gradient=gradient, iterations=iterations, crop=crop))

    @trace("mia.demons")
    def compute_demons(self, method=None, modality_gradient=True, sigma=2,
                       smooth=True, std=1, iterations=50,
                       intensity_threshold=0.001, step=2.0, crop=5,
                       pyramid=None, forces="ssd", lncc_radius=3):
        """Demons variants: 'demons', 'diffeomorphic', 'syn', else the
        fast symmetric-forces demons; ``pyramid`` e.g. (4, 2, 1) for a
        coarse-to-fine schedule, ``forces`` 'ssd' or 'lncc'.
        ``iterations`` is one count for every level or one count a level
        of the pyramid, its appended full-size level included: ANTs'
        greedy SyN schedule is ``method="syn", forces="lncc",
        pyramid=(8, 4, 2, 1), iterations=(100, 70, 50, 20)``; a sequence
        of another length raises ValueError. Returns a dict with the
        solver's per-level ``level_shapes``; the stages' times are read
        from a profiler trace (the ``mia.demons`` span and those inside
        it: ``mia.demons.level`` a level, and for SyN the assembly of its
        halves, ``mia.syn.assemble``)."""
        backend = self._backend(modality_gradient, sigma)
        backend.resample()
        run = {"demons": backend.demons,
               "diffeomorphic": backend.diffeomorphic,
               "syn": backend.syn}.get(str(method).lower(),
                                       backend.fast_demons)
        info = {}
        self._store_dvf(run(
            smooth=smooth, std=std, iterations=iterations,
            intensity_threshold=intensity_threshold, step=step, crop=crop,
            pyramid=pyramid, forces=forces, lncc_radius=lncc_radius,
            info=info))
        return info

    @staticmethod
    def correct_dvf_direction(dvf, spacing, origin, matrix):
        """Rotate field vectors to identity direction about the volume
        center, rewriting the origin. A tensor field is rotated on its
        device in float64 and stays a float32 tensor there."""
        D_new = np.identity(3)
        R = D_new @ np.linalg.inv(matrix)

        center_index = (np.flip(np.asarray(dvf.shape))[1:] - 1) / 2.0
        center_phys = np.asarray(origin) + np.asarray(matrix) @ (
            center_index * np.asarray(spacing))

        Z, Y, X, _ = dvf.shape
        if isinstance(dvf, torch.Tensor):
            Rt = torch.as_tensor(R, dtype=torch.float64, device=dvf.device)
            dvf_rotated = (dvf.reshape(-1, 3).to(torch.float64) @ Rt.T) \
                .to(torch.float32).reshape(Z, Y, X, 3)
        else:
            dvf_rotated = (R @ dvf.reshape(-1, 3).T).T.reshape(Z, Y, X, 3)

        origin_new = center_phys - D_new @ (center_index
                                            * np.asarray(spacing))
        return dvf_rotated, spacing, origin_new, dvf_rotated.shape[0:3]

    @torch.no_grad()
    def _warp_resampled_to_reference(self, resampled, background, ratio=1):
        """Invert the DVF and warp a (Z, Y, X) tensor already resampled
        onto the reference grid: the inverse field is sampled at the
        reference voxels by the ``coords`` mode, the image by the
        ``disp`` mode."""
        dvf = self._field * float(ratio)
        inv = invert_dvf(dvf, self.spacing)
        ref = Data.image[self.reference_name]
        ref_p2p = geo.pixel_to_position_matrix(ref.matrix, ref.spacing,
                                               ref.origin)
        # ref voxel -> DVF-grid pixel coords (the DVF grid is
        # axis-aligned with self.origin / self.spacing)
        dvf_pos2pix = geo.position_to_pixel_matrix(
            np.eye(3), self.spacing, self.origin)
        cz, cy, cx = affine_coords(
            as_f32((dvf_pos2pix @ ref_p2p).astype(np.float32), self.device),
            resampled.shape)
        disp = field_warp(torch.movedim(inv, -1, 0), cz, cy, cx,
                          background=0.0)             # (3,Z,Y,X) mm xyz
        # displaced ref-pixel sample coordinates: pix + L @ disp, L the
        # linear part of the reference's position -> pixel map
        L = as_f32(np.asarray(geo.position_to_pixel_matrix(
            ref.matrix, ref.spacing, ref.origin))[:3, :3]
            .astype(np.float32), self.device)
        with full_float32():
            disp_pix = torch.einsum("ij,jzyx->izyx", L, disp)
        return warp_disp(resampled, disp_pix, background)

    def _rigid_resampled_moving(self):
        """The moving image resampled through ``rigid_matrix`` onto the
        reference grid (one ``affine`` launch on the card)."""
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        A = compose_pixel_matrix(mov.matrix, mov.spacing, mov.origin,
                                 ref.matrix, ref.spacing, ref.origin,
                                 phys_transform=self.rigid_matrix)
        return affine_resample(mov.array, A, ref.array.shape,
                               background=config.background_fill,
                               device=self.device)

    @trace("mia.deformable.create_image")
    def create_image(self, ratio=1):
        """Rigid resample -> invert DVF -> displacement warp onto the
        reference grid; returns a volume dict with a numpy array."""
        ref = Data.image[self.reference_name]
        warped = self._warp_resampled_to_reference(
            self._rigid_resampled_moving(), config.background_fill,
            ratio=ratio)
        with trace("mia.deformable.image_out"):
            array = warped.cpu().numpy()
        return {"array": array,
                "origin": np.asarray(ref.origin),
                "spacing": np.asarray(ref.spacing),
                "direction": np.asarray(ref.matrix)}

    def update_dose(self, dose_name=None, ratio=1):
        """Warp a dose grid tied to the moving image through rigid + DVF
        onto the reference image grid (the adaptive-RT dose warp).
        Without ``dose_name`` the one dose sharing the moving image's
        FrameOfReferenceUID is taken. Returns a reference-grid volume
        dict with a numpy array; background is 0 Gy."""
        if dose_name is None:
            mov = Data.image[self.moving_name]
            candidates = [n for n, d in Data.dose.items()
                          if d.frame_ref == mov.frame_ref]
            if not candidates:
                raise ValueError(
                    "update_dose: no dose shares the moving image's "
                    "FrameOfReferenceUID; pass dose_name explicitly")
            if len(candidates) > 1:
                raise ValueError(
                    "update_dose: multiple doses share the moving "
                    f"image's FrameOfReferenceUID ({candidates}); "
                    "pass dose_name explicitly")
            dose_name = candidates[0]
        dose = Data.dose[dose_name]

        ref = Data.image[self.reference_name]
        A = compose_pixel_matrix(dose.matrix, dose.spacing, dose.origin,
                                 ref.matrix, ref.spacing, ref.origin,
                                 phys_transform=self.rigid_matrix)
        resampled = affine_resample(np.asarray(dose.array, np.float32), A,
                                    ref.array.shape, background=0.0,
                                    device=self.device)
        warped = self._warp_resampled_to_reference(resampled, 0.0,
                                                   ratio=ratio)
        return {"array": warped.cpu().numpy(),
                "origin": np.asarray(ref.origin),
                "spacing": np.asarray(ref.spacing),
                "direction": np.asarray(ref.matrix),
                "dose_name": dose_name}

    def update_mask(self, mask, ratio=1, threshold=0.5):
        """Warp a moving-image-grid binary mask onto the reference grid:
        rigid resample + field warp of the float indicator, then
        ``>= threshold``. Returns a (Z, Y, X) uint8 numpy mask on the
        reference grid."""
        if self._field is None:
            raise ValueError("update_mask: no DVF computed yet")
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        mask = np.asarray(mask, np.float32)
        expect = tuple(int(v) for v in mov.dimensions)
        if mask.shape != expect:
            raise ValueError(
                f"update_mask: mask shape {mask.shape} != moving "
                f"image grid {expect}")

        A = compose_pixel_matrix(mov.matrix, mov.spacing, mov.origin,
                                 ref.matrix, ref.spacing, ref.origin,
                                 phys_transform=self.rigid_matrix)
        resampled = affine_resample(mask, A,
                                    tuple(int(v) for v in ref.dimensions),
                                    background=0.0, device=self.device)
        warped = self._warp_resampled_to_reference(resampled, 0.0,
                                                   ratio=ratio)
        return (warped >= float(threshold)).to(torch.uint8).cpu().numpy()

    def compute_jacobian(self):
        """Jacobian-determinant QA map of T(p) = p + d(p) (det <= 0 marks
        folding). Returns {'det': (Z, Y, X) float32, 'folding_fraction',
        'det_min', 'det_max', 'det_mean'}."""
        if self._field is None:
            raise ValueError("compute_jacobian: no DVF computed yet")
        grid = tuple(self._field.shape[:3])
        if any(int(s) < 2 for s in grid):
            raise ValueError(
                "compute_jacobian: every grid axis needs >= 2 samples "
                f"for finite differences, got {grid}")
        inv_sp = [float(np.float32(1.0 / float(v))) for v in self.spacing]
        det = _jacobian_det(self._field, inv_sp)
        det = det.cpu().numpy()
        return {
            "det": det,
            "folding_fraction": float((det <= 0).mean()),
            "det_min": float(det.min()),
            "det_max": float(det.max()),
            "det_mean": float(det.mean()),
        }

    def update_rois(self, roi_name=None, percent=100):
        """Warp visible moving ROI meshes through the rigid inverse and
        the field scaled by ``percent`` (reference
        structure/deformable.py:961-1001): one ``warp_coords`` launch
        (B = 3) a mesh on the card."""
        for name in list(self.rois.keys()):
            if name not in Data.roi_list:
                del self.rois[name]
        for name in Data.roi_list:
            if name not in self.rois:
                self.rois[name] = None
                self.rigid_rois[name] = None

        if self.moving_name is None \
                or self.moving_name not in Data.image:
            return
        field = None
        for name in Data.roi_list:
            if roi_name is None or name == roi_name:
                roi = Data.image[self.moving_name].rois.get(name)
                if roi is not None and roi.mesh is not None and roi.visible:
                    if field is None:   # scaled once for every ROI
                        field = self._field * (percent / 100.0)
                    self.rigid_rois[name] = roi.mesh.transform(
                        np.linalg.inv(self.rigid_matrix), inplace=False)
                    points = self.rigid_rois[name].points
                    disp = sample_dvf_at_points(field, points, self.origin,
                                                self.spacing)
                    deformed = copy.deepcopy(self.rigid_rois[name])
                    deformed.points = points + disp
                    self.rois[name] = deformed

    def update_pois(self, poi_name=None, percent=100):
        """Propagate the moving image's POIs through the rigid inverse and
        the field into the reference frame; the sample is linear in the
        field, so ``percent`` scales it after. Returns {name: (3,)
        position mm} and caches it on ``self.pois``."""
        if self._field is None:
            raise ValueError("update_pois: no DVF computed yet")
        if self.moving_name is None \
                or self.moving_name not in Data.image:
            return {}
        rigid_inv = np.linalg.inv(np.asarray(self.rigid_matrix,
                                             np.float64))
        names, pts = [], []
        for name, poi in Data.image[self.moving_name].pois.items():
            if poi_name is not None and name != poi_name:
                continue
            if poi.point_position is None:
                continue
            p = np.asarray(poi.point_position, np.float64)
            names.append(name)
            pts.append((rigid_inv @ np.append(p, 1.0))[:3])
        out = {}
        if names:
            pts = np.stack(pts)
            disp = sample_dvf_at_points(self._field, pts, self.origin,
                                        self.spacing)
            mapped = pts + disp * (percent / 100.0)
            out = {n: mapped[i] for i, n in enumerate(names)}
        if poi_name is None or not hasattr(self, "pois"):
            self.pois = out
        else:
            self.pois.update(out)
        return out

    def compute_tps(self, poi_names=None, points_reference=None,
                    points_moving=None, regularization=0.0, chunk=None):
        """Landmark-driven deformable registration: a 3-D thin-plate
        spline through matched POIs (JAX structure/deformable.py:451-540).

        Matches POI names shared by the reference and moving images (or
        takes explicit ``points_reference`` / ``points_moving`` (N, 3) mm
        arrays). Moving points are pre-mapped through inv(rigid_matrix),
        the composition of update_pois, so the spline carries only the
        residual deformation. The fit is host float64
        (ops/registration/tps.tps_fit); the dense field over the
        reference grid (identity orientation: the DVF samplers index
        fields axis-aligned) is evaluated on the device and kept there
        as the field tensor, in the point-displacement convention. Exact
        at the landmarks when ``regularization`` is 0. Returns {name:
        residual mm} (index keys for explicit points)."""
        from ..ops.registration.tps import (CHUNK, tps_displacement,
                                            tps_displacement_grid, tps_fit)

        chunk = CHUNK if chunk is None else int(chunk)
        rigid_inv = np.linalg.inv(np.asarray(self.rigid_matrix,
                                             np.float64))
        if points_reference is not None or points_moving is not None:
            if points_reference is None or points_moving is None:
                raise ValueError(
                    "compute_tps: points_reference and points_moving "
                    "must be given together")
            t = np.asarray(points_reference, np.float64).reshape(-1, 3)
            m = np.asarray(points_moving, np.float64).reshape(-1, 3)
            if t.shape != m.shape:
                raise ValueError("compute_tps: point array shapes differ")
            names = [str(i) for i in range(t.shape[0])]
        else:
            ref_pois = Data.image[self.reference_name].pois
            mov_pois = Data.image[self.moving_name].pois
            names, t_list, m_list = [], [], []
            for name, poi in ref_pois.items():
                if poi_names is not None and name not in poi_names:
                    continue
                other = mov_pois.get(name)
                if poi.point_position is None or other is None \
                        or other.point_position is None:
                    continue
                names.append(name)
                t_list.append(np.asarray(poi.point_position, np.float64))
                m_list.append(np.asarray(other.point_position,
                                         np.float64))
            if not names:
                raise ValueError(
                    "compute_tps: no matched POIs with positions "
                    "between reference and moving images")
            t = np.stack(t_list)
            m = np.stack(m_list)

        p = (np.concatenate([m, np.ones((len(m), 1))], axis=1)
             @ rigid_inv.T)[:, :3]
        W, A = tps_fit(p, t - p, regularization=regularization)

        ref = Data.image[self.reference_name]
        self.dvf = tps_displacement_grid(
            p, W, A, ref.origin, ref.spacing, np.eye(3), ref.array.shape,
            chunk=chunk, device=self.device)
        self.origin = np.asarray(ref.origin, np.float64)
        self.spacing = tuple(np.asarray(ref.spacing, np.float64))
        self.dimensions = np.asarray(self._field.shape[:3])
        self.display.compute_scroll_max()
        self.update_rois()

        fitted = tps_displacement(p, W, A, p.astype(np.float32),
                                  chunk=chunk, device=self.device)
        residual = np.linalg.norm(p + fitted.cpu().numpy() - t, axis=1)
        return {n: float(r) for n, r in zip(names, residual)}

    # -- export and persistence (JAX structure/deformable.py:749-808,
    # 860-910) ------------------------------------------------------------
    def create_reg(self, path=None):
        """A DICOM Deformable Spatial Registration (REG) dataset of this
        field: ReferencedSeriesSequence (reference, moving),
        PreDeformationMatrixRegistrationSequence with inv(rigid_matrix) in
        float64 (ReadREG inverts back), and the grid (axis-aligned
        orientation, origin, GridDimensions (x, y, z), GridResolution,
        VectorGridData: the (Z, Y, X, 3) point displacements as float32
        little-endian, downloaded once). Returns the Dataset; writes a
        Part-10 file when ``path`` is given."""
        from ..dicom import Dataset, Sequence, dcmwrite, uids
        from .common import build_reg_dataset

        if self._field is None:
            raise ValueError("create_reg: no DVF computed yet")
        if self.reference_name not in Data.image \
                or self.moving_name not in Data.image:
            raise ValueError(
                "create_reg: reference and moving images must both be "
                "loaded to reference their series/SOPs")
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        ds = build_reg_dataset(
            uids.DeformableSpatialRegistrationStorage, ref, mov,
            self.deformable_name)

        pre = Dataset()
        pre.FrameOfReferenceTransformationMatrix = [
            float(v) for v in np.linalg.inv(
                np.asarray(self.rigid_matrix, np.float64)).reshape(-1)]
        pre.FrameOfReferenceTransformationMatrixType = "RIGID"

        dvf = np.ascontiguousarray(self._host_field(), "<f4")
        grid = Dataset()
        grid.ImageOrientationPatient = [1, 0, 0, 0, 1, 0]
        grid.ImagePositionPatient = [float(v) for v in self.origin]
        grid.GridDimensions = [int(dvf.shape[2]), int(dvf.shape[1]),
                               int(dvf.shape[0])]       # (x, y, z)
        grid.GridResolution = [float(v) for v in self.spacing]
        grid.VectorGridData = dvf.tobytes()
        dreg = Dataset()
        dreg.SourceFrameOfReferenceUID = mov.frame_ref
        dreg.PreDeformationMatrixRegistrationSequence = Sequence([pre])
        dreg.DeformableRegistrationGridSequence = Sequence([grid])
        ds.DeformableRegistrationSequence = Sequence([dreg])

        if path is not None:
            dcmwrite(path, ds)
        return ds

    def export_image(self, path=None):
        """Write ``create_image`` (the ``affine``, ``coords`` and ``disp``
        launches) as MHD."""
        if self.moving_name is not None and path is not None:
            out = self.create_image()
            from ..read.mhd import write_mhd_volume
            write_mhd_volume(path, out["array"], spacing=out["spacing"],
                             origin=out["origin"])

    def save_deformable(self, path):
        """``{path}/deformable.json`` + ``dvf.npy`` (the field downloaded
        once)."""
        os.makedirs(str(path), exist_ok=True)
        payload = {
            "deformable_name": self.deformable_name,
            "reference_name": self.reference_name,
            "moving_name": self.moving_name,
            "roi_names": list(self.roi_names or []),
            "origin": np.asarray(self.origin, dtype=float).tolist(),
            "spacing": np.asarray(self.spacing, dtype=float).tolist(),
            "dimensions": np.asarray(self.dimensions).astype(int).tolist()
            if self.dimensions is not None else None,
            "rigid_matrix": np.asarray(self.rigid_matrix).tolist(),
        }
        with open(os.path.join(str(path), "deformable.json"), "w") as f:
            json.dump(payload, f, indent=1)
        np.save(os.path.join(str(path), "dvf.npy"), self._host_field())

    @classmethod
    def load_deformable(cls, path, device=None):
        """A :meth:`save_deformable` folder back into ``Data.deformable``
        under its saved name, collision-suffixed ('Fraction2_DVF' ->
        'Fraction2_DVF_1' when taken). The field is uploaded once to
        ``device`` (default: the card) and kept there."""
        from .common import collision_suffix

        device = default_device() if device is None \
            else torch.device(device)
        with open(os.path.join(str(path), "deformable.json")) as f:
            payload = json.load(f)
        dvf_path = os.path.join(str(path), "dvf.npy")
        dvf = None
        if os.path.exists(dvf_path):
            dvf = np.load(dvf_path, allow_pickle=True)
            dvf = None if dvf.dtype == object else \
                torch.from_numpy(dvf).to(device)
        name = payload.get("deformable_name")
        if name is not None:
            name = collision_suffix(name, Data.deformable_list)
        return cls(
            dvf=dvf,
            origin=(np.asarray(payload["origin"], np.float64)
                    if payload.get("origin") is not None else None),
            spacing=(tuple(payload["spacing"])
                     if payload.get("spacing") is not None else None),
            dimensions=(np.asarray(payload["dimensions"])
                        if payload.get("dimensions") is not None
                        else None),
            roi_names=payload.get("roi_names") or [],
            rigid_matrix=np.asarray(payload.get("rigid_matrix",
                                                np.eye(4)), np.float64),
            registration_name=name,
            reference_name=payload.get("reference_name"),
            moving_name=payload.get("moving_name"), device=device)

    # -- view queries (JAX structure/deformable.py:811-860) ---------------
    def retrieve_array_plane(self, slice_plane, solo=None, position=None,
                             vector=None):
        if len(self.display.array) == 0:
            self.display.compute_deformation()
            self.display.compute_slice_location()
        if solo is None:
            self.display.compute_slice_location(position=position)
        if vector is None:
            return self.display.compute_array(slice_plane)
        if vector in ("x", "y", "z"):
            return self.display.compute_grid(slice_plane=slice_plane,
                                             vector=vector)
        return None

    def retrieve_grid(self, slice_plane="Axial", vector="x"):
        return self.display.compute_grid(slice_plane=slice_plane,
                                         vector=vector)

    def retrieve_offset(self, slice_plane):
        return self.display.offset[slice_plane]

    def retrieve_slice_location(self, slice_plane):
        if slice_plane == "Axial":
            return self.display.slice_location[0]
        if slice_plane == "Coronal":
            return self.display.slice_location[1]
        return self.display.slice_location[2]

    def retrieve_slice_position(self, slice_plane=None):
        m = self.display.compute_matrix_pixel_to_position()
        if slice_plane is None:
            location = [self.display.slice_location[2],
                        self.display.slice_location[1],
                        self.display.slice_location[0]]
        elif slice_plane == "Axial":
            location = [0, 0, self.display.slice_location[0]]
        elif slice_plane == "Coronal":
            location = [0, self.display.slice_location[1], 0]
        else:
            location = [self.display.slice_location[2], 0, 0]
        return geo.apply_homogeneous(location, m)

    def retrieve_scroll_max(self, slice_plane):
        if slice_plane == "Axial":
            return self.display.scroll_max[0]
        if slice_plane == "Coronal":
            return self.display.scroll_max[1]
        return self.display.scroll_max[2]
