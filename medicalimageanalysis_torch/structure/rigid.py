"""Rigid registration object + Display.

Carried over from medicalimageanalysis_tpu/structure/rigid.py (the
``Display`` view state :29-185; ``Rigid``: registry naming :188-241,
``compute_intensity`` :321-339, ``create_image`` :548-566,
``pre_alignment`` :640-673, the ``retrieve_*`` queries :676-733, the
view updates ``update_rotation`` / ``update_translation`` :771-805, the
ROI mesh transforms ``update_rois`` / ``copy_roi`` and ``update_pois``, and
the exports: ``create_reg`` :577-637, ``export_image`` :568-575 (MHD) and
``save_rigid`` / ``load_rigid`` :735-768). The
matrix semantics are identical: ``matrix @ combo_matrix`` maps reference
-> moving physical space and ``inverse`` flips the roles. The reslice
behind the view runs on the device (``reslice_tensor``: the warp
kernel's ``affine`` mode, or with ``config.use_shear_warp`` the
lane_interp kernel's three passes) and stays there; only the planes
shown come to the host. The registration drivers of JAX
structure/rigid.py:254-531 are here too: mesh ICP (``compute_icp_vtk``,
``compute_o3d``; utils/rigid/icp.ICP on the device),
``compute_phase_correlation`` (the moving image resliced onto the
reference grid by the ``affine`` mode, then FFT phase correlation on the
device), ``compute_landmarks`` (host float64 Umeyama over matched POIs)
and ``auto_register`` (centre matching, phase correlation, then
``compute_intensity`` warm-started from the recovered pose). The
Display's ``compute_mesh_slice`` cuts the ROI mesh carried onto the
reference (``update_rois``) on the display's planes.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from ..config import config
from ..data import Data
from ..dicom import generate_uid
from ..ops import geometry as geo
from ..ops.resample import reslice_tensor, reslice_transform
from ..telemetry import trace
from ..utils.mesh.trimesh import _SliceResult
from .common import mesh_cut_pixels

__all__ = ["Display", "Rigid", "VIEW", "matrix_type"]

# the view's overlay: reslices kept on the device, planes cut there, and
# whole volumes brought to the host (``Display.array`` read)
VIEW = {"reslices": 0, "planes": 0, "volume_reads": 0}


class Display(object):
    """Resampled-moving-volume view state
    (reference structure/rigid.py:33-408). ``compute_reslice`` keeps the
    overlay on the device (``overlay``, a tensor) and the planes are cut
    there; ``array`` brings the whole volume down only when read."""

    def __init__(self, rigid):
        self.rigid = rigid

        self.origin = None
        self.spacing = None
        self.overlay = None
        self._array = None
        self.matrix = np.identity(4)

        self.slice_location = [0, 0, 0]
        self.scroll_max = [0, 0, 0]
        self.offset = {"Axial": [0, 0], "Coronal": [0, 0],
                       "Sagittal": [0, 0]}
        self.misc = {}

    @property
    def array(self):
        """The overlay as numpy: brought down from the device on the first
        read after a reslice (``mia.view.array``), then kept."""
        if self._array is None and self.overlay is not None:
            with trace("mia.view.array"):
                self._array = self.overlay.cpu().numpy()
            VIEW["volume_reads"] += 1
        return self._array

    @array.setter
    def array(self, value):
        self._array = value
        self.overlay = None

    @property
    def shape(self):
        """The overlay's (Z, Y, X), read without a copy; None without one."""
        if self.overlay is not None:
            return tuple(self.overlay.shape)
        return None if self._array is None else self._array.shape

    def compute_array_slice(self, slice_plane):
        """The plane at ``slice_location`` as float64 numpy, None outside
        the overlay. Cut on the device, only the plane comes down."""
        axis = {"Axial": 0, "Coronal": 1}.get(slice_plane, 2)
        index = int(self.slice_location[axis])
        if not 0 <= index < self.shape[axis]:
            return None
        cut = (slice(None),) * axis + (index,)
        if self.overlay is None:
            return self._array[cut].astype(np.double)
        VIEW["planes"] += 1
        return self.overlay[cut].cpu().numpy().astype(np.double)

    def compute_offset(self):
        """Pixel offsets of the resliced grid vs the base image origin
        (reference structure/rigid.py:85-107)."""
        if self.rigid.inverse:
            pos = Data.image[self.rigid.moving_name].origin
        else:
            pos = Data.image[self.rigid.reference_name].origin

        self.offset["Axial"][0] = (self.origin[0] - pos[0]) / self.spacing[0]
        self.offset["Axial"][1] = (self.origin[1] - pos[1]) / self.spacing[1]
        self.offset["Coronal"][0] = (self.origin[0] - pos[0]) / self.spacing[0]
        self.offset["Coronal"][1] = (self.origin[2] - pos[2]) / self.spacing[2]
        self.offset["Sagittal"][0] = (self.origin[1] - pos[1]) \
            / self.spacing[1]
        self.offset["Sagittal"][1] = (self.origin[2] - pos[2]) \
            / self.spacing[2]

    def _base_matrix(self):
        if self.rigid.inverse:
            return copy.deepcopy(Data.image[self.rigid.reference_name].matrix)
        return copy.deepcopy(Data.image[self.rigid.moving_name].matrix)

    def compute_matrix_pixel_to_position(self):
        return geo.pixel_to_position_matrix(self._base_matrix(),
                                            self.spacing, self.origin)

    def compute_matrix_position_to_pixel(self):
        return geo.position_to_pixel_matrix(self._base_matrix(),
                                            self.spacing, self.origin)

    def compute_mesh_slice(self, roi_name=None, location=None,
                           slice_plane=None, return_pixel=False):
        """Transformed-ROI-mesh plane cut (JAX structure/rigid.py:91): a
        ROI not carried yet goes through ``Rigid.update_rois`` first; the
        plane's normal is the display matrix's column. Returns the loops
        as a ``_SliceResult``, or with ``return_pixel`` their in-plane
        pixel paths; [] without the mesh."""
        if self.rigid.rois.get(roi_name) is None:
            self.rigid.update_rois(roi_name=roi_name)
        if self.rigid.rois.get(roi_name) is None:
            return []

        normal = np.asarray(self.matrix)[:3, {"Axial": 2, "Coronal": 1}.get(
            slice_plane, 0)]
        loops = self.rigid.rois[roi_name].slice_plane(normal=normal,
                                                      origin=location)
        if not return_pixel:
            return _SliceResult(loops)
        return mesh_cut_pixels(self, loops, slice_plane)

    @trace("mia.view.reslice")
    def compute_reslice(self):
        """Pull the transformed moving volume (reference
        structure/rigid.py:225-247, the device warp instead of VTK), kept
        on the device; the previous overlay is released."""
        out = reslice_tensor(*self.rigid._reslice_args())
        with trace("mia.view.state"):
            self.origin = np.asarray(out["origin"])
            self.spacing = tuple(out["spacing"])
            self._array, self.overlay = None, out["array"]
            VIEW["reslices"] += 1
            self.compute_offset()
            self.compute_scroll_max()

    def compute_slice_location(self, position=None):
        """Derive the slice location from the counterpart image's display
        state (reference structure/rigid.py:249-270)."""
        if position is None:
            if self.rigid.inverse:
                src = Data.image[self.rigid.moving_name].display
            else:
                src = Data.image[self.rigid.reference_name].display
            source_location = np.flip(src.slice_location)
            position = src.compute_index_positions(source_location)

        self.slice_location = np.flip(np.round(
            (position - self.origin) / self.spacing).astype(np.int32))

    def compute_slice_origin(self, slice_plane):
        m = self.compute_matrix_pixel_to_position()
        if slice_plane == "Axial":
            location = [0, 0, self.slice_location[0]]
        elif slice_plane == "Coronal":
            location = [0, self.slice_location[1], 0]
        else:
            location = [self.slice_location[2], 0, 0]
        return geo.apply_homogeneous(location, m)

    def compute_scroll_max(self):
        shape = self.shape
        if shape is not None:
            self.scroll_max = [shape[0] - 1, shape[1] - 1, shape[2] - 1]

    def compute_slice(self, slice_plane):
        array_slice = self.compute_array_slice(slice_plane)
        return {"array": array_slice,
                "origin": self.compute_slice_origin(slice_plane),
                "spacing": self.spacing, "matrix": self.matrix}

    compute_vtk_slice = compute_slice

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


class Rigid(object):
    """4x4 rigid registration between two registered images."""

    def __init__(self, reference_name, moving_name, rigid_name=None,
                 roi_names=None, reference_sops=None, moving_sops=None,
                 reference_matrix=None, matrix=None, combo_matrix=None,
                 combo_name=None, device=None):
        self.reference_name = reference_name
        self.moving_name = moving_name
        self.combo_name = combo_name
        self.rois = dict.fromkeys(Data.roi_list)
        self.local_uid = generate_uid()
        self.device = device

        self.roi_names = ["Unknown"] if roi_names is None else roi_names
        self.slices = {"reference": ["All"], "moving": ["All"],
                       "reference_sops": reference_sops,
                       "moving_sops": moving_sops}
        self.rotation_center = np.asarray([0, 0, 0])
        self.reference_matrix = np.identity(4) if reference_matrix is None \
            else reference_matrix
        self.matrix = np.identity(4) if matrix is None else matrix
        self.combo_matrix = np.identity(4) if combo_matrix is None \
            else combo_matrix

        self.inverse = False
        self.misc = {}
        self.rigid_name = self.add_rigid(rigid_name)

        self.display = Display(self)
        if matrix is not None:
            self.update_rois()

    def add_rigid(self, rigid_name):
        """'{ref}_{mov}[_combo][_N]' naming with collision suffixing."""
        if rigid_name is None:
            if np.array_equal(self.combo_matrix, np.identity(4)):
                rigid_name = self.reference_name + "_" + self.moving_name
            else:
                rigid_name = (self.reference_name + "_" + self.moving_name
                              + "_combo")
            if rigid_name in Data.rigid_list:
                n = 1
                while f"{rigid_name}_{n}" in Data.rigid_list:
                    n += 1
                rigid_name = f"{rigid_name}_{n}"

        Data.rigid[rigid_name] = self
        Data.rigid_list += [rigid_name]
        return rigid_name

    def compute_aspect(self, slice_plane):
        """The display spacing ratio of a plane (JAX
        structure/rigid.py:243-251), on the resliced overlay's spacing."""
        if slice_plane == "Axial":
            return np.round(self.display.spacing[0]
                            / self.display.spacing[1], 2)
        if slice_plane == "Coronal":
            return np.round(self.display.spacing[0]
                            / self.display.spacing[2], 2)
        return np.round(self.display.spacing[1]
                        / self.display.spacing[2], 2)

    def compute_intensity(self, levels=None, **kwargs):
        """Intensity-based registration on the device (the card when
        present). ``mode``/``metric``/``pose0``/``normalize`` pass through
        to models.rigid_intensity.register_rigid_intensity; the fitted
        matrix lands in ``self.matrix``."""
        from ..models.rigid_intensity import register_rigid_intensity
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        if levels is not None:
            kwargs["levels"] = levels
        kwargs.setdefault("device", self.device)
        matrix, info = register_rigid_intensity(ref, mov, **kwargs)
        self.matrix = matrix
        self.misc["intensity_info"] = {
            "loss": info["loss"], "pose": info["pose"].tolist()}
        self.update_rois()
        return info

    def create_image(self):
        """Moving volume resliced onto an identity-direction grid with the
        reference's spacing, background -3001 (the CUDA warp kernel's
        ``affine`` mode on the card)."""
        return reslice_transform(*self._reslice_args())

    def _reslice_args(self):
        """The arguments of ``create_image``'s reslice, which the view's
        overlay shares (``reslice_tensor``)."""
        if self.inverse:
            ref = self.moving_name
            mov = self.reference_name
        else:
            ref = self.reference_name
            mov = self.moving_name

        matrix = self.matrix @ self.combo_matrix
        T = np.linalg.inv(matrix) if self.inverse else matrix

        mov_img = Data.image[mov]
        return (mov_img.array, mov_img.matrix, mov_img.spacing,
                mov_img.origin, T, Data.image[ref].spacing,
                config.background_fill, self.device)

    def pre_alignment(self, superior=False, center=False, origin=False):
        """Rapid programmatic initializations of the translation
        (reference structure/rigid.py:763-785, which implements only
        ``origin``; the JAX package implements all three):

        - ``superior``: match the cranial (max physical z) bounds, with
          x/y centered;
        - ``center``: match the 3D volume centers;
        - ``origin``: match the voxel-(0,0,0) origins.

        The matrix maps reference -> moving physical space, so the
        translation is always (moving landmark - reference landmark)."""
        ref_img = Data.image[self.reference_name]
        mov_img = Data.image[self.moving_name]
        if superior:
            ref_c = np.asarray(ref_img.compute_center(), np.float64)
            mov_c = np.asarray(mov_img.compute_center(), np.float64)
            ref_b = ref_img.compute_bounds()
            mov_b = mov_img.compute_bounds()
            self.matrix[:3, 3] = [mov_c[0] - ref_c[0],
                                  mov_c[1] - ref_c[1],
                                  mov_b[5] - ref_b[5]]
        elif center:
            ref_c = np.asarray(ref_img.compute_center(), np.float64)
            mov_c = np.asarray(mov_img.compute_center(), np.float64)
            self.matrix[:3, 3] = mov_c - ref_c
        elif origin:
            self.matrix[:3, 3] = (mov_img.origin - ref_img.origin)

    # -- queries ----------------------------------------------------------
    def retrieve_angles(self, order="ZXY"):
        rotation = Rotation.from_matrix(self.matrix[:3, :3])
        return rotation.as_euler(order, degrees=True)

    @trace("mia.view.plane")
    def retrieve_array_plane(self, slice_plane, solo=None, position=None):
        if self.display.shape is None:
            self.display.compute_reslice()
            self.display.compute_scroll_max()
        if solo is None:
            self.display.compute_slice_location(position=position)
        return self.display.compute_array_slice(slice_plane=slice_plane)

    def retrieve_center(self):
        image_name = self.moving_name if self.inverse \
            else self.reference_name
        original_center = Data.image[image_name].compute_center()
        center_h = np.array([original_center[0], original_center[1],
                             original_center[2], 1.0])
        return (self.matrix @ self.combo_matrix @ center_h)[:3]

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

    def retrieve_translation(self):
        return self.matrix[:3, 3]

    def retrieve_slice(self, slice_plane):
        return self.display.compute_slice(slice_plane)

    retrieve_vtk_slice = retrieve_slice

    # -- interactive updates ----------------------------------------------
    def update_rotation(self, center=None, r_x=0, r_y=0, r_z=0):
        """Rotate-about-center composition T_pos @ R @ T_neg @ matrix
        (reference structure/rigid.py:1001-1038), then the view's
        reslice."""
        if center is None:
            center = self.retrieve_center()

        R_mat = Rotation.from_euler("xyz", [r_x, r_y, r_z],
                                    degrees=True).as_matrix()
        R = np.identity(4)
        R[:3, :3] = R_mat
        T_neg = np.identity(4)
        T_neg[:3, 3] = -np.array(center)
        T_pos = np.identity(4)
        T_pos[:3, 3] = np.array(center)

        self.matrix = (T_pos @ R @ T_neg) @ self.matrix
        self.display.compute_reslice()
        self.display.compute_scroll_max()
        self.update_rois()

    def update_translation(self, t_x=0, t_y=0, t_z=0):
        """(reference structure/rigid.py:1040-1070): the view's origin
        moves; no reslice."""
        T = np.identity(4)
        T[0, 3] = t_x
        T[1, 3] = t_y
        T[2, 3] = t_z
        self.matrix = self.matrix @ T

        if self.display.origin is not None:
            self.display.origin[0] -= t_x
            self.display.origin[1] -= t_y
            self.display.origin[2] -= t_z
            self.display.compute_offset()
            self.display.compute_scroll_max()
        self.update_rois()

    def update_rois(self, roi_name=None):
        """Sync the ROI key-set with Data.roi_list; transform each visible
        moving-image ROI mesh into the reference frame (reference
        structure/rigid.py:1072-1101)."""
        for name in list(self.rois.keys()):
            if name not in Data.roi_list:
                del self.rois[name]
        for name in Data.roi_list:
            if name not in self.rois:
                self.rois[name] = None

        moving = Data.image.get(self.moving_name)
        for name in Data.roi_list:
            if (roi_name is None or name == roi_name) and moving is not None:
                roi = moving.rois.get(name)
                if roi is not None and roi.mesh is not None and roi.visible:
                    if self.inverse:
                        self.rois[name] = roi.mesh.transform(
                            self.matrix @ self.combo_matrix, inplace=False)
                    else:
                        self.rois[name] = roi.mesh.transform(
                            np.linalg.inv(self.matrix @ self.combo_matrix),
                            inplace=False)

    def copy_roi(self, roi_name=None):
        """Project an ROI mesh across the registration
        (reference structure/rigid.py:668-690)."""
        if roi_name in self.rois:
            reference_roi = Data.image[self.reference_name].rois[roi_name]
            moving_roi = Data.image[self.moving_name].rois[roi_name]
            if self.inverse and self.rois[roi_name] is not None:
                reference_roi.mesh = self.rois[roi_name].transform(
                    np.linalg.inv(self.matrix @ self.combo_matrix),
                    inplace=False)
            elif reference_roi.mesh is not None:
                moving_roi.mesh = reference_roi.mesh.transform(
                    self.matrix @ self.combo_matrix, inplace=False)
                self.update_rois(roi_name=roi_name)

    def update_pois(self, poi_name=None):
        """Transform the moving image's POIs into the reference frame, with
        the matrix of update_rois (``inverse`` included). Returns {name:
        (3,) mm} and caches it on ``self.pois``."""
        if self.moving_name is None \
                or self.moving_name not in Data.image:
            return {}
        T = self.matrix @ self.combo_matrix
        if not self.inverse:
            T = np.linalg.inv(T)
        out = {}
        for name, poi in Data.image[self.moving_name].pois.items():
            if poi_name is not None and name != poi_name:
                continue
            if poi.point_position is None:
                continue
            p = np.asarray(poi.point_position, np.float64)
            out[name] = (T @ np.append(p, 1.0))[:3]
        if poi_name is None or not hasattr(self, "pois"):
            self.pois = out
        else:
            self.pois.update(out)
        return out

    # -- registration drivers (JAX structure/rigid.py:254-531) ----------
    def _center_image_correction(self, R_icp):
        """`center='image'` recentering math
        (reference structure/rigid.py:574-595)."""
        R_icp = np.asarray(R_icp, dtype=float)
        old_center = np.array([0, 0, 0], dtype=float)
        new_center = np.array(
            Data.image[self.moving_name].compute_center(), dtype=float)

        T_neg = np.eye(4)
        T_neg[:3, 3] = -new_center
        T_pos = np.eye(4)
        T_pos[:3, 3] = new_center

        extra_rotation = np.eye(4)
        old_h = np.hstack([old_center, 1])
        new_h = np.hstack([new_center, 1])
        R_total = extra_rotation @ R_icp
        correction = (old_h - R_total @ old_h) - (new_h - R_total @ new_h)
        T_corr = np.eye(4)
        T_corr[:3, 3] = correction[:3]
        return T_pos @ extra_rotation @ R_icp @ T_neg @ T_corr

    def compute_icp_vtk(self, source_mesh, target_mesh, distance=1e-5,
                        iterations=1000, landmarks=None, com_matching=True,
                        inverse=False, center=None):
        """Mesh ICP, VTK-variant controls
        (reference structure/rigid.py:536-600), on the device."""
        from ..utils.rigid.icp import ICP

        self.inverse = inverse
        if self.inverse:
            target_mesh.transform(self.matrix @ self.combo_matrix,
                                  inplace=True)
        else:
            target_mesh.transform(
                np.linalg.inv(self.matrix @ self.combo_matrix),
                inplace=True)

        icp = ICP(source_mesh, target_mesh, device=self.device)
        icp.compute_vtk(distance=distance, iterations=iterations,
                        landmarks=landmarks, com_matching=com_matching,
                        inverse=inverse)
        self.misc["icp_info"] = icp.info
        if center == "image":
            self.matrix = self._center_image_correction(icp.get_matrix())
        else:
            self.matrix = icp.get_matrix()
        self.update_rois()

    def compute_o3d(self, source_mesh, target_mesh, distance=10,
                    iterations=1000, rmse=1e-7, fitness=1e-7,
                    method="point", com_matching=True, inverse=False,
                    center=None):
        """Mesh ICP, Open3D-variant controls
        (reference structure/rigid.py:602-666), on the device."""
        from ..utils.rigid.icp import ICP

        target_mesh.transform(self.matrix @ self.combo_matrix,
                              inplace=True)

        icp = ICP(source_mesh, target_mesh, device=self.device)
        icp.compute_o3d(distance=distance, iterations=iterations,
                        rmse=rmse, fitness=fitness, method=method,
                        com_matching=com_matching, inverse=inverse)
        self.misc["icp_info"] = icp.info
        if center == "image":
            self.matrix = self._center_image_correction(icp.get_matrix())
        else:
            self.matrix = icp.get_matrix()
        self.update_rois()

    def auto_register(self, metric=None, mode="rigid",
                      use_phase_correlation=True, **kwargs):
        """One-call capture-range-robust registration ladder:

        1. ``pre_alignment(center=True)`` volume-center matching (only
           when the matrix is still identity, so a prior pose is kept),
        2. ``compute_phase_correlation()`` FFT translation on the device,
        3. ``compute_intensity`` multi-resolution descent warm-started
           from the recovered pose (``pose0``; a non-rigid current
           matrix is reduced to its nearest rotation, with a warning).

        ``metric`` defaults to 'mse' for same-modality pairs and 'mi'
        across modalities; ``mode`` / ``levels`` / ... forward to
        compute_intensity. Assumes an identity ``combo_matrix``. Returns
        the intensity info dict; each stage's result and seconds land in
        ``misc['auto_register']``."""
        import time
        import warnings

        from ..models.rigid_intensity import _MODE_NPARAMS

        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        if metric is None:
            metric = "mse" if ref.modality == mov.modality else "mi"

        stages, seconds = {}, {}
        t0 = time.perf_counter()
        if np.allclose(self.matrix, np.eye(4)):
            self.pre_alignment(center=True)
            stages["center"] = [float(v) for v in self.matrix[:3, 3]]
        seconds["center"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if use_phase_correlation:
            stages["phase_correlation"] = \
                self.compute_phase_correlation()
        seconds["phase_correlation"] = time.perf_counter() - t0

        n_params = _MODE_NPARAMS[mode]
        pose0 = np.zeros(n_params, np.float32)
        M = np.asarray(self.matrix, np.float64)
        R = M[:3, :3]
        if not np.allclose(R @ R.T, np.eye(3), atol=1e-5):
            # a prior affine / scaled fit left a non-rigid block:
            # warm-start from the nearest rotation (polar decomposition)
            # instead of discarding the accumulated pose
            U, _, Vt = np.linalg.svd(R)
            R = U @ Vt
            if np.linalg.det(R) < 0:
                R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
            warnings.warn(
                "auto_register: current matrix is not rigid; the "
                "scale/shear part was dropped from the descent warm "
                "start (nearest rotation kept)", UserWarning,
                stacklevel=2)
        # matrix = pose_to_matrix(pose, center) inverts to
        # angles('xyz' extrinsic = Rz@Ry@Rx) and t = m[:3,3] - c + R c
        pose0[:3] = Rotation.from_matrix(R).as_euler("xyz")
        center = np.asarray(ref.compute_center(), np.float64)
        pose0[3:6] = M[:3, 3] - center + R @ center
        t0 = time.perf_counter()
        info = self.compute_intensity(metric=metric, mode=mode,
                                      pose0=pose0, **kwargs)
        seconds["intensity"] = time.perf_counter() - t0
        stages["metric"] = metric
        stages["seconds"] = seconds
        self.misc["auto_register"] = stages
        return info

    def compute_landmarks(self, poi_names=None, points_reference=None,
                          points_moving=None, scaling=False):
        """Rigid landmark (fiducial) registration: the closed-form
        Kabsch / Umeyama solve over matched POIs, in host float64.

        Matches POI names shared by the reference and moving images (or
        explicit (N, 3) mm arrays, N >= 3 non-collinear). Solves
        min sum ||s R p_ref + t - p_mov||^2 (s = 1 unless ``scaling``)
        and stores the map so that ``matrix @ combo_matrix`` takes
        reference physical points to moving physical points. Returns
        {name: residual mm} fiducial registration errors."""
        if points_reference is not None or points_moving is not None:
            if points_reference is None or points_moving is None:
                raise ValueError(
                    "compute_landmarks: points_reference and "
                    "points_moving must be given together")
            t_pts = np.asarray(points_reference, np.float64).reshape(-1, 3)
            m_pts = np.asarray(points_moving, np.float64).reshape(-1, 3)
            if t_pts.shape != m_pts.shape:
                raise ValueError(
                    "compute_landmarks: point array shapes differ")
            names = [str(i) for i in range(t_pts.shape[0])]
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
            if len(names) < 3:
                raise ValueError(
                    f"compute_landmarks: need >= 3 matched POIs, found "
                    f"{len(names)}")
            t_pts = np.stack(t_list)
            m_pts = np.stack(m_list)

        # Umeyama: centered cross-covariance SVD with det correction
        mu_t = t_pts.mean(axis=0)
        mu_m = m_pts.mean(axis=0)
        tc = t_pts - mu_t
        mc = m_pts - mu_m
        cov = mc.T @ tc / t_pts.shape[0]
        U, S, Vt = np.linalg.svd(cov)
        d = np.sign(np.linalg.det(U @ Vt))
        D = np.diag([1.0, 1.0, d])
        R = U @ D @ Vt
        if scaling:
            var_t = (tc ** 2).sum() / t_pts.shape[0]
            s = float((S * np.diag(D)).sum() / max(var_t, 1e-12))
        else:
            s = 1.0
        F = np.eye(4)
        F[:3, :3] = s * R
        F[:3, 3] = mu_m - s * R @ mu_t
        # store so matrix @ combo_matrix == F (class convention)
        self.matrix = F @ np.linalg.inv(np.asarray(self.combo_matrix,
                                                   np.float64))
        self.update_rois()
        mapped = (t_pts @ (s * R).T) + F[:3, 3]
        residuals = {n: float(np.linalg.norm(mapped[i] - m_pts[i]))
                     for i, n in enumerate(names)}
        self.misc["landmark_fre"] = residuals
        return residuals

    def compute_phase_correlation(self, window=True, update=True):
        """Global translation initialization by FFT phase correlation.
        The moving volume is resliced onto the reference grid through
        the CURRENT ``matrix @ combo_matrix`` (the warp kernel's
        ``affine`` mode on the card), the residual translation comes from
        the normalized cross-power spectrum on the device
        (ops/registration/phase_correlation), and the matrix is
        post-composed with it. Recovers any shift up to half the field
        of view.

        Returns {'shift_mm': (x, y, z) physical shift applied,
        'response': normalized peak in [0, 1]}. ``update=False``
        estimates without touching the matrix.
        """
        from ..device import default_device
        from ..ops.registration.phase_correlation import phase_correlation
        from ..ops.resample import affine_resample, compose_pixel_matrix
        from ..ops.volume import stored_to_float

        device = default_device() if self.device is None \
            else torch.device(self.device)
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        T = np.asarray(self.matrix @ self.combo_matrix, np.float64)
        A = compose_pixel_matrix(mov.matrix, mov.spacing, mov.origin,
                                 ref.matrix, ref.spacing, ref.origin,
                                 phys_transform=T)
        mov_arr = stored_to_float(np.asarray(mov.array), device)
        resliced = affine_resample(
            mov_arr, A, tuple(ref.array.shape),
            background=float(mov_arr.mean(dtype=torch.float64)))
        shift_zyx, response = phase_correlation(
            stored_to_float(np.asarray(ref.array), device), resliced,
            spacing_xyz=ref.spacing, window=window)
        # resliced(p) = ref(p - d) in ref PIXEL-axis mm; physical
        # shift = sum_i d_i * matrix_row_i; T'q = T(q + d) composes a
        # pre-translation in reference physical space
        d_xyz = shift_zyx[::-1]
        s_phys = np.asarray(ref.matrix, np.float64).T @ d_xyz
        info = {"shift_mm": tuple(float(v) for v in s_phys),
                "response": response}
        if update:
            Tr = np.eye(4)
            Tr[:3, 3] = s_phys
            combo = np.asarray(self.combo_matrix, np.float64)
            self.matrix = np.asarray(self.matrix, np.float64) \
                @ combo @ Tr @ np.linalg.inv(combo)
            self.misc["phase_correlation"] = info
            self.update_rois()
        return info

    # -- export and persistence (JAX structure/rigid.py:568-637, 735-768) --
    def export_image(self, path=None):
        """Write ``create_image`` (the ``affine`` launch) as MHD."""
        if self.moving_name is not None and path is not None:
            out = self.create_image()
            from ..read.mhd import write_mhd_volume
            write_mhd_volume(path, out["array"], spacing=out["spacing"],
                             origin=out["origin"])

    def create_reg(self, path=None):
        """A DICOM Spatial Registration (REG) dataset of this rigid: two
        ReferencedSeriesSequence items (reference, moving) and a
        RegistrationSequence of [identity, inv(matrix)] (ReadREG inverts
        back), each typed RIGID, RIGID_SCALE or AFFINE. Returns the
        Dataset; writes a Part-10 file when ``path`` is given."""
        from ..dicom import Dataset, Sequence, dcmwrite, uids
        from .common import build_reg_dataset

        if self.reference_name not in Data.image \
                or self.moving_name not in Data.image:
            raise ValueError(
                "create_reg: reference and moving images must both be "
                "loaded to reference their series/SOPs")
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        ds = build_reg_dataset(uids.SpatialRegistrationStorage, ref,
                               mov, self.rigid_name)

        def reg_item(m, frame_ref):
            mat_item = Dataset()
            mat_item.FrameOfReferenceTransformationMatrix = [
                float(v) for v in np.asarray(m, np.float64).reshape(-1)]
            mat_item.FrameOfReferenceTransformationMatrixType = \
                matrix_type(m)
            mreg = Dataset()
            mreg.MatrixSequence = Sequence([mat_item])
            item = Dataset()
            item.FrameOfReferenceUID = frame_ref
            item.MatrixRegistrationSequence = Sequence([mreg])
            return item

        ds.RegistrationSequence = Sequence(
            [reg_item(np.eye(4), ref.frame_ref),
             reg_item(np.linalg.inv(np.asarray(self.matrix, np.float64)),
                      mov.frame_ref)])
        if path is not None:
            dcmwrite(path, ds)
        return ds

    def save_rigid(self, path):
        """``{path}/rigid.json``: names, matrices, inverse flag and
        rotation center."""
        payload = {
            "reference_name": self.reference_name,
            "moving_name": self.moving_name,
            "rigid_name": self.rigid_name,
            "combo_name": self.combo_name,
            "roi_names": list(self.roi_names),
            "matrix": np.asarray(self.matrix).tolist(),
            "reference_matrix": np.asarray(self.reference_matrix).tolist(),
            "combo_matrix": np.asarray(self.combo_matrix).tolist(),
            "inverse": bool(self.inverse),
            "rotation_center": np.asarray(self.rotation_center).tolist(),
        }
        os.makedirs(str(path), exist_ok=True)
        with open(os.path.join(str(path), "rigid.json"), "w") as f:
            json.dump(payload, f, indent=1)

    @classmethod
    def load_rigid(cls, path, device=None):
        """A :meth:`save_rigid` folder back into ``Data.rigid``; its
        reslices run on ``device`` (default: the card)."""
        from ..device import default_device

        device = default_device() if device is None else device
        with open(os.path.join(str(path), "rigid.json")) as f:
            payload = json.load(f)
        rigid = cls(payload["reference_name"], payload["moving_name"],
                    rigid_name=payload["rigid_name"],
                    roi_names=payload["roi_names"],
                    matrix=np.asarray(payload["matrix"]),
                    reference_matrix=np.asarray(
                        payload["reference_matrix"]),
                    combo_matrix=np.asarray(payload["combo_matrix"]),
                    combo_name=payload["combo_name"], device=device)
        rigid.inverse = payload["inverse"]
        rigid.rotation_center = np.asarray(payload["rotation_center"])
        return rigid


def matrix_type(m):
    """PS3.3 C.20.2 typing of a 4x4 matrix: RIGID for an orthonormal
    rotation block, RIGID_SCALE for a uniformly scaled one, else AFFINE
    (JAX structure/rigid.py:594-608, ``_matrix_type``)."""
    R = np.asarray(m, np.float64)[:3, :3]
    RtR = R.T @ R
    if np.allclose(RtR, np.eye(3), atol=1e-5):
        return "RIGID"
    d = np.diag(RtR)
    if np.allclose(RtR, np.diag(d), atol=1e-5) \
            and np.allclose(d, d[0], atol=1e-5):
        return "RIGID_SCALE"
    return "AFFINE"
