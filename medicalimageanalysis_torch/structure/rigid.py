"""Rigid registration object.

Carried over from medicalimageanalysis_tpu/structure/rigid.py (``Rigid``:
registry naming :188-241, ``compute_intensity`` :321-339,
``create_image`` :548-566). The matrix semantics are identical:
``matrix @ combo_matrix`` maps reference -> moving physical space and
``inverse`` flips the roles. ICP, ROI transforms, the Display view state
and the exports wait for later slices.
"""

from __future__ import annotations

import numpy as np

from ..config import config
from ..data import Data
from ..dicom import generate_uid
from ..ops.resample import reslice_transform

__all__ = ["Rigid"]


class Rigid(object):
    """4x4 rigid registration between two registered images."""

    def __init__(self, reference_name, moving_name, rigid_name=None,
                 reference_matrix=None, matrix=None, combo_matrix=None,
                 device=None):
        self.reference_name = reference_name
        self.moving_name = moving_name
        self.rois = dict.fromkeys(Data.roi_list)
        self.local_uid = generate_uid()
        self.device = device

        self.reference_matrix = np.identity(4) if reference_matrix is None \
            else reference_matrix
        self.matrix = np.identity(4) if matrix is None else matrix
        self.combo_matrix = np.identity(4) if combo_matrix is None \
            else combo_matrix

        self.inverse = False
        self.misc = {}
        self.rigid_name = self.add_rigid(rigid_name)
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
        if self.inverse:
            ref = self.moving_name
            mov = self.reference_name
        else:
            ref = self.reference_name
            mov = self.moving_name

        matrix = self.matrix @ self.combo_matrix
        T = np.linalg.inv(matrix) if self.inverse else matrix

        mov_img = Data.image[mov]
        return reslice_transform(
            mov_img.array, mov_img.matrix, mov_img.spacing, mov_img.origin,
            T, Data.image[ref].spacing,
            background=config.background_fill, device=self.device)

    def update_rois(self, roi_name=None):
        """Sync the ROI key-set with Data.roi_list. Transforming a visible
        moving ROI's mesh waits for the mesh slice and raises; the port's
        ROIs carry no meshes yet."""
        for name in list(self.rois.keys()):
            if name not in Data.roi_list:
                del self.rois[name]
        for name in Data.roi_list:
            if name not in self.rois:
                self.rois[name] = None
            roi = Data.image[self.moving_name].rois.get(name) \
                if self.moving_name in Data.image else None
            if (roi_name is None or name == roi_name) and roi is not None \
                    and roi.mesh is not None and roi.visible:
                raise NotImplementedError(
                    "Rigid.update_rois: transforming ROI meshes is not "
                    "ported yet (ROADMAP.md queue 1, item 9, mesh)")
