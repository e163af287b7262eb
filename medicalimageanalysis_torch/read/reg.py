"""DICOM Spatial Registration (REG) reader.

Port of medicalimageanalysis_tpu/read/reg.py (``ReadREG``, :23-149): the
rigid matrix from RegistrationSequence[1] -> MatrixSequence (3006,00C6),
inverted into the moving matrix; a deformable REG's VectorGridData as a
(Z, Y, X, 3) point-displacement field with PreDeformationMatrix as the
rigid pre-transform. The field bytes are read with ``np.frombuffer``
(the same float32 values the JAX package's ``struct.unpack`` gives, with
no Python tuple in between) and uploaded to ``device`` once, through
pinned memory; the Deformable keeps that tensor as its field.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import Data
from ..structure.deformable import Deformable
from ..structure.rigid import Rigid

__all__ = ["ReadREG", "decode_vector_grid"]


def decode_vector_grid(raw, dimensions_zyx, device):
    """VectorGridData (float32 little-endian, x fastest, three components
    a point) -> (Z, Y, X, 3) float32 tensor on ``device``: one view of the
    bytes, one upload (from pinned memory to the card)."""
    shape = [int(v) for v in dimensions_zyx] + [3]
    values = np.frombuffer(raw, dtype="<f4", count=int(np.prod(shape)))
    host = torch.empty(shape, dtype=torch.float32,
                       pin_memory=device.type == "cuda")
    host.numpy()[...] = values.reshape(shape)
    return host.to(device, non_blocking=True)


class ReadREG(object):
    def __init__(self, image_set, only_tags, device=None):
        from ..device import default_device

        self.image_set = image_set if isinstance(image_set, list) \
            else [image_set]
        self.only_tags = only_tags
        self.device = default_device() if device is None \
            else torch.device(device)

        ds = self.image_set[0]
        self.reference_name = None
        self.reference_series = \
            ds.ReferencedSeriesSequence[0].SeriesInstanceUID
        self.reference_sops = [
            sop.ReferencedSOPInstanceUID for sop in
            ds.ReferencedSeriesSequence[0].ReferencedInstanceSequence]

        self.moving_name = None
        if len(ds.ReferencedSeriesSequence) == 2:
            self.moving_series = \
                ds.ReferencedSeriesSequence[1].SeriesInstanceUID
            self.moving_sops = [
                sop.ReferencedSOPInstanceUID for sop in
                ds.ReferencedSeriesSequence[1].ReferencedInstanceSequence]
        else:
            sequence = ds.StudiesContainingOtherReferencedInstancesSequence[
                0].ReferencedSeriesSequence[0]
            self.moving_series = sequence.SeriesInstanceUID
            self.moving_sops = [sop.ReferencedSOPInstanceUID for sop in
                                sequence.ReferencedInstanceSequence]

        self.spacing = None
        self.dimensions = None
        self.origin = None

        self.reference_matrix = None
        self.moving_matrix = None
        self.dvf_matrix = None
        self.dvf = None

        self.registration_name = None
        if "DeformableRegistrationSequence" in ds:
            self._compute_rigid(deformable=True)
            self._compute_dvf()
            self._create_name(deformable=True)
            self._create_registration(deformable=True)
        else:
            self._compute_rigid()
            self._create_name()
            self._create_registration()

    def _compute_rigid(self, deformable=False):
        """(reference read/dicom.py:1720-1764)."""
        ds = self.image_set[0]
        if deformable:
            matrix = ds.DeformableRegistrationSequence[0] \
                .PreDeformationMatrixRegistrationSequence[0][
                    (0x3006, 0x00C6)].value

            orientation = ds.DeformableRegistrationSequence[0] \
                .DeformableRegistrationGridSequence[0] \
                .ImageOrientationPatient
            from ..ops import geometry as geo
            self.dvf_matrix = geo.orientation_to_matrix(orientation)
            self.moving_matrix = np.linalg.inv(
                np.asarray(matrix).reshape(4, 4))
        else:
            matrix = ds.RegistrationSequence[1] \
                .MatrixRegistrationSequence[0] \
                .MatrixSequence[0][(0x3006, 0x00C6)].value
            self.reference_matrix = matrix
            self.moving_matrix = np.linalg.inv(
                np.asarray(matrix).reshape(4, 4))

    def _compute_dvf(self):
        """(reference read/dicom.py:1766-1786)."""
        grid = self.image_set[0].DeformableRegistrationSequence[0] \
            .DeformableRegistrationGridSequence[0]

        self.origin = grid.ImagePositionPatient
        self.dimensions = np.flip(grid.GridDimensions)
        self.spacing = grid.GridResolution

        self.dvf = decode_vector_grid(grid.VectorGridData, self.dimensions,
                                      self.device)
        del grid.VectorGridData

    def _create_name(self, deformable=False):
        """Name synthesis with collision suffixing
        (reference read/dicom.py:1788-1822)."""
        for image_name in Data.image_list:
            if self.reference_sops[0] in Data.image[image_name].sops:
                self.reference_name = image_name
            elif self.moving_sops[0] in Data.image[image_name].sops:
                self.moving_name = image_name

        prefix = "DVF_" if deformable else ""
        if self.reference_name is None and self.moving_name is None:
            base = prefix + "_Unknown"
        else:
            base = prefix + f"{self.reference_name}_{self.moving_name}"

        registry = Data.deformable_list if deformable else Data.rigid_list
        if base in registry:
            i = 1
            while f"{base}_{i}" in registry:
                i += 1
            self.registration_name = f"{base}_{i}"
        else:
            self.registration_name = base

    def _create_registration(self, deformable=False):
        """(reference read/dicom.py:1824-1853)."""
        if deformable:
            Deformable(self.dvf, self.origin, self.spacing,
                       self.dimensions, rigid_matrix=self.moving_matrix,
                       dvf_matrix=self.dvf_matrix,
                       registration_name=self.registration_name,
                       reference_name=self.reference_name,
                       moving_name=self.moving_name,
                       reference_sops=self.reference_sops,
                       moving_sops=self.moving_sops, device=self.device)
        elif self.reference_name and self.moving_name:
            Rigid(self.reference_name, self.moving_name,
                  rigid_name=self.registration_name,
                  reference_sops=self.reference_sops,
                  moving_sops=self.moving_sops,
                  reference_matrix=self.reference_matrix,
                  matrix=self.moving_matrix, device=self.device)
