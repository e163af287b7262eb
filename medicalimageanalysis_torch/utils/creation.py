"""Synthetic DICOM series writer.

Carried over from medicalimageanalysis_tpu/utils/creation.py
(``CreateDicomImage``), on top of the port's copy of the DICOM writer
(``dicom.dcmwrite``). Writes test and smoke fixtures; the in-memory image
builders wait for a later slice.
"""

from __future__ import annotations

import datetime
import os

import numpy as np

from ..dicom import Dataset, FileMetaDataset, dcmwrite, generate_uid, uids
from ..dicom.dictionary import keyword_to_tag

__all__ = ["CreateDicomImage"]


class CreateDicomImage(object):
    """Write a synthetic .dcm slice series from a (Z, Y, X) array
    (reference utils/creation.py:30-229)."""

    def __init__(self, output_dir, data, study=None, series=None, frame=None,
                 origin=None, spacing=None, thickness=None,
                 transfer_syntax=None):
        self.output_dir = output_dir
        self.data = data
        self.study = study
        self.series = series
        self.frame = frame
        self.origin = origin
        self.spacing = spacing
        self.thickness = thickness
        # beyond-parity: a compressed target (RLELossless /
        # JPEGLSLossless) auto-encodes each slice via dcmwrite
        self.transfer_syntax = transfer_syntax

        self.orientation = [1, 0, 0, 0, 1, 0]

    def set_study(self, study):
        self.study = study

    def set_series(self, series):
        self.series = series

    def set_frame(self, frame):
        self.frame = frame

    def set_origin(self, origin):
        self.origin = origin

    def set_spacing(self, spacing):
        self.spacing = spacing

    def set_thickness(self, thickness):
        self.thickness = thickness

    def run(self, patient_name="Test", patient_id="Test", modality="CT",
            description="", sex="M", rescale_slope=1,
            rescale_intercept=0, extra_tags=None, instance_offset=0):
        """Write each slice as an individual Explicit VR LE file.

        ``rescale_slope``/``rescale_intercept`` and ``extra_tags``
        ({keyword: value} applied to every slice) are beyond-parity
        knobs for fabricating modality-specific fixtures (e.g. PT with
        RadiopharmaceuticalInformationSequence for SUV tests).
        ``instance_offset`` shifts InstanceNumber and the SOP suffix so
        multiple ``run`` calls can extend ONE series without UID
        collisions (e.g. 4D phase fixtures sharing a SeriesInstanceUID)."""
        if self.study is None:
            self.study = generate_uid()
        if self.series is None:
            self.series = generate_uid()
        if self.frame is None:
            self.frame = generate_uid()
        if self.origin is None:
            self.origin = [0, 0, 0]
        if self.spacing is None:
            self.spacing = [1, 1]
        if self.thickness is None:
            self.thickness = 1

        sop_class = uids.MODALITY_SOP_CLASS.get(modality,
                                                uids.CTImageStorage)
        # unique per-series SOP base (the reference hardcodes
        # str(10000+ii), utils/creation.py:186, which collides across
        # series and breaks REG/RTSTRUCT matching)
        self.sops = [f"{self.series}.{instance_offset + ii}"
                     for ii in range(self.data.shape[0])]
        today = str(datetime.date.today()).replace("-", "")
        os.makedirs(str(self.output_dir), exist_ok=True)

        for ii in range(self.data.shape[0]):
            array = self.data[ii, :, :]

            ds = Dataset()
            fm = FileMetaDataset()
            fm.add(0x00020002, "UI", sop_class)
            fm.add(0x00020003, "UI", self.sops[ii])
            fm.add(0x00020010, "UI", uids.ExplicitVRLittleEndian)
            fm.add(0x00020012, "UI", generate_uid())
            ds.file_meta = fm

            ds.PatientName = patient_name
            ds.PatientSex = sex
            ds.SeriesDescription = description
            ds.PatientID = patient_id
            ds.Modality = modality
            ds.StudyDate = today
            ds.ContentDate = today
            ds.StudyTime = str(10)
            ds.ContentTime = str(10)
            ds.StudyInstanceUID = self.study
            ds.SeriesInstanceUID = self.series
            ds.SOPInstanceUID = self.sops[ii]
            ds.SOPClassUID = sop_class
            ds.StudyID = "100"

            ds.FrameOfReferenceUID = self.frame
            ds.AcquisitionNumber = "1"
            ds.SeriesNumber = "2"
            ds.InstanceNumber = str(instance_offset + ii + 1)
            ds.ImageOrientationPatient = self.orientation
            # self.spacing follows the package [sx, sy] convention;
            # DICOM PixelSpacing is [row = sy, col = sx] (previously
            # written verbatim — invisible for the isotropic fixtures
            # but in-plane-swapped for anisotropic grids)
            ds.PixelSpacing = [self.spacing[1], self.spacing[0]]
            ds.SliceThickness = self.thickness
            # slices step along the orientation normal (identical to
            # the old +z stepping for the axial default; non-axial
            # orientations previously produced degenerate geometry —
            # coplanar in-plane axis vs position step)
            normal = np.cross(np.asarray(self.orientation[:3], float),
                              np.asarray(self.orientation[3:6], float))
            pos = (np.asarray(self.origin[:3], float)
                   + ii * float(self.thickness) * normal)
            ds.ImagePositionPatient = [float(v) for v in pos]

            ds.SamplesPerPixel = 1
            ds.PhotometricInterpretation = "MONOCHROME2"
            ds.PixelRepresentation = 1
            ds.HighBit = 15
            ds.BitsStored = 16
            ds.BitsAllocated = 16
            ds.Columns = array.shape[1]
            ds.Rows = array.shape[0]
            ds.RescaleIntercept = rescale_intercept
            ds.RescaleSlope = rescale_slope
            for keyword, value in (extra_tags or {}).items():
                if keyword_to_tag(keyword) is None:
                    # Dataset.__setattr__ would fall through to a
                    # plain attribute and dcmwrite would silently
                    # drop it — fail loudly instead
                    raise ValueError(
                        f"extra_tags: {keyword!r} is not a known "
                        "DICOM keyword (dicom/dictionary.py)")
                setattr(ds, keyword, value)
            ds.PixelData = np.ascontiguousarray(
                array.astype("<i2")).tobytes()

            export_file = os.path.join(str(self.output_dir),
                                       str(instance_offset + ii) + ".dcm")
            dcmwrite(export_file, ds,
                     transfer_syntax=self.transfer_syntax)
