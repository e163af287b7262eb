"""Synthetic DICOM series writer and in-memory image builder.

Carried over from medicalimageanalysis_tpu/utils/creation.py
(``CreateDicomImage``, ``CreateImageFromMask``), on top of the port's
copy of the DICOM object model and writer (``dicom``). Writes test and
smoke fixtures and registers computed volumes as Images;
``image_from_saved`` rebuilds an Image from an ``Image.save_image``
folder.
"""

from __future__ import annotations

import copy
import datetime
import json
import os

import numpy as np

from ..data import Data
from ..dicom import Dataset, FileMetaDataset, dcmwrite, generate_uid, uids
from ..dicom.dictionary import keyword_to_tag
from ..ops import geometry as geo

__all__ = ["CreateDicomImage", "CreateImageFromMask", "image_from_saved"]


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


class CreateImageFromMask(object):
    """Fabricate in-memory datasets + geometry for an array so it can
    become an Image (reference utils/creation.py:232-423; JAX
    utils/creation.py:175-300). ``utils.fourd.combine_phases`` registers
    its combined volume through it."""

    def __init__(self, array, origin, spacing, image_name, dimensions=None,
                 orientation=None, plane="Axial",
                 description="Mask to Image", modality="CT"):
        self.rois = {}
        self.pois = {}

        self.array = array
        self.spacing = spacing
        self.origin = origin

        self.image_name = image_name

        now = datetime.datetime.now()
        self.date = str(now.year) + str(now.month) + str(now.day)
        if len(str(now.second)) == 1:
            self.time = str(now.hour) + "0" + str(now.second) + "00"
        else:
            self.time = str(now.hour) + str(now.second) + "00"
        self.birthdate = self.date

        self.filepaths = None

        self.plane = plane
        self.dimensions = array.shape if dimensions is None else dimensions
        self.orientation = [1, 0, 0, 0, 1, 0] if orientation is None \
            else orientation

        self.image_matrix = geo.orientation_to_matrix(self.orientation)

        self.camera_position = None
        self.unverified = None
        self.skipped_slice = None
        self.sections = None
        self.rgb = False

        self.sops = [generate_uid() for _ in range(self.dimensions[0])]
        self.slice_location = [int(self.dimensions[0] / 2),
                               int(self.dimensions[1] / 2),
                               int(self.dimensions[2] / 2)]

        self.study_uid = generate_uid()
        self.series_uid = generate_uid()
        self.frame_ref = generate_uid()
        self.acq_number = "1"
        self.window = [0, 1]
        self.modality = modality
        sop_class = generate_uid()

        dicoms = []
        for ii in range(self.dimensions[0]):
            ds = Dataset()
            fm = FileMetaDataset()
            fm.add(0x00020002, "UI", sop_class)
            fm.add(0x00020003, "UI", str(self.sops[ii]))
            fm.add(0x00020010, "UI", uids.ExplicitVRLittleEndian)
            fm.add(0x00020012, "UI", "1.2.3.4")
            ds.file_meta = fm

            ds.PatientName = "User^Created^ ^"
            ds.PatientSex = "M"
            ds.SeriesDescription = description
            ds.PatientID = "User^Created^ ^"
            ds.Modality = modality
            ds.StudyDate = self.date
            ds.ContentDate = self.date
            ds.StudyTime = self.time
            ds.ContentTime = self.time
            ds.StudyInstanceUID = self.study_uid
            ds.SeriesInstanceUID = self.series_uid
            ds.SOPInstanceUID = str(self.sops[ii])
            ds.SOPClassUID = str(sop_class)
            ds.StudyID = "1"

            ds.FrameOfReferenceUID = self.frame_ref
            ds.AcquisitionNumber = self.acq_number
            ds.SeriesNumber = "1"
            ds.InstanceNumber = str(ii)
            ds.ImageOrientationPatient = list(self.orientation[:6])
            ds.PixelSpacing = list(spacing[:2])
            ds.SliceThickness = spacing[2]

            position = self.compute_position(ii)
            ds.ImagePositionPatient = [float(position[0]),
                                       float(position[1]),
                                       float(position[2])]

            ds.SamplesPerPixel = 1
            ds.PhotometricInterpretation = "MONOCHROME2"
            ds.PixelRepresentation = 1
            ds.HighBit = 15
            ds.BitsStored = 16
            ds.BitsAllocated = 16
            ds.Columns = array.shape[1]
            ds.Rows = array.shape[2]
            ds.RescaleIntercept = 0
            ds.RescaleSlope = 1

            dicoms.append(ds)

        self.image_set = dicoms

    def add_image(self):
        """Register the fabricated image into the global registry."""
        from ..structure.image import Image
        Data.image[self.image_name] = Image(self)
        Data.image_list += [self.image_name]

    def add_mesh_roi(self, mesh, roi_name):
        """Attach a mesh-backed ROI to the registered image."""
        image = Data.image[self.image_name]
        image.create_roi(name=roi_name, color=[0, 0, 255], visible=False,
                         filepath=None)
        image.rois[roi_name].mesh = mesh
        image.rois[roi_name].volume = mesh.volume
        image.rois[roi_name].com = mesh.center
        image.rois[roi_name].bounds = mesh.bounds

    def compute_position(self, z):
        matrix = copy.deepcopy(self.image_matrix)
        m = geo.pixel_to_position_matrix(matrix, self.spacing, self.origin)
        return geo.apply_homogeneous([0, 0, z], m)


def image_from_saved(image_path, rois=True, pois=True, device=None):
    """Rebuild and register an Image from an ``Image.save_image`` folder
    (JAX utils/creation.py:303-327), under its saved name. The image's
    compute runs on ``device`` (default: the card; without one, and
    without ``device='cpu'``, this raises first)."""
    from ..device import default_device

    device = default_device() if device is None else device
    base = str(image_path)
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    array_path = os.path.join(base, "array.npy")
    array = np.load(array_path) if os.path.exists(array_path) else None

    builder = CreateImageFromMask(
        array=array if array is not None else np.zeros((1, 1, 1), np.int16),
        origin=np.asarray(meta["origin"]), spacing=np.asarray(meta["spacing"]),
        image_name=meta["image_name"],
        dimensions=np.asarray(meta["dimensions"]),
        orientation=np.asarray(meta["orientation"]), plane=meta["plane"],
        modality=meta["modality"])
    builder.array = array
    builder.unverified = meta.get("unverified")
    builder.skipped_slice = meta.get("skipped_slice")
    builder.device = device
    builder.add_image()
    image = Data.image[meta["image_name"]]
    if rois and os.path.isdir(os.path.join(base, "rois")):
        image.load_rois(os.path.join(base, "rois"))
    if pois and os.path.isdir(os.path.join(base, "pois")):
        image.load_pois(os.path.join(base, "pois"))
    return image
