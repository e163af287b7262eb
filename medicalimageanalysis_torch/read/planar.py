"""2D/2.5D modality readers: DX/CR/MG (X-ray), RF/XA (fluoro), US.

Port of medicalimageanalysis_tpu/read/planar.py, itself a rebuild of
reference read/dicom.py:830-1386. Planar arrays are host numpy in the
port's ``Image``, as every Image's array is. The JAX package's
behaviour is kept as it is:
- ReadRF with a 2D frame reshapes per plane (the reference crashed,
  read/dicom.py:1157-1181);
- ReadRF/ReadUS with only_tags take their dimensions from
  Rows/Columns/NumberOfFrames;
- the PresentationLUTShape pivot compares against the string
  ``"Inverse"`` exactly, as the reference does
  (read/dicom.py:1012-1014), not the standard's ``"INVERSE"``.
"""

from __future__ import annotations

import numpy as np

from ..data import Data
from ..structure.image import Image
from .dicom import create_image_name

__all__ = ["ReadXRay", "ReadRF", "ReadUS"]


def _plane_from_patient_orientation(img):
    """L/R -> Coronal, A/P -> Sagittal, else Axial
    (reference read/dicom.py:914-935)."""
    if "PatientOrientation" in img:
        orient = img.PatientOrientation
        if "L" in orient or "R" in orient:
            return "Coronal"
        if "A" in orient or "P" in orient:
            return "Sagittal"
        return "Axial"
    return "Axial"


def _inplane_spacing(img, allow_imager=True, allow_us_regions=False):
    """Spacing fallback chain shared by the planar readers
    (reference read/dicom.py:967-1010, 1186-1224, 1344-1385)."""
    from ..dicom.dataset import value_or
    inplane = [1, 1]
    if value_or(img, "PixelSpacing", None) is not None:
        inplane = img.PixelSpacing
    elif allow_imager and value_or(img, "ImagerPixelSpacing",
                                   None) is not None:
        inplane = img.ImagerPixelSpacing
    elif "ContributingSourcesSequence" in img:
        seq = img.ContributingSourcesSequence[0]
        if "DetectorElementSpacing" in seq:
            inplane = seq.DetectorElementSpacing
    elif "PerFrameFunctionalGroupsSequence" in img:
        seq = img.PerFrameFunctionalGroupsSequence[0]
        if "PixelMeasuresSequence" in seq:
            inplane = seq.PixelMeasuresSequence[0].PixelSpacing
    elif allow_us_regions and "SequenceOfUltrasoundRegions" in img:
        region = img.SequenceOfUltrasoundRegions[0]
        if "PhysicalDeltaX" in region:
            inplane = [10 * np.round(region.PhysicalDeltaY, 4),
                       10 * np.round(region.PhysicalDeltaX, 4)]
    return inplane


def _cast_stored(img, arr):
    """int16 unless unsigned stored values can exceed it (16-bit FFDM,
    uint16 counts...). REFERENCE BUG FIXED: the reference's blanket
    astype('int16') (read/dicom.py:1009, 1153) wraps pixels above
    32767 to negative values."""
    bits = int(img.get("BitsStored", img.get("BitsAllocated", 16)) or 16)
    unsigned = int(img.get("PixelRepresentation", 0) or 0) == 0
    if unsigned and bits > 15:
        return np.asarray(arr).astype(np.int32)
    return np.asarray(arr).astype(np.int16)


def _inverse_pivot(img):
    """PresentationLUTShape 'Inverse' pivot = max stored value.
    REFERENCE BUG FIXED: the reference hardcodes 16383
    (read/dicom.py:1012-1014), correct only for BitsStored=14; a
    12-bit inverse image would shift by 12288. BitsStored absent keeps
    the reference's 14-bit default."""
    bits = img.get("BitsStored")
    try:
        bits = int(bits) if bits is not None else 14
    except (TypeError, ValueError):
        bits = 14
    return (1 << bits) - 1


def _spacing_by_plane(inplane, slice_thickness, plane):
    if plane == "Axial":
        return np.array([inplane[1], inplane[0], slice_thickness])
    if plane == "Coronal":
        return np.array([inplane[1], slice_thickness, inplane[0]])
    return np.array([slice_thickness, inplane[1], inplane[0]])


class ReadXRay(object):
    """DX/CR single-slice pseudo-3D (reference read/dicom.py:830-1033)."""

    def __init__(self, image_set, only_tags):
        self.image_set = image_set if isinstance(image_set, list) \
            else [image_set]
        self.only_tags = only_tags

        self.unverified = "Modality"
        self.skipped_slice = None
        self.rgb = False

        self.orientation = [1, 0, 0, 0, 1, 0]
        self.origin = np.array([0, 0, 0])
        self.image_matrix = np.eye(3, dtype=np.float32)

        self.modality = self.image_set[0].Modality
        self.filepaths = self.image_set[0].filename
        self.sops = self.image_set[0].SOPInstanceUID

        self.plane = _plane_from_patient_orientation(self.image_set[0])
        self.dimensions = self._compute_dimensions()
        self.spacing = _spacing_by_plane(
            _inplane_spacing(self.image_set[0]), 1, self.plane)

        self.array = None
        if not self.only_tags:
            self._compute_array()

        self.image_name = create_image_name(self.modality)
        image = Image(self)
        Data.image[self.image_name] = image
        Data.image_list.append(self.image_name)

    def _compute_dimensions(self):
        rows = int(self.image_set[0]["Rows"].value)
        cols = int(self.image_set[0]["Columns"].value)
        if self.plane == "Axial":
            return np.array([1, rows, cols])
        if self.plane == "Coronal":
            return np.array([rows, 1, cols])
        return np.array([rows, cols, 1])

    def _compute_array(self):
        img = self.image_set[0]
        self.array = _cast_stored(img, img.pixel_array)
        del img.PixelData

        # PresentationLUTShape 'Inverse' (reference read/dicom.py:1012-1014)
        if "PresentationLUTShape" in img \
                and img.PresentationLUTShape == "Inverse":
            self.array = _inverse_pivot(img) - self.array

        if self.plane == "Axial":
            self.array = self.array.reshape((1, *self.array.shape))
        elif self.plane == "Coronal":
            self.array = np.flip(np.flip(self.array.reshape(
                (self.array.shape[0], 1, self.array.shape[1])), axis=0),
                axis=1)
        else:
            self.array = np.flip(self.array.reshape(
                (self.array.shape[0], self.array.shape[1], 1)), axis=0)


class ReadRF(object):
    """Fluoroscopy multi-frame (reference read/dicom.py:1036-1224)."""

    def __init__(self, image_set, only_tags):
        self.image_set = image_set if isinstance(image_set, list) \
            else [image_set]
        self.only_tags = only_tags

        self.unverified = "Modality"
        self.skipped_slice = None
        self.rgb = False

        self.modality = self.image_set[0].Modality
        self.filepaths = self.image_set[0].filename
        self.sops = self.image_set[0].SOPInstanceUID

        self.orientation = [1, 0, 0, 0, 1, 0]
        self.origin = np.array([0, 0, 0])
        self.image_matrix = np.eye(3, dtype=np.float32)
        self.plane = _plane_from_patient_orientation(self.image_set[0])

        img = self.image_set[0]
        frames = int(img.get("NumberOfFrames", 1) or 1)
        rows = int(img["Rows"].value)
        cols = int(img["Columns"].value)
        self.dimensions = np.array([frames, rows, cols])

        self.array = None
        if not self.only_tags:
            self._compute_array()
            self.dimensions = np.asarray(self.array.shape)

        self.spacing = self._compute_spacing()
        self.image_name = create_image_name(self.modality)

        image = Image(self)
        Data.image[self.image_name] = image
        Data.image_list.append(self.image_name)

    def _compute_spacing(self):
        return _spacing_by_plane(
            _inplane_spacing(self.image_set[0]), 1, self.plane)

    def _cast(self, arr):
        return _cast_stored(self.image_set[0], arr)

    def _compute_array(self):
        self.array = self._cast(self.image_set[0].pixel_array)
        del self.image_set[0].PixelData

        if self.array.ndim < 3:
            if self.plane == "Axial":
                self.array = self.array.reshape((1, *self.array.shape))
            elif self.plane == "Coronal":
                self.array = self.array.reshape(
                    (self.array.shape[0], 1, self.array.shape[1]))
            else:
                self.array = self.array.reshape(
                    (self.array.shape[0], self.array.shape[1], 1))


class ReadUS(object):
    """Ultrasound multi-frame with uniform-channel grayscale extraction
    (reference read/dicom.py:1227-1386)."""

    def __init__(self, image_set, only_tags):
        self.image_set = image_set if isinstance(image_set, list) \
            else [image_set]
        self.only_tags = only_tags

        self.unverified = "Modality"
        self.base_position = None
        self.skipped_slice = None
        self.rgb = False

        self.modality = self.image_set[0].Modality
        self.filepaths = self.image_set[0].filename
        self.sops = self.image_set[0].SOPInstanceUID

        self.plane = "Axial"
        self.orientation = [1, 0, 0, 0, 1, 0]
        self.origin = np.array([0, 0, 0])
        self.image_matrix = np.eye(3, dtype=np.float32)

        self.dimensions = np.array([
            int(self.image_set[0].get("NumberOfFrames", 1) or 1),
            self.image_set[0]["Rows"].value,
            self.image_set[0]["Columns"].value])

        self.array = None
        if not self.only_tags:
            self._compute_array()

        self.spacing = _spacing_by_plane(
            _inplane_spacing(self.image_set[0], allow_imager=False,
                             allow_us_regions=True), 1, "Axial")
        self.image_name = create_image_name(self.modality)

        image = Image(self)
        Data.image[self.image_name] = image
        Data.image_list.append(self.image_name)

    def _compute_array(self):
        """Keep pixels where the color channels agree (std across channel
        == 0), i.e. true grayscale echo; drop colored overlays
        (reference read/dicom.py:1310-1342).

        REFERENCE BUG FIXED: a 3-D pixel array is ambiguous between a
        grayscale multi-frame cine (frames, rows, cols) and one RGB
        frame (rows, cols, 3); the reference treats every 3-D array as
        channels-last, so grayscale cines got their std taken across
        COLUMNS and were wiped to near-zero. Disambiguate on
        SamplesPerPixel (see PARITY.md)."""
        img = self.image_set[0]
        samples = int(img.get("SamplesPerPixel", 1) or 1)
        us_data = np.asarray(img.pixel_array)
        del img.PixelData

        if samples == 1:
            # true grayscale echo: no channel axis anywhere
            if us_data.ndim == 2:
                us_data = us_data.reshape((1, *us_data.shape))
            self.array = us_data.astype(np.uint8)
        elif us_data.ndim == 3:
            # one RGB frame (rows, cols, samples)
            uniform_mask = (np.std(us_data, axis=2) == 0)
            self.array = np.expand_dims(
                (uniform_mask * us_data[:, :, 0]).astype(np.uint8), axis=0)
        else:
            uniform_mask = (np.std(us_data, axis=3) == 0)
            self.array = (uniform_mask * us_data[:, :, :, 0]).astype(np.uint8)

        self.dimensions = np.asarray(self.array.shape)
