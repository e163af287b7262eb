"""MetaImage (.mhd / .raw) IO + MhdReader.

Port of medicalimageanalysis_tpu/read/mhd.py (``read_mhd_volume``,
``write_mhd_volume``, ``MhdReader`` with ``create_image``, ``create_roi``,
``create_dose`` and ``create_dvf``): the package's own MHD codec in place
of SimpleITK, with uncompressed and zlib-compressed data, the MET_*
element types, local or external .raw payloads; the writer keeps every
header number exact (the JAX package's, 6 digits). A vector volume read as
a DVF is uploaded once to the reader's device and kept there as the
Deformable's field; Images and Doses keep numpy arrays, like every one of
the port's, and compute on that device (default: the card).
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from ..data import Data

__all__ = ["read_mhd_volume", "write_mhd_volume", "MhdReader"]

_MET_TO_DTYPE = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG": np.int64, "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_DTYPE_TO_MET = {np.dtype(v): k for k, v in _MET_TO_DTYPE.items()}


def read_mhd_volume(path):
    """Read .mhd -> (array, spacing_xyz, origin_xyz, direction (3,3)).

    Array axis order follows the sitk convention the reference relied
    on: (z, y, x) for scalar volumes, (z, y, x, C) for vector volumes.
    Corrupt headers/payloads raise a clean ValueError naming the file
    (not whatever KeyError/zlib/reshape error the parse hit — fuzz
    finding); a missing primary file stays FileNotFoundError.
    """
    try:
        return _read_mhd_volume(path)
    except FileNotFoundError:
        raise
    except (KeyError, ValueError, TypeError, OverflowError, OSError,
            IndexError, zlib.error) as e:
        raise ValueError(
            f"invalid MHD file {str(path)!r}: "
            f"{type(e).__name__}: {e}") from e


def _read_mhd_volume(path):
    header = {}
    data_file = None
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                break
            text = line.decode("latin-1").strip()
            if "=" not in text:
                continue
            key, value = (s.strip() for s in text.split("=", 1))
            header[key] = value
            if key == "ElementDataFile":
                data_file = value
                break
        local_payload = f.read() if data_file == "LOCAL" else None

    ndims = int(header.get("NDims", 3))
    dims = [int(v) for v in header["DimSize"].split()]
    spacing = [float(v) for v in header.get(
        "ElementSpacing", " ".join(["1"] * ndims)).split()]
    origin = [float(v) for v in header.get(
        "Offset", " ".join(["0"] * ndims)).split()]
    direction = np.asarray([float(v) for v in header.get(
        "TransformMatrix", "1 0 0 0 1 0 0 0 1").split()]).reshape(3, 3) \
        if ndims >= 3 else np.eye(3)
    dtype = _MET_TO_DTYPE[header.get("ElementType", "MET_SHORT")]
    channels = int(header.get("ElementNumberOfChannels", 1))
    msb = header.get("BinaryDataByteOrderMSB", "False").lower() == "true"
    compressed = header.get("CompressedData", "False").lower() == "true"

    if local_payload is not None:
        raw = local_payload
    else:
        raw_path = os.path.join(os.path.dirname(str(path)), data_file)
        with open(raw_path, "rb") as f:
            raw = f.read()
    if compressed:
        raw = zlib.decompress(raw)

    count = int(np.prod(dims)) * channels
    arr = np.frombuffer(raw, dtype=dtype, count=count)
    if msb:
        arr = arr.astype(np.dtype(dtype).newbyteorder(">")).astype(dtype)
    # MHD dims are (x, y, z); numpy layout is reversed
    shape = list(reversed(dims))
    if channels > 1:
        arr = arr.reshape(shape + [channels])
    else:
        arr = arr.reshape(shape)
    return arr, np.asarray(spacing), np.asarray(origin), direction


def _fmt(v):
    """A header number that reads back to the same float (the JAX
    package's copy writes 6 significant digits)."""
    v = float(v)
    return str(int(v)) if v.is_integer() and abs(v) < 1e15 else repr(v)


def write_mhd_volume(path, array, spacing=(1, 1, 1), origin=(0, 0, 0),
                     direction=None, compressed=False):
    """Write a (z, y, x[, C]) array as .mhd + .raw pair; the geometry
    reads back exactly."""
    path = str(path)
    if not path.lower().endswith(".mhd"):
        path = path + ".mhd"
    array = np.ascontiguousarray(array)
    vector = array.ndim == 4
    shape = array.shape[:3]
    dims = list(reversed(shape))  # (x, y, z)
    met = _DTYPE_TO_MET[np.dtype(array.dtype)]
    raw_name = os.path.basename(path)[:-4] + (".zraw" if compressed
                                              else ".raw")
    direction = np.eye(3) if direction is None else np.asarray(direction)

    lines = [
        "ObjectType = Image",
        "NDims = 3",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {compressed}",
        "TransformMatrix = " + " ".join(
            _fmt(v) for v in direction.flatten()),
        "Offset = " + " ".join(_fmt(v) for v in origin[:3]),
        "CenterOfRotation = 0 0 0",
        "AnatomicalOrientation = RAI",
        "ElementSpacing = " + " ".join(_fmt(v) for v in spacing[:3]),
        f"DimSize = {dims[0]} {dims[1]} {dims[2]}",
    ]
    if vector:
        lines.append(f"ElementNumberOfChannels = {array.shape[3]}")
    lines += [
        f"ElementType = {met}",
        f"ElementDataFile = {raw_name}",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    payload = array.tobytes()
    if compressed:
        payload = zlib.compress(payload)
    with open(os.path.join(os.path.dirname(path), raw_name), "wb") as f:
        f.write(payload)
    return path


class MhdReader(object):
    """Dispatcher: plain image vs DVF vs ROI masks vs dose
    (reference read/mhd.py:51-252)."""

    def __init__(self, file, modality=None, reference_name=None,
                 moving_name=None, roi_name=None, roi_names=None,
                 image_name=None, dose_name=None, dose=None, dvf=None,
                 device=None):
        from ..device import default_device

        self.device = default_device() if device is None else device
        self.file = file
        self.modality = modality
        self.reference_name = reference_name
        self.moving_name = moving_name
        self.roi_name = roi_name
        self.roi_names = roi_names
        self.image_name = image_name
        self.dose_name = dose_name
        self.dose = dose
        self.dvf = dvf

        self.mhd = None

    def load(self):
        self.mhd = read_mhd_volume(self.file)

        if self.reference_name is not None:
            if self.dvf is not None and self.dvf is not False \
                    and self.moving_name is not None:
                self.create_dvf()
            elif self.dose is not None:
                self.create_dose()
            elif self.roi_name is not None or self.roi_names is not None:
                self.create_roi()
        else:
            self.create_image()

    def create_image(self):
        """Register the volume as an Image via CreateImageFromMask
        (reference read/mhd.py:157-196)."""
        from ..utils.creation import CreateImageFromMask

        array, spacing, origin, direction = self.mhd

        if self.modality is None:
            filename = os.path.basename(str(self.file))
            image_name = os.path.splitext(filename)[0]
            self.modality = "CT"
        else:
            idx = len(Data.image_list)
            image_name = (f"{self.modality} {idx + 1:02d}" if idx < 9
                          else f"{self.modality} {idx + 1}")
        if self.image_name is not None:
            image_name = self.image_name

        orientation = direction.flatten()
        creator = CreateImageFromMask(
            array, origin, spacing, image_name,
            dimensions=np.asarray(array.shape),
            orientation=orientation[:6], plane="Axial",
            description="Mhd to Image", modality=self.modality)
        creator.device = self.device
        creator.add_image()
        return Data.image[image_name]

    def create_roi(self):
        """Attach the MHD volume to `reference_name`'s image as ROI
        mask(s). A single `roi_name` treats the
        volume as a binary mask (non-zero = inside); `roi_names`
        treats it as a label volume with labels 1..N in list order.
        The grid must match the target image's.
        """
        if self.reference_name not in Data.image:
            raise ValueError(
                f"MhdReader roi branch: reference image "
                f"'{self.reference_name}' is not loaded")
        image = Data.image[self.reference_name]
        array = self.mhd[0]
        if tuple(array.shape) != tuple(np.asarray(image.dimensions)):
            raise ValueError(
                "MhdReader roi branch: mask grid "
                f"{tuple(array.shape)} does not match image grid "
                f"{tuple(np.asarray(image.dimensions))}")
        from ..structure.roi import Roi

        if self.roi_names is not None:
            names = list(self.roi_names)
            values = list(range(1, len(names) + 1))
        else:
            names = [self.roi_name]
            values = [None]
        for name, value in zip(names, values):
            if name not in image.rois:
                image.rois[name] = Roi(image, name=name, visible=True,
                                       filepaths=self.file,
                                       plane=image.plane)
            mask = (array != 0) if value is None else (array == value)
            image.rois[name].convert_mask(mask)
        Data.match_rois()

    def create_dose(self):
        """Register the MHD volume as a Dose grid linked to
        `reference_name`'s frame. `dose` can be a scaling factor (True/1
        means raw values are already Gy)."""
        import types

        from ..dicom import Dataset, generate_uid
        from ..read.dicom import create_dose_name
        from ..structure.dose import Dose

        array, spacing, origin, direction = self.mhd
        scale = 1.0 if self.dose is True else float(self.dose)
        dose_array = np.asarray(array, np.float32) * np.float32(scale)

        ds = Dataset()
        ds.Modality = "RTDOSE"
        ds.SOPInstanceUID = generate_uid()
        ds.SeriesInstanceUID = generate_uid()
        ds.StudyInstanceUID = generate_uid()
        if self.reference_name in Data.image:
            ds.FrameOfReferenceUID = \
                Data.image[self.reference_name].frame_ref
        ds.filename = str(self.file)

        orientation = np.asarray(direction, np.float64).flatten()[:6]
        carrier = types.SimpleNamespace(
            image_set=[ds],
            array=dose_array,
            dose_name=(self.dose_name if self.dose_name is not None
                       else create_dose_name("RTDOSE")),
            modality="RTDOSE",
            filepaths=[str(self.file)],
            sops=[str(ds.SOPInstanceUID)],
            plane="Axial",
            spacing=np.asarray(spacing, np.float64),
            dimensions=np.asarray(dose_array.shape),
            orientation=orientation,
            origin=np.asarray(origin, np.float64),
            image_matrix=np.asarray(direction, np.float64),
        )
        dose_obj = Dose(carrier)
        Data.dose[carrier.dose_name] = dose_obj
        Data.dose_list += [carrier.dose_name]
        return dose_obj

    def create_dvf(self):
        """Register a Deformable built from the vector volume, its field
        uploaded once to the device (reference read/mhd.py:214-252)."""
        from ..structure.deformable import Deformable

        array, spacing, origin, direction = self.mhd
        registration_name = f"DVF_{self.reference_name}_{self.moving_name}"
        if registration_name in Data.deformable_list:
            n = 1
            while f"{registration_name}_{n}" in Data.deformable_list:
                n += 1
            registration_name = f"{registration_name}_{n}"

        dimensions = np.asarray(array.shape[:3])
        field = torch.from_numpy(np.array(array)).to(self.device)
        Deformable(field, origin, spacing, dimensions,
                   dvf_matrix=direction,
                   registration_name=registration_name,
                   reference_name=self.reference_name,
                   moving_name=self.moving_name, device=self.device)
