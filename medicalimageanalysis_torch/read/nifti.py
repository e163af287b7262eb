"""NIfTI-1 reader and writer (.nii / .nii.gz).

Port of medicalimageanalysis_tpu/read/nifti.py (``read_nifti_volume``,
``write_nifti_volume``, ``NiftiReader``, ``read_nifti``): the package's
own NIfTI-1 codec, no nibabel. The sform (preferred) or pixdim affine
maps voxels to RAS; the LPS orientation and origin come from negating x
and y, so a NIfTI volume lands in the same patient space as a DICOM one.
The registered Image keeps a numpy array, like every Image of the port;
its compute runs on the reader's device (default: the card).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..data import Data

__all__ = ["read_nifti_volume", "write_nifti_volume", "NiftiReader",
           "read_nifti"]

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}


def read_nifti_volume(path):
    """Read NIfTI-1 -> (array (z, y, x[, t]), spacing_xyz, origin_lps,
    direction_lps (3,3))."""
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()

    sizeof_hdr = struct.unpack_from("<i", data, 0)[0]
    little = True
    if sizeof_hdr != 348:
        if struct.unpack_from(">i", data, 0)[0] == 348:
            little = False
        else:
            raise ValueError("not a NIfTI-1 file")
    e = "<" if little else ">"

    dim = struct.unpack_from(e + "8h", data, 40)
    datatype = struct.unpack_from(e + "h", data, 70)[0]
    pixdim = struct.unpack_from(e + "8f", data, 76)
    vox_offset = struct.unpack_from(e + "f", data, 108)[0]
    scl_slope = struct.unpack_from(e + "f", data, 112)[0]
    scl_inter = struct.unpack_from(e + "f", data, 116)[0]
    sform_code = struct.unpack_from(e + "h", data, 254)[0]
    srow_x = struct.unpack_from(e + "4f", data, 280)
    srow_y = struct.unpack_from(e + "4f", data, 296)
    srow_z = struct.unpack_from(e + "4f", data, 312)
    magic = data[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError("bad NIfTI magic")

    ndim = dim[0]
    nx, ny, nz = max(dim[1], 1), max(dim[2], 1), max(dim[3], 1)
    nt = max(dim[4], 1) if ndim >= 4 else 1
    dtype = _DTYPES.get(datatype)
    if dtype is None:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")

    count = nx * ny * nz * nt
    arr = np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder(e),
                        count=count, offset=int(vox_offset))
    arr = arr.reshape((nt, nz, ny, nx)) if nt > 1 \
        else arr.reshape((nz, ny, nx))
    arr = arr.astype(arr.dtype.newbyteorder("="))
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        arr = arr * slope + scl_inter

    # affine: voxel (i, j, k) -> RAS mm
    if sform_code > 0:
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]],
                          dtype=np.float64)
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])

    # RAS -> LPS (DICOM patient space)
    lps = np.diag([-1.0, -1.0, 1.0, 1.0]) @ affine
    direction = lps[:3, :3].copy()
    spacing = np.linalg.norm(direction, axis=0)
    spacing[spacing == 0] = 1.0
    direction = direction / spacing
    origin = lps[:3, 3]
    # our matrix convention: rows = pixel axis directions
    return arr, spacing, origin, direction.T


_DTYPE_CODES = {
    np.dtype(np.uint8): (2, 8), np.dtype(np.int16): (4, 16),
    np.dtype(np.int32): (8, 32), np.dtype(np.float32): (16, 32),
    np.dtype(np.float64): (64, 64), np.dtype(np.int8): (256, 8),
    np.dtype(np.uint16): (512, 16), np.dtype(np.uint32): (768, 32),
    np.dtype(np.int64): (1024, 64), np.dtype(np.uint64): (1280, 64),
}


def write_nifti_volume(path, array, spacing, origin, matrix):
    """Write a (z, y, x) volume as NIfTI-1 (.nii / .nii.gz), the reader's
    exact inverse: sform from the LPS grid negated into RAS, x-fastest
    little-endian data. ``matrix`` rows = pixel-axis directions,
    ``spacing`` [sx, sy, sz] mm, ``origin`` LPS mm of voxel (0,0,0).
    Float volumes write their dtype directly, with no int16
    quantisation (SUV maps, masks)."""
    path = str(path)
    array = np.asarray(array)
    if array.dtype == bool:
        array = array.astype(np.uint8)  # NIfTI-1 has no 1-bit type
    if array.ndim != 3:
        raise ValueError(f"write_nifti_volume: need (z, y, x), got "
                         f"{array.shape}")
    code = _DTYPE_CODES.get(array.dtype)
    if code is None:
        raise ValueError(
            f"write_nifti_volume: unsupported dtype {array.dtype}")
    datatype, bitpix = code

    nz, ny, nx = array.shape
    sx, sy, sz = (float(v) for v in spacing)
    m = np.asarray(matrix, np.float64)
    # voxel (i, j, k) -> LPS: origin + i*sx*m[0] + j*sy*m[1] + k*sz*m[2]
    lps = np.eye(4)
    lps[:3, 0] = sx * m[0]
    lps[:3, 1] = sy * m[1]
    lps[:3, 2] = sz * m[2]
    lps[:3, 3] = np.asarray(origin, np.float64)
    ras = np.diag([-1.0, -1.0, 1.0, 1.0]) @ lps

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, 1.0, sx, sy, sz, 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    struct.pack_into("<b", hdr, 123, 10)      # xyzt_units: mm | sec
    struct.pack_into("<h", hdr, 252, 0)       # qform_code
    struct.pack_into("<h", hdr, 254, 1)       # sform_code = SCANNER
    struct.pack_into("<4f", hdr, 280, *ras[0])
    struct.pack_into("<4f", hdr, 296, *ras[1])
    struct.pack_into("<4f", hdr, 312, *ras[2])
    hdr[344:348] = b"n+1\x00"

    # sequential writes: no header+volume concat copy (a 512^3 f32
    # map would otherwise hold ~3 transient volume-sized buffers)
    arr_le = np.ascontiguousarray(
        array.astype(array.dtype.newbyteorder("<"), copy=False))
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)
        f.write(memoryview(arr_le).cast("B"))


class NiftiReader(object):
    """Register a NIfTI volume as an Image (mirrors MhdReader's shape)."""

    def __init__(self, file, modality=None, image_name=None, device=None):
        from ..device import default_device

        self.file = file
        self.modality = modality
        self.image_name = image_name
        self.device = default_device() if device is None else device
        self.nifti = None

    def load(self):
        self.nifti = read_nifti_volume(self.file)
        return self.create_image()

    def create_image(self):
        from ..utils.creation import CreateImageFromMask

        array, spacing, origin, direction = self.nifti
        if array.ndim == 4:
            array = array[0]

        if self.modality is None:
            filename = os.path.basename(str(self.file))
            image_name = filename.split(".nii")[0]
            self.modality = "CT"
        else:
            idx = len(Data.image_list)
            image_name = (f"{self.modality} {idx + 1:02d}" if idx < 9
                          else f"{self.modality} {idx + 1}")
        if self.image_name is not None:
            image_name = self.image_name

        orientation = np.concatenate([direction[0], direction[1]])
        creator = CreateImageFromMask(
            np.ascontiguousarray(array), origin, spacing, image_name,
            dimensions=np.asarray(array.shape),
            orientation=orientation, plane="Axial",
            description="Nifti to Image", modality=self.modality)
        creator.device = self.device
        creator.add_image()
        return Data.image[image_name]


def read_nifti(file, modality=None, image_name=None, device=None):
    """Top-level NIfTI load: the volume registered as an Image."""
    reader = NiftiReader(file, modality=modality, image_name=image_name,
                         device=device)
    reader.load()
    return reader
