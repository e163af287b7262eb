"""DICOM SEG (Segmentation IOD, PS3.3 A.51) reader.

Port of medicalimageanalysis_tpu/read/seg.py (``ReadSEG``, :104-355, and
the CIELAB helpers, :28-90): BINARY (1-bit, packed LSB-first at bit
granularity) and FRACTIONAL (8-bit) segmentations mapped onto the matched
image. The packed bytes (or the decoded 8-bit frames) are uploaded once to
``device`` and unpacked there; each segment's mask is assembled on the
device, frame by frame at its pixel offset (cropped sub-windows paste
where they belong), and ``Image.input_seg`` hands it to the ROI and to
the image's bit-packed mask cache, so ``compute_roi_masks`` serves it
without rasterizing.

Frame geometry: each frame's ImagePositionPatient maps to a slice index
and an in-plane offset through the image's position -> pixel matrix;
frames off the grid (a quarter voxel), of another orientation or out of
bounds count in ``skipped_frames`` rather than being mislabeled. Frames
larger than the grid, a transposed orientation and a PixelSpacing
mismatch raise.

Colors: RecommendedDisplayCIELabValue (PCS-Values, PS3.3 C.10.7.1.1) is
converted to sRGB through D50 CIELab; segments without one get a random
color, as RTSTRUCT ROIs do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import Data

__all__ = ["ReadSEG", "cielab_uint16_to_rgb", "rgb_to_cielab_uint16",
           "unpack_bits_little"]

# sRGB (D65 primaries) -> XYZ, Bradford-adapted to D50 (ICC PCS) —
# DICOM PCS-Values are CIELab under D50 (PS3.3 C.10.7.1.1)
_RGB_TO_XYZ_D50 = np.array([
    [0.4360747, 0.3850649, 0.1430804],
    [0.2225045, 0.7168786, 0.0606169],
    [0.0139322, 0.0971045, 0.7141733],
])
_XYZ_D50_TO_RGB = np.linalg.inv(_RGB_TO_XYZ_D50)
_WHITE_D50 = np.array([0.96422, 1.0, 0.82521])


def _srgb_to_linear(c):
    c = np.asarray(c, dtype=np.float64)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c):
    c = np.clip(np.asarray(c, dtype=np.float64), 0.0, 1.0)
    return np.where(c <= 0.0031308, 12.92 * c,
                    1.055 * c ** (1 / 2.4) - 0.055)


def _lab_f(t):
    d = 6.0 / 29.0
    return np.where(t > d ** 3, np.cbrt(t), t / (3 * d * d) + 4.0 / 29.0)


def _lab_finv(t):
    d = 6.0 / 29.0
    return np.where(t > d, t ** 3, 3 * d * d * (t - 4.0 / 29.0))


def rgb_to_cielab_uint16(rgb):
    """[r, g, b] 0..255 -> DICOM PCS-Values [L, a, b] uint16 triplet
    (L scaled 0..100 -> 0..0xFFFF, a/b offset +128 then 0..255 ->
    0..0xFFFF; PS3.3 C.10.7.1.1)."""
    xyz = _RGB_TO_XYZ_D50 @ _srgb_to_linear(
        np.asarray(rgb, dtype=np.float64) / 255.0)
    fx, fy, fz = _lab_f(xyz / _WHITE_D50)
    lab = np.array([116.0 * fy - 16.0, 500.0 * (fx - fy),
                    200.0 * (fy - fz)])
    enc = np.array([lab[0] * 0xFFFF / 100.0,
                    (lab[1] + 128.0) * 0xFFFF / 255.0,
                    (lab[2] + 128.0) * 0xFFFF / 255.0])
    return [int(v) for v in np.clip(np.round(enc), 0, 0xFFFF)]


def cielab_uint16_to_rgb(lab16):
    """DICOM PCS-Values uint16 triplet -> [r, g, b] 0..255."""
    lab16 = np.asarray(lab16, dtype=np.float64)
    lstar = lab16[0] * 100.0 / 0xFFFF
    a = lab16[1] * 255.0 / 0xFFFF - 128.0
    b = lab16[2] * 255.0 / 0xFFFF - 128.0
    fy = (lstar + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = _lab_finv(np.array([fx, fy, fz])) * _WHITE_D50
    rgb = _linear_to_srgb(_XYZ_D50_TO_RGB @ xyz) * 255.0
    return [int(v) for v in np.clip(np.round(rgb), 0, 255)]


def _first(ds, seq_name):
    try:
        seq = ds[seq_name].value if seq_name in ds else None
    except Exception:
        seq = None
    if seq is None:
        seq = getattr(ds, seq_name, None)
    if seq:
        return seq[0]
    return None


def unpack_bits_little(packed, n):
    """The first ``n`` bits of a uint8 tensor, LSB-first (numpy's
    ``unpackbits(..., bitorder="little")``), as uint8 0 / 1 on its
    device."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n]


class ReadSEG(object):
    """Parse one Segmentation Storage instance.

    Attributes: roi_names / roi_colors / masks ((Z, Y, X) uint8 tensors on
    ``device``, on the matched image grid, one per ROI), match_image_name,
    filepaths, skipped_frames (off-grid frame count), fractional_arrays
    (the 0..1 float32 frames of a FRACTIONAL SEG, same order as
    roi_names, on ``device``).
    """

    def __init__(self, image_set, only_tags, only_load_roi_names=None,
                 device=None):
        from ..device import default_device

        self.image_set = image_set
        self.only_tags = only_tags
        self.device = default_device() if device is None \
            else torch.device(device)
        self.filepaths = getattr(image_set, "filename", None)
        self.skipped_frames = 0
        self.roi_names = []
        self.roi_colors = []
        self.masks = []
        self.fractional_arrays = []

        ds = image_set
        self.series_uid = self._referenced_series_uid(ds)
        self.frame_ref = str(ds.get("FrameOfReferenceUID", "") or "")
        self.match_image_name = self._match_with_image()

        segments = self._parse_segments(ds, only_load_roi_names)
        if only_tags or self.match_image_name is None or not segments:
            # names/colors are still surfaced for only_tags inventories
            self.roi_names = [s["label"] for s in segments]
            self.roi_colors = [s["color"] for s in segments]
            return

        self._build_masks(ds, segments)

    # ------------------------------------------------------------------
    # matching
    # ------------------------------------------------------------------
    def _referenced_series_uid(self, ds):
        item = _first(ds, "ReferencedSeriesSequence")
        if item is not None:
            uid = item.get("SeriesInstanceUID")
            if uid:
                return str(uid)
        return None

    def _match_with_image(self):
        """Referenced SeriesInstanceUID first (like RTSTRUCT),
        FrameOfReferenceUID as fallback."""
        for name in Data.image:
            if self.series_uid is not None \
                    and Data.image[name].series_uid == self.series_uid:
                return name
        if self.frame_ref:
            for name in Data.image:
                if Data.image[name].frame_ref == self.frame_ref:
                    return name
        return None

    # ------------------------------------------------------------------
    # segments
    # ------------------------------------------------------------------
    def _parse_segments(self, ds, only_load_roi_names):
        segments = []
        self.filtered_numbers = set()
        seq = getattr(ds, "SegmentSequence", None) or []
        keep = set(only_load_roi_names) if only_load_roi_names else None
        for item in seq:
            number = item.get("SegmentNumber")
            if number is None:
                continue
            label = str(item.get("SegmentLabel", "") or
                        f"Segment {int(number)}")
            if keep is not None and label not in keep:
                # deliberately filtered: frames referencing these are
                # dropped silently, NOT counted as off-grid
                self.filtered_numbers.add(int(number))
                continue
            lab16 = item.get("RecommendedDisplayCIELabValue")
            if lab16 is not None and len(lab16) == 3:
                color = cielab_uint16_to_rgb(lab16)
            else:
                color = [int(np.random.randint(0, 256)) for _ in range(3)]
            segments.append({"number": int(number), "label": label,
                             "color": color})
        return segments

    # ------------------------------------------------------------------
    # frames -> masks
    # ------------------------------------------------------------------
    def _unpack_frames(self, ds, nframes, rows, cols):
        """The frames as a (nframes, rows, cols) uint8 tensor on the
        device, and the maximum fractional value (1 for BINARY)."""
        bits = int(ds.get("BitsAllocated", 1))
        n = nframes * rows * cols
        if bits == 1:
            # BINARY segs are native-only (PS3.3 C.8.20.2.1): frames
            # pack contiguously at bit granularity, LSB-first, padding
            # only at the very end of PixelData (PS3.5 8.1.1)
            raw = ds.PixelData
            if not isinstance(raw, (bytes, bytearray)):
                raise ValueError(
                    "SEG: BINARY (1-bit) segmentation pixel data must "
                    "be native, got encapsulated fragments")
            if len(raw) * 8 < n:
                raise ValueError("SEG: packed pixel data shorter than "
                                 "NumberOfFrames*Rows*Columns")
            packed = torch.from_numpy(
                np.frombuffer(raw, dtype=np.uint8, count=(n + 7) // 8)
                .copy()).to(self.device)
            return unpack_bits_little(packed, n).reshape(
                nframes, rows, cols), 1
        if bits == 8:
            # pixel_array routes native AND encapsulated (RLE,
            # JPEG-LS, ...) through dicom/pixels.decode_pixel_data
            arr = np.asarray(ds.pixel_array).reshape(-1)
            if arr.size < n:
                raise ValueError("SEG: pixel data shorter than "
                                 "NumberOfFrames*Rows*Columns")
            frames = torch.from_numpy(
                arr[:n].astype(np.uint8).reshape(nframes, rows, cols)) \
                .to(self.device)
            return frames, int(ds.get("MaximumFractionalValue", 255) or 255)
        raise ValueError(f"SEG: BitsAllocated={bits} not supported "
                         "(BINARY=1, FRACTIONAL=8)")

    @staticmethod
    def _orientation_of(group):
        """ImageOrientationPatient from a functional-group item's
        PlaneOrientationSequence, or None."""
        if group is None:
            return None
        orient = _first(group, "PlaneOrientationSequence")
        if orient is None:
            return None
        iop = orient.get("ImageOrientationPatient")
        if iop is None or len(iop) != 6:
            return None
        return np.asarray(iop, dtype=np.float64)

    def _build_masks(self, ds, segments):
        from ..ops import geometry as geo

        img = Data.image[self.match_image_name]
        # dimensions is array-ordered (z, y, x) for axial volumes
        nz, ny, nx = (int(img.dimensions[0]), int(img.dimensions[1]),
                      int(img.dimensions[2]))
        rows, cols = int(ds.Rows), int(ds.Columns)
        nof = ds.get("NumberOfFrames")
        nframes = 1 if nof is None or str(nof) == "" else int(nof)
        if rows > ny or cols > nx:
            raise ValueError(
                f"SEG: frame grid {rows}x{cols} exceeds the "
                f"referenced image grid {ny}x{nx} — off-grid SEG "
                "resampling is not implemented")
        # rows/cols <= image grid: cropped sub-window SEGs paste at each
        # frame's integer pixel offset below

        dev = self.device
        self.roi_names = [s["label"] for s in segments]
        self.roi_colors = [s["color"] for s in segments]
        self.masks = [torch.zeros((nz, ny, nx), dtype=torch.uint8,
                                  device=dev) for _ in segments]
        self.fractional_arrays = [None] * len(segments)
        if nframes == 0:
            # a legitimately empty SEG (our own writer on an all-empty
            # ROI): segments ingest as empty masks
            return

        # frame rows/cols must lie along the image's row/col axes: a
        # transposed or mirrored SEG would otherwise ingest as a silently
        # transposed mask
        img_iop = np.asarray(img.orientation, dtype=np.float64)
        shared = _first(ds, "SharedFunctionalGroupsSequence")
        shared_iop = self._orientation_of(shared)
        if shared_iop is not None \
                and not np.allclose(shared_iop, img_iop, atol=1e-3):
            raise ValueError(
                "SEG: frame orientation does not match the referenced "
                "image orientation — off-grid SEG resampling is not "
                "implemented")
        # pixel spacing must match too: direction cosines are
        # spacing-independent
        measures = _first(shared, "PixelMeasuresSequence") \
            if shared is not None else None
        seg_ps = measures.get("PixelSpacing") if measures is not None \
            else None
        if seg_ps is not None and len(seg_ps) == 2:
            img_ps = [float(img.spacing[1]), float(img.spacing[0])]
            if not np.allclose(np.asarray(seg_ps, np.float64), img_ps,
                               atol=1e-3):
                raise ValueError(
                    f"SEG: frame PixelSpacing {list(seg_ps)} does not "
                    f"match the referenced image {img_ps} — off-grid "
                    "SEG resampling is not implemented")

        frames, max_frac = self._unpack_frames(ds, nframes, rows, cols)
        per_frame = getattr(ds, "PerFrameFunctionalGroupsSequence",
                            None) or []
        if len(per_frame) < nframes:
            raise ValueError("SEG: PerFrameFunctionalGroupsSequence "
                             "shorter than NumberOfFrames")

        m = img.display.compute_matrix_position_to_pixel()
        by_number = {s["number"]: i for i, s in enumerate(segments)}
        masks = self.masks
        fracs = self.fractional_arrays

        for fi in range(nframes):
            f = per_frame[fi]
            ident = _first(f, "SegmentIdentificationSequence")
            plane = _first(f, "PlanePositionSequence")
            if ident is None or plane is None:
                self.skipped_frames += 1
                continue
            num = ident.get("ReferencedSegmentNumber")
            ipp = plane.get("ImagePositionPatient")
            num = int(num) if num is not None else -1
            if num in self.filtered_numbers:
                continue  # segment excluded by only_load_roi_names
            si = by_number.get(num)
            if si is None or ipp is None or len(ipp) != 3:
                self.skipped_frames += 1
                continue
            frame_iop = self._orientation_of(f)
            if frame_iop is not None \
                    and not np.allclose(frame_iop, img_iop, atol=1e-3):
                self.skipped_frames += 1
                continue
            pix = geo.apply_homogeneous(
                np.asarray(ipp, dtype=np.float64), m)
            z = int(np.round(pix[2]))
            x0, y0 = int(np.round(pix[0])), int(np.round(pix[1]))
            # quarter-voxel snap: a 0.5 tolerance would be vacuous in z;
            # integer x0/y0 offsets place cropped sub-window frames
            tol = 0.25
            on_grid = (abs(pix[2] - z) <= tol and 0 <= z < nz
                       and abs(pix[0] - x0) <= tol
                       and abs(pix[1] - y0) <= tol
                       and 0 <= y0 and y0 + rows <= ny
                       and 0 <= x0 and x0 + cols <= nx)
            if not on_grid:
                self.skipped_frames += 1
                continue
            win = np.s_[z, y0:y0 + rows, x0:x0 + cols]
            if max_frac == 1:
                masks[si][win] |= frames[fi]
            else:
                if fracs[si] is None:
                    fracs[si] = torch.zeros((nz, ny, nx),
                                            dtype=torch.float32, device=dev)
                frac = frames[fi].to(torch.float32) / float(max_frac)
                fracs[si][win] = torch.maximum(fracs[si][win], frac)
                # int32: frames are uint8 and 255*2 wraps in uint8
                masks[si][win] |= (frames[fi].to(torch.int32) * 2
                                   >= max_frac).to(torch.uint8)
