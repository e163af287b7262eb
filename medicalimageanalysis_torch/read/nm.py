"""Nuclear-medicine (NM) ingest: SPECT RECON TOMO volumes + planar.

Port of medicalimageanalysis_tpu/read/nm.py. The NM IOD (PS3.3 C.8.4)
is a single multi-frame file. Geometry does NOT live in per-frame
functional groups (that's the enhanced-CT/MR/PT layout handled by
read/multiframe.py): a reconstructed tomo volume carries ONE
ImageOrientationPatient + ImagePositionPatient inside
``DetectorInformationSequence`` and a signed ``SpacingBetweenSlices``
for the frame pitch. ``expand_nm_tomo`` synthesizes a per-frame
ImagePositionPatient by stepping the detector IPP along the slice
normal, producing FrameViews that ride the standard grouping + Read3D
pipeline unchanged (assembled on the card) — including the FFS
corner-analysis normalization, which a negative SpacingBetweenSlices
exercises for real.

Expansion is deliberately conservative: anything whose frames are NOT
one linear spatial stack — gated reconstructions (time x slice
interleave), multi-detector files, NumberOfSlices != NumberOfFrames,
degenerate detector orientation — falls back to the frame-stack
reader, never to a geometrically wrong volume.

Frames whose ImageType is not a reconstructed tomo (STATIC, WHOLE
BODY, DYNAMIC, GATED) have no patient-space geometry; they ingest as a
pseudo-3D frame stack via ``ReadNMPlanar`` (a thin ReadRF subclass),
kept in int32 — NM counts are unsigned 16-bit and a blanket int16 cast
would wrap everything above 32767. Planar arrays stay numpy on the
host, as every Image's array does.
"""

from __future__ import annotations

import numpy as np

from .multiframe import FrameView

__all__ = ["is_nm_tomo", "expand_nm_tomo", "ReadNMPlanar"]

# ImageType value 3 for reconstructed volumetric NM (PS3.3 C.8.4.9.1).
# RECON GATED TOMO is intentionally absent: gated frames interleave
# time bins x slices, so a linear IPP walk would stack every gate into
# one bogus 8x-length volume (review finding).
_TOMO_TYPES = {"RECON TOMO"}


def _image_type_values(ds):
    v = ds.get("ImageType")
    if v is None:
        return []
    if isinstance(v, str):
        return [v]
    try:
        return [str(x) for x in v]
    except TypeError:
        return []


def _detector_geometry(ds):
    """(iop(6), ipp(3), normal(3)) from a single-item
    DetectorInformationSequence, or None when absent, multi-item
    (multi-head geometry), malformed, or orientation-degenerate."""
    if "DetectorInformationSequence" not in ds:
        return None
    try:
        seq = ds.DetectorInformationSequence
        if len(seq) != 1:
            return None
        det = seq[0]
        iop = np.asarray(det.ImageOrientationPatient, np.float64)
        ipp = np.asarray(det.ImagePositionPatient, np.float64)
    except (AttributeError, IndexError, TypeError, ValueError):
        return None
    if iop.shape != (6,) or ipp.shape != (3,):
        return None
    normal = np.cross(iop[:3], iop[3:])
    nrm = float(np.linalg.norm(normal))
    if not np.isfinite(nrm) or nrm < 1e-6:
        # parallel/corrupt row+col vectors: no slice direction exists
        # (a zero normal would place every frame at the same IPP and
        # register a spacing-0 volume — fuzz posture: decline)
        return None
    return iop, ipp, normal / nrm


def _frame_pitch(ds):
    """Signed frame pitch in mm: SpacingBetweenSlices (may be negative
    per the NM IOD — slices stepping against the normal), falling back
    to SliceThickness."""
    from ..dicom.dataset import value_or
    for key in ("SpacingBetweenSlices", "SliceThickness"):
        v = value_or(ds, key, None)
        if v is not None:
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            if v != 0.0 and np.isfinite(v):
                return v
    return None


def is_nm_tomo(ds):
    """True when this NM dataset is a reconstructed volume whose frames
    form ONE linear spatial stack placeable in patient space.

    Fails CLOSED on anything ambiguous (corrupt NumberOfDetectors,
    NumberOfSlices mismatch, multi-item detector sequence): the planar
    frame-stack path is always safe; a wrongly synthesized volume is
    not."""
    try:
        frames = int(ds.get("NumberOfFrames", 1) or 1)
    except (TypeError, ValueError):
        return False
    if frames <= 1:
        return False
    if not (_TOMO_TYPES & set(_image_type_values(ds))):
        return False
    # multi-detector tomo interleaves frames per detector; without the
    # FrameIncrementPointer walk the synthesized geometry would be
    # wrong, so only the single-detector layout expands. An absent tag
    # defers to the (single-item-checked) detector sequence; a corrupt
    # one fails closed.
    if "NumberOfDetectors" in ds:
        try:
            n_det = int(ds["NumberOfDetectors"].value)
        except (TypeError, ValueError):
            return False
        if n_det != 1:
            return False
    # gated/dynamic reconstructions carry frames = bins x slices;
    # NumberOfSlices (0054,0081), when present, must account for every
    # frame or the linear IPP walk is wrong
    if "NumberOfSlices" in ds:
        try:
            n_slices = int(ds["NumberOfSlices"].value)
        except (TypeError, ValueError):
            return False
        if n_slices != frames:
            return False
    return (_detector_geometry(ds) is not None
            and _frame_pitch(ds) is not None)


class NMTomoFrameView(FrameView):
    """One frame of an NM RECON TOMO volume, shaped like a single-slice
    dataset: geometry synthesized from the detector IOP/IPP + pitch
    instead of per-frame functional groups."""

    def __init__(self, parent, index, ipp, iop):
        super().__init__(parent, index, None, None)
        self._nm_ipp = [float(v) for v in ipp]
        self._nm_iop = [float(v) for v in iop]

    def _value(self, name):
        if name == "ImagePositionPatient":
            return self._nm_ipp
        if name == "ImageOrientationPatient":
            return self._nm_iop
        if name in ("PixelSpacing", "SliceThickness",
                    "RescaleSlope", "RescaleIntercept"):
            return self._parent.get(name)
        return super()._value(name)


def expand_nm_tomo(ds):
    """NM RECON TOMO dataset -> per-frame views with synthesized
    ImagePositionPatient stepping along the slice normal."""
    iop, ipp, normal = _detector_geometry(ds)
    pitch = _frame_pitch(ds)
    frames = int(ds.NumberOfFrames)
    return [NMTomoFrameView(ds, i, ipp + normal * (pitch * i), iop)
            for i in range(frames)]


from .planar import (ReadRF, _inplane_spacing,  # noqa: E402
                     _spacing_by_plane)
from ..dicom.dataset import value_or  # noqa: E402


class ReadNMPlanar(ReadRF):
    """Planar / whole-body / gated NM frame stacks: ReadRF with two NM
    deltas — int32 output (counts are unsigned 16-bit; int16 wraps
    above 32767) and an in-plane-spacing fallback to the
    DetectorInformationSequence item, where planar NM often carries
    PixelSpacing instead of the top level."""

    def _cast(self, arr):
        return np.asarray(arr).astype(np.int32)

    def _compute_spacing(self):
        img = self.image_set[0]
        inplane = _inplane_spacing(img)
        # fall back ONLY when no top-level spacing tag exists at all —
        # an explicit PixelSpacing of exactly [1, 1] must win over a
        # stale detector item (review finding)
        if list(inplane) == [1, 1] \
                and value_or(img, "PixelSpacing", None) is None \
                and value_or(img, "ImagerPixelSpacing", None) is None \
                and "DetectorInformationSequence" in img:
            try:
                det = img.DetectorInformationSequence[0]
            except IndexError:
                det = None
            if det is not None \
                    and value_or(det, "PixelSpacing", None) is not None:
                inplane = det.PixelSpacing
        return _spacing_by_plane(inplane, 1, self.plane)
