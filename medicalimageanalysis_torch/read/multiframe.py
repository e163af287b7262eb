"""Enhanced multi-frame CT/MR/PT expansion.

Port of medicalimageanalysis_tpu/read/multiframe.py: a single enhanced
DICOM file with NumberOfFrames and PerFrameFunctionalGroupsSequence
expands into per-frame views that walk through the standard grouping +
Read3D pipeline unchanged (and so are assembled on the card).

Each FrameView delegates to the parent dataset but overrides:
- ImagePositionPatient  (per-frame PlanePositionSequence)
- ImageOrientationPatient (per-frame or shared PlaneOrientationSequence)
- PixelSpacing / SliceThickness (PixelMeasuresSequence fallbacks)
- RescaleSlope/Intercept (PixelValueTransformationSequence fallbacks)
- SOPInstanceUID (suffixed per frame) and pixel_array (frame slice)

The frames read their pixels from the parent's decoded cache
(``Dataset.pixel_array``), so the file decodes once, not once per frame;
Read3D drops the parent's PixelData once every frame is staged.
"""

from __future__ import annotations

import numpy as np

__all__ = ["is_enhanced_multiframe", "expand_multiframe", "FrameView"]


def is_enhanced_multiframe(ds):
    try:
        frames = int(ds.get("NumberOfFrames", 1) or 1)
    except (TypeError, ValueError):
        return False
    return frames > 1 and "PerFrameFunctionalGroupsSequence" in ds


def expand_multiframe(ds):
    """Dataset -> list of FrameView, one per frame."""
    frames = int(ds.NumberOfFrames)
    per_frame = ds.PerFrameFunctionalGroupsSequence
    shared = ds.SharedFunctionalGroupsSequence[0] \
        if "SharedFunctionalGroupsSequence" in ds else None
    n = min(frames, len(per_frame))
    return [FrameView(ds, i, per_frame[i], shared) for i in range(n)]


class FrameView:
    """One frame of an enhanced multi-frame dataset, shaped like a
    single-slice dataset for the grouping/Read3D pipeline."""

    _OVERRIDE = ("ImagePositionPatient", "ImageOrientationPatient",
                 "PixelSpacing", "SliceThickness", "RescaleSlope",
                 "RescaleIntercept", "SOPInstanceUID", "NumberOfFrames",
                 "InstanceNumber")

    def __init__(self, parent, index, frame_groups, shared_groups):
        self._parent = parent
        self._index = index
        self._fg = frame_groups
        self._sg = shared_groups
        self._pixel_cache = None

    # -- per-frame geometry ------------------------------------------------
    def _from_groups(self, seq_name, attr):
        for groups in (self._fg, self._sg):
            if groups is not None and seq_name in groups:
                seq = groups.get(seq_name)
                if seq and attr in seq[0]:
                    return seq[0].get(attr)
        return None

    def _value(self, name):
        if name == "ImagePositionPatient":
            v = self._from_groups("PlanePositionSequence",
                                  "ImagePositionPatient")
            if v is not None:
                return v
        elif name == "ImageOrientationPatient":
            v = self._from_groups("PlaneOrientationSequence",
                                  "ImageOrientationPatient")
            if v is not None:
                return v
        elif name == "PixelSpacing":
            v = self._from_groups("PixelMeasuresSequence", "PixelSpacing")
            if v is not None:
                return v
        elif name == "SliceThickness":
            v = self._from_groups("PixelMeasuresSequence",
                                  "SliceThickness")
            if v is not None:
                return v
        elif name in ("RescaleSlope", "RescaleIntercept"):
            v = self._from_groups("PixelValueTransformationSequence", name)
            if v is not None:
                return v
        elif name == "SOPInstanceUID":
            base = self._parent.get("SOPInstanceUID", "0")
            return f"{base}.{self._index + 1}"
        elif name == "NumberOfFrames":
            return 1
        elif name == "InstanceNumber":
            return self._index + 1
        return self._parent.get(name)

    # -- dataset protocol ----------------------------------------------------
    def __contains__(self, key):
        name = key
        if isinstance(key, tuple):
            from ..dicom.dictionary import tag_to_keyword
            name = tag_to_keyword((key[0] << 16) | key[1])
        if isinstance(name, str) and name in self._OVERRIDE:
            return self._value(name) is not None
        return key in self._parent

    def __getitem__(self, key):
        name = key
        if isinstance(key, tuple):
            from ..dicom.dictionary import tag_to_keyword
            name = tag_to_keyword((key[0] << 16) | key[1])
        if isinstance(name, str) and name in self._OVERRIDE:
            from ..dicom.dataset import DataElement
            from ..dicom.dictionary import keyword_to_tag, tag_to_vr
            tag = keyword_to_tag(name)
            return DataElement(tag, tag_to_vr(tag), self._value(name))
        return self._parent[key]

    def get(self, key, default=None):
        if isinstance(key, str) and key in self._OVERRIDE:
            v = self._value(key)
            return v if v is not None else default
        return self._parent.get(key, default)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._OVERRIDE:
            v = self._value(name)
            if v is None:
                raise AttributeError(name)
            return v
        if name == "filename":
            return self._parent.filename
        if name == "file_meta":
            return self._parent.file_meta
        return getattr(self._parent, name)

    def __delattr__(self, name):
        if name == "PixelData":
            # frames share the parent's buffer; dropping happens when the
            # parent's cache is released after assembly
            object.__setattr__(self, "_pixel_cache", None)
            return
        object.__delattr__(self, name)

    @property
    def pixel_array(self):
        if self._pixel_cache is None:
            full = self._parent.pixel_array
            object.__setattr__(self, "_pixel_cache",
                               np.asarray(full[self._index]))
        return self._pixel_cache
