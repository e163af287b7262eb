"""RTSTRUCT parser: ROI contours + POI points + image matching.

Carried over from medicalimageanalysis_tpu/read/rtstruct.py (a host
parser; reference read/dicom.py:1389-1605, with ``only_load_roi_names``
forwarded).
"""

from __future__ import annotations

import numpy as np

from ..config import config
from ..data import Data

__all__ = ["ReadRTStruct"]


class ReadRTStruct(object):
    """Parse one RTSTRUCT dataset.

    Attributes: roi_names/roi_colors, poi_names/poi_colors, contours
    (list per ROI of (N, 3) physical mm arrays rounded to 3 dp), points,
    match_image_name.
    """

    def __init__(self, image_set, only_tags, only_load_roi_names=None):
        self.image_set = image_set
        self.only_tags = only_tags
        self.only_load_roi_names = only_load_roi_names

        self.series_uid = self._get_series_uid()
        self.filepaths = self.image_set.filename

        self._properties = self._get_properties()
        if only_load_roi_names is not None:
            keep = set(only_load_roi_names)
            self._properties = [p for p in self._properties
                                if p[1] in keep or p[3].lower() == "point"]

        self.roi_names = [p[1] for p in self._properties
                          if p[3].lower() == "closed_planar"]
        self.roi_colors = [p[2] for p in self._properties
                           if p[3].lower() == "closed_planar"]
        self.poi_names = [p[1] for p in self._properties
                          if p[3].lower() == "point"]
        self.poi_colors = [p[2] for p in self._properties
                           if p[3].lower() == "point"]

        if len(self.roi_names) > 0 or len(self.poi_names) > 0:
            self.match_image_name = self._match_with_image()
            self.contours = []
            self.points = []
            if not self.only_tags:
                self._structure_positions()
        else:
            self.match_image_name = None

    def _get_series_uid(self):
        """Referenced series UID via ReferencedFrameOfReference ->
        RTReferencedStudy -> RTReferencedSeries
        (reference read/dicom.py:1471-1484)."""
        try:
            ref = self.image_set.ReferencedFrameOfReferenceSequence
            return ref[0].RTReferencedStudySequence[0] \
                .RTReferencedSeriesSequence[0].SeriesInstanceUID
        except (AttributeError, IndexError, KeyError):
            return None

    def _get_properties(self):
        """Per-structure [index, name, color, geometric type, referenced
        SOPs]; random color fallback (reference read/dicom.py:1486-1559)."""
        props = []
        if "ROIContourSequence" not in self.image_set:
            return props

        roi_seq = self.image_set.StructureSetROISequence \
            if "StructureSetROISequence" in self.image_set else []
        for ii, s in enumerate(self.image_set.ROIContourSequence):
            if ii >= len(roi_seq) or "ROIName" not in roi_seq[ii]:
                continue
            if "ContourSequence" not in s or len(s.ContourSequence) == 0:
                continue

            name = roi_seq[ii].ROIName
            geometric = s.ContourSequence[0].ContourGeometricType

            slice_sop = []
            if geometric.lower() == "closed_planar":
                for seq in s.ContourSequence:
                    if "ContourImageSequence" in seq:
                        slice_sop.append(
                            seq.ContourImageSequence[0]
                            .ReferencedSOPInstanceUID)
            else:
                if "ContourImageSequence" in s.ContourSequence[0]:
                    slice_sop = [s.ContourSequence[0]
                                 .ContourImageSequence[0]
                                 .ReferencedSOPInstanceUID]

            if "ROIDisplayColor" in s:
                color = s.ROIDisplayColor
            else:
                color = [int(np.random.randint(0, 256)) for _ in range(3)]

            props.append([ii, name, color, geometric, slice_sop])
        return props

    def _match_with_image(self):
        """Match = referenced SeriesInstanceUID equal AND first referenced
        SOP present in the image's sops (reference read/dicom.py:1561-1577)."""
        for image_name in Data.image:
            if self.series_uid == Data.image[image_name].series_uid:
                sops = self._properties[0][4]
                if sops and sops[0] in Data.image[image_name].sops:
                    return image_name
                if not sops:
                    return image_name
        return None

    def _structure_positions(self):
        """ContourData rounded to 3 dp, reshaped (-1, 3)
        (reference read/dicom.py:1579-1605)."""
        sequences = self.image_set.ROIContourSequence
        for prop in self._properties:
            seq = sequences[prop[0]]
            contour_list = []
            for c in seq.ContourSequence:
                contour_data = np.round(
                    np.asarray(c.ContourData, dtype=np.float64),
                    config.contour_decimals)
                contour_list.append(contour_data.reshape(-1, 3))

            if prop[3].lower() == "closed_planar":
                self.contours.append(contour_list)
            else:
                self.points.extend(contour_list)
