"""Read3D: CT/MR/PT series -> geometry-correct 3D volume.

Carried over from medicalimageanalysis_tpu/read/volume3d.py. Metadata
decisions (orientation, plane, spacing, FFS corner analysis,
skipped-slice detection) run on the host; the array work (decoded stack
-> rescale -> output dtype -> FFS reorientation) runs on ``device``
(ops/volume.assemble_volume), and the image keeps a numpy array like the
JAX package's.
"""

from __future__ import annotations

import copy

import numpy as np

from ..config import config
from ..data import Data
from ..dicom import generate_uid
from ..ops import geometry as geo
from ..ops.volume import assemble_volume
from ..structure.image import Image
from .dicom import create_image_name

__all__ = ["Read3D"]


class Read3D(object):
    """Assemble a CT/MR/PT slice stack into a canonical (FFS) volume."""

    def __init__(self, image_set, only_tags, register=True, device=None):
        self.image_set = image_set if isinstance(image_set, list) else [image_set]
        self.only_tags = only_tags
        self.register = register
        self.device = device

        self.unverified = None
        self.base_position = None
        self.skipped_slice = []
        self.rgb = False

        self.modality = self.image_set[0].Modality
        self.filepaths = [img.filename for img in self.image_set]
        self.sops = [img.SOPInstanceUID for img in self.image_set]

        self.orientation = self._compute_orientation()
        self.plane = self._compute_plane()
        self.spacing = self._compute_spacing()

        # filepaths/sops may have grown via skipped-slice interpolation
        self.filepaths = [img.filename for img in self.image_set]
        self.sops = [img.SOPInstanceUID for img in self.image_set]

        self.array = None
        self.dimensions = self._compute_dimensions()
        self._assemble_and_verify()

        self.image_matrix = geo.orientation_to_matrix(self.orientation)
        if not self.register:
            return
        self.image_name = create_image_name(self.modality)

        image = Image(self)
        Data.image[self.image_name] = image
        Data.image_list.append(self.image_name)

    # -- metadata ------------------------------------------------------
    def _compute_orientation(self):
        """IOP tag with SharedFunctionalGroupsSequence fallback
        (reference read/dicom.py:536-558)."""
        orientation = np.asarray([1, 0, 0, 0, 1, 0], dtype=np.float64)
        ds = self.image_set[0]
        if "ImageOrientationPatient" in ds:
            orientation = np.asarray(ds["ImageOrientationPatient"].value,
                                     dtype=np.float64)
        elif "SharedFunctionalGroupsSequence" in ds:
            shared = ds.SharedFunctionalGroupsSequence[0]
            if "PlaneOrientationSequence" in shared:
                orientation = np.asarray(
                    shared.PlaneOrientationSequence[0].ImageOrientationPatient,
                    dtype=np.float64)
            else:
                self.unverified = "Orientation"
        else:
            self.unverified = "Orientation"
        return orientation

    def _compute_plane(self):
        return geo.plane_from_orientation(self.orientation)

    def _compute_spacing(self):
        """In-plane spacing fallback chain + slice pitch from IPP projection
        with irregular-spacing detection (reference read/dicom.py:575-623)."""
        from ..dicom.dataset import value_or
        ds = self.image_set[0]
        inplane_spacing = [1, 1]
        # value_or: corrupt DS values decode to None and must take the
        # same default as an absent tag (fuzz finding)
        slice_thickness = np.double(value_or(ds, "SliceThickness", 1.0))

        if value_or(ds, "PixelSpacing", None) is not None:
            inplane_spacing = ds.PixelSpacing
        elif "ContributingSourcesSequence" in ds:
            seq = ds.ContributingSourcesSequence[0]
            if "DetectorElementSpacing" in seq:
                inplane_spacing = seq.DetectorElementSpacing
        elif "PerFrameFunctionalGroupsSequence" in ds:
            seq = ds.PerFrameFunctionalGroupsSequence[0]
            if "PixelMeasuresSequence" in seq:
                inplane_spacing = seq.PixelMeasuresSequence[0].PixelSpacing

        if len(self.image_set) > 1:
            slice_direction = np.cross(self.orientation[:3],
                                       self.orientation[3:])
            first = np.dot(slice_direction,
                           self.image_set[0].ImagePositionPatient)
            second = np.dot(slice_direction,
                            self.image_set[1].ImagePositionPatient)
            last = np.dot(slice_direction,
                          self.image_set[-1].ImagePositionPatient)
            mean_pitch = np.asarray((last - first) / (len(self.image_set) - 1))
            if np.abs((second - first) - mean_pitch) \
                    > config.spacing_tolerance_mm:
                if not self.only_tags:
                    self._find_skipped_slices()
                slice_thickness = second - first
            else:
                slice_thickness = mean_pitch

        if self.plane == "Axial":
            return np.asarray([inplane_spacing[1], inplane_spacing[0],
                               slice_thickness])
        if self.plane == "Coronal":
            return np.asarray([inplane_spacing[1], slice_thickness,
                               inplane_spacing[0]])
        return np.asarray([slice_thickness, inplane_spacing[1],
                           inplane_spacing[0]])

    def _compute_dimensions(self):
        """(x, y, z) voxel counts per plane (reference read/dicom.py:625-638),
        derivable from tags alone so only_tags works."""
        ds = self.image_set[0]
        n = len(self.image_set)
        rows = int(ds.Rows) if "Rows" in ds else 0
        cols = int(ds.Columns) if "Columns" in ds else 0
        shape = (n, rows, cols)  # (slices, y, x)
        if self.plane == "Axial":
            return np.array([shape[0], shape[1], shape[2]])
        if self.plane == "Coronal":
            return np.array([shape[1], shape[0], shape[2]])
        return np.array([shape[1], shape[2], shape[0]])

    # -- array ---------------------------------------------------------
    def _assemble_and_verify(self):
        """FFS decision on host metadata; rescale+reorient on the device
        (replaces reference read/dicom.py:509-534 + :655-740)."""
        ds = self.image_set[0]
        ipp = np.asarray(ds["ImagePositionPatient"].value, dtype=np.float64) \
            if "ImagePositionPatient" in ds else np.zeros(3)
        n = len(self.image_set)
        rows = int(ds.Rows) if "Rows" in ds else 0
        cols = int(ds.Columns) if "Columns" in ds else 0
        shape_zyx = (n, rows, cols)

        decision = geo.ffs_decision(shape_zyx, self.plane, self.spacing,
                                    self.orientation, ipp, self.dimensions)
        self.origin = np.asarray(decision["origin"], dtype=np.float64)
        self.orientation = decision["orientation"]

        if self.only_tags:
            return

        slopes = np.empty(n, dtype=np.float32)
        intercepts = np.empty(n, dtype=np.float32)
        from ..dicom.dataset import value_or
        for i, _slice in enumerate(self.image_set):
            intercepts[i] = value_or(_slice, (0x0028, 0x1052), 0)
            slopes[i] = value_or(_slice, (0x0028, 0x1053), 1)

        raw = self._stage_pixels_native(n, rows, cols)
        if raw is None:
            raw = self._decode_pixels_parallel(n)

        # float32 whenever int16 cannot hold the rescaled values
        # exactly: PT (Bq/mL routinely exceeds int16 — SUV 20 at a
        # typical injection is ~90 kBq/mL) and any series whose
        # rescale is not value-preserving (slope != 1 or fractional
        # intercept — e.g. our own exporter's auto-scaled floats).
        # The reference's blanket int16 cast (read/dicom.py Read3D)
        # silently saturates/wraps these — a fixed reference bug
        # (PARITY.md deltas). Plain CT/MR (slope 1, integral
        # intercept) keeps the reference's int16.
        value_preserving = bool(
            np.all(slopes == 1.0)
            and np.all(intercepts == np.round(intercepts)))
        # NM joins PT here: SPECT counts are unsigned 16-bit, so even a
        # value-preserving rescale can exceed int16's 32767 ceiling.
        out_dtype = np.float32 \
            if (self.modality in ("PT", "NM") or not value_preserving) \
            else np.int16
        self.array = assemble_volume(raw, slopes, intercepts,
                                     ffs_op=decision["op"],
                                     out_dtype=out_dtype,
                                     device=self.device).cpu().numpy()

    def _decode_pixels_parallel(self, n):
        """Compressed-syntax fallback: decode per-slice pixel_array
        from a bounded thread pool. Every decode backend here (native
        JPEG-LS/JPEG-Lossless/DCT/RLE via ctypes, cv2 for baseline/
        J2K) releases the GIL inside the C call, so slices of a
        compressed series decode in parallel — the previous serial
        loop left an N-core host idle on exactly the archives
        (JPEG-LS/RLE-compressed CT) where decode dominates ingest.
        Slice 0 decodes first on this thread to size the arena;
        results land by index (deterministic)."""
        first = self.image_set[0].pixel_array
        raw = np.empty((n,) + first.shape, dtype=first.dtype)
        raw[0] = first
        if "PixelData" in self.image_set[0]:
            del self.image_set[0].PixelData

        def work(i):
            _slice = self.image_set[i]
            raw[i] = _slice.pixel_array
            if "PixelData" in _slice:
                del _slice.PixelData

        import os as _os
        workers = min(32, _os.cpu_count() or 1, max(n - 1, 1))
        if n > 1 and workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(work, range(1, n)))
        else:
            for i in range(1, n):
                work(i)

        # multi-frame views share ONE parent dataset whose raw
        # PixelData bytes + full decoded cache survive the per-frame
        # `del PixelData` above (that only clears the slice cache,
        # multiframe.FrameView.__delattr__); drop the parent's copy now
        # that every frame is staged, or ~2x the volume stays pinned in
        # Data.image for the image's lifetime (review finding)
        parents = {}
        for s in self.image_set:
            p = getattr(s, "_parent", None)
            if p is not None:
                parents[id(p)] = p
        for p in parents.values():
            if "PixelData" in p:
                del p.PixelData
        return raw

    def _stage_pixels_native(self, n, rows, cols):
        """Pinned-staging fast path: copy every slice's uncompressed
        16-bit LE PixelData into the (n, rows, cols) arena from a C++
        thread pool (native.gather_blocks), skipping the per-slice
        pixel_array objects. Returns None to fall back (compressed,
        synthetic/interpolated slices, odd layouts)."""
        from .. import native
        from ..dicom.parser import _ArrayTable

        if native.get_lib() is None or n == 0 or rows * cols == 0:
            return None
        ds0 = self.image_set[0]
        if int(ds0.get("BitsAllocated", 16)) != 16 \
                or int(ds0.get("SamplesPerPixel", 1)) != 1:
            return None
        dtype = np.dtype(np.int16
                         if int(ds0.get("PixelRepresentation", 0))
                         else np.uint16)
        nbytes = rows * cols * 2
        bufs, offs, szs = [], [], []
        for s in self.image_set:
            d = getattr(s, "_dict", None)
            if isinstance(d, _ArrayTable):
                row = d.row(0x7FE00010)
            else:
                return None
            if not d._little or row is None or row[2] != nbytes \
                    or not isinstance(d._buf, bytes):
                return None
            bufs.append(d._buf)
            offs.append(row[1])
            szs.append(row[2])
        raw = np.empty((n, rows, cols), dtype)
        bad = native.gather_blocks(bufs, offs, szs, raw, nbytes)
        if bad:
            return None
        return raw

    def _find_skipped_slices(self):
        """Median-gap detection + linear interpolation of synthetic slices
        with fresh SOP UIDs (reference read/dicom.py:742-827, signature
        bug fixed)."""
        if len(self.image_set) < 2:
            return

        slice_dir = np.cross(self.orientation[:3], self.orientation[3:])
        positions = np.array([np.dot(slice_dir, ds.ImagePositionPatient)
                              for ds in self.image_set])
        order = np.argsort(positions)
        self.image_set = [self.image_set[i] for i in order]
        positions = positions[order]

        diffs = np.diff(positions)
        expected_spacing = np.median(diffs)
        rebuilt = []
        self.missing_slices = []
        for i in range(len(self.image_set) - 1):
            ds1 = self.image_set[i]
            ds2 = self.image_set[i + 1]
            gap = positions[i + 1] - positions[i]
            n_expected = int(round(gap / expected_spacing))
            rebuilt.append(ds1)
            if n_expected <= 1:
                continue

            n_missing = n_expected - 1
            self.unverified = "Skipped"
            self.skipped_slice += [i + 1]
            self.missing_slices.append({
                "insert_index": len(rebuilt),
                "num_missing": n_missing,
                "between": (ds1.SOPInstanceUID, ds2.SOPInstanceUID),
            })

            img1 = ds1.pixel_array.astype(np.float32)
            img2 = ds2.pixel_array.astype(np.float32)
            pos1 = np.asarray(ds1.ImagePositionPatient, dtype=np.float64)
            pos2 = np.asarray(ds2.ImagePositionPatient, dtype=np.float64)

            for m in range(n_missing):
                alpha = (m + 1) / (n_missing + 1)
                interp = (1.0 - alpha) * img1 + alpha * img2
                interp = np.round(interp).astype(ds1.pixel_array.dtype)

                new_ds = copy.deepcopy(ds1)
                new_pos = pos1 + alpha * (pos2 - pos1)
                new_ds.ImagePositionPatient = [float(v) for v in new_pos]
                new_ds.PixelData = interp.tobytes()
                new_ds.SOPInstanceUID = generate_uid()
                if "InstanceNumber" in new_ds:
                    new_ds.InstanceNumber = ds1.InstanceNumber + m + 1
                if new_ds.file_meta is not None:
                    new_ds.file_meta.MediaStorageSOPInstanceUID = \
                        new_ds.SOPInstanceUID
                rebuilt.append(new_ds)
        rebuilt.append(self.image_set[-1])
        self.image_set = rebuilt
