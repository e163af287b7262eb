"""DICOM ingest orchestration: parallel parse, series grouping, dispatch.

Carried over from medicalimageanalysis_tpu/read/dicom.py. Group slices by
Modality -> SeriesInstanceUID -> orientation (rounded 3 dp) ->
AcquisitionNumber, sort along the dominant axis by the slice-direction
sign, merge non-overlapping gap-uniform acquisitions, then dispatch per
modality. Parsing uses the port's copies of the host core: the C++ batch
scanner (``native``) and the DICOM parser (``dicom``).

Readers, in the JAX package's order: CT, MR, PT and NM RECON TOMO
through Read3D (enhanced multi-frame files and tomo frames expanded into
per-frame views first, read/multiframe.py and read/nm.py), planar NM
through ReadNMPlanar, DX / CR / MG through ReadXRay, RF / XA through
ReadRF and US through ReadUS (read/planar.py), then RTSTRUCT through
ReadRTStruct, SEG through ReadSEG, REG through ReadREG, RTDOSE through
ReadRTDose and RTPLAN through ReadRTPlan.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..data import Data
from ..dicom import dcmread
from ..telemetry import IngestReport, trace

__all__ = ["DicomReader", "thread_process_dicom", "sort_images_by_datetime",
           "create_dose_name", "create_image_name", "create_plan_name"]

# one object per file, not grouped into series (the JAX package's
# _2D_OR_STRUCT)
_2D_OR_STRUCT = ["US", "DX", "RF", "CR", "MG", "XA", "RTSTRUCT", "SEG",
                 "REG", "RTDOSE", "RTPLAN"]


def sort_images_by_datetime():
    """Reorder Data.image / Data.image_list lexicographically by
    str(date)+str(time) (reference read/dicom.py:69-87)."""
    date_time = [
        str(Data.image[name].date) + str(Data.image[name].time)
        for name in Data.image_list
    ]
    new_key_order = [Data.image_list[idx] for idx in np.argsort(date_time)]
    Data.image = {key: Data.image[key] for key in new_key_order}
    Data.image_list = list(Data.image.keys())


def load_native_scanner():
    """The C++ batch scanner's ctypes handle (built with g++ from the
    port's ``native/dicomscan.cpp`` into ``build/torch_ext/`` on first
    use), or None without a compiler."""
    from .. import native

    return native.get_lib()


def thread_process_dicom(path, stop_before_pixels=False):
    """Tolerant single-file parse: unparseable files become []
    (reference read/dicom.py:90-111)."""
    try:
        datasets = dcmread(str(path), stop_before_pixels=stop_before_pixels)
    except Exception:
        datasets = []
    return datasets


def _sequential_name(modality, registry_list):
    """'{modality} NN' zero-padded sequential name off the registry
    length (reference read/dicom.py:2113-2178 repeats this per type)."""
    idx = len(registry_list)
    if idx < 9:
        return modality + " 0" + str(1 + idx)
    return modality + " " + str(1 + idx)


def create_image_name(modality):
    return _sequential_name(modality, Data.image_list)


def create_dose_name(modality):
    return _sequential_name(modality, Data.dose_list)


def create_plan_name(modality):
    return _sequential_name(modality, Data.plan_list)


class DicomReader(object):
    """Full DICOM pipeline: read -> group -> build -> sort.

    Parameters mirror reference read/dicom.py:114-216; ``device`` is where
    the volumes are assembled (default: the card when present).
    """

    def __init__(self, files, only_tags, only_modality, only_load_roi_names,
                 clear, device=None):
        from ..device import default_device

        self.files = files
        self.only_tags = only_tags
        self.only_load_roi_names = only_load_roi_names
        self.device = default_device() if device is None else device

        self.only_modality = (
            only_modality if only_modality is not None
            else ["CT", "MR", "PT", "NM", "US", "DX", "RF", "CR", "MG",
                  "XA", "RTSTRUCT", "SEG", "REG", "RTDOSE", "RTPLAN"]
        )

        if clear:
            Data.clear()

        self.ds = []
        self.ds_modality = {key: [] for key in self.only_modality}
        self.report = IngestReport()

    def load(self, display_time=False):
        t1 = time.time()
        images_before = set(Data.image_list)
        doses_before = set(Data.dose_list)
        plans_before = set(Data.plan_list)
        rigid_before = set(Data.rigid_list)
        deformable_before = set(Data.deformable_list)

        with trace("mia.ingest.read"):
            self.read()
        with trace("mia.ingest.group"):
            self.separate_modalities_and_images()
        with trace("mia.ingest.build"):
            self.image_creation()
        sort_images_by_datetime()

        t2 = time.time()
        r = self.report
        r.elapsed_s = t2 - t1
        r.images_created = [n for n in Data.image_list
                            if n not in images_before]
        r.doses_created = [n for n in Data.dose_list
                           if n not in doses_before]
        r.plans_created = [n for n in Data.plan_list
                           if n not in plans_before]
        r.rigid_created = [n for n in Data.rigid_list
                           if n not in rigid_before]
        r.deformable_created = [n for n in Data.deformable_list
                                if n not in deformable_before]
        for n in r.images_created:
            img = Data.image[n]
            if img.unverified:
                r.unverified[n] = img.unverified
            if img.skipped_slice:
                r.skipped_slices[n] = list(img.skipped_slice)

        if display_time:
            print("Dicom Read Time:", t2 - t1)
        return r

    def read(self):
        """Parse all files: one C++ batch scan (thread pool inside the
        native call — a single GIL release covers the whole cohort)
        with per-file Python fallback; deterministic result order."""
        paths = self.files["Dicom"] if self.files else []
        if not paths:
            return
        self.ds = self._read_batch(paths)
        if self.ds is None:
            # native library unavailable: bounded Python thread pool
            # (the reference's thread-per-file shape, read/dicom.py:202)
            workers = min(32, max(1, len(paths)))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                self.ds = list(pool.map(
                    lambda p: thread_process_dicom(
                        p, stop_before_pixels=self.only_tags),
                    paths))
        self.report.files_total = len(paths)

        def _is_dicomdir(d):
            # Media Storage Directory: legitimately Modality-less —
            # group-0004 file-set tags identify it (present on
            # virtually every clinical CD; review finding: the
            # truncation heuristic below misfiled it as corrupt)
            try:
                return ((0x0004, 0x1220) in d or (0x0004, 0x1130) in d
                        or (d.file_meta or {}).get(
                            "MediaStorageSOPClassUID")
                        == "1.2.840.10008.1.3.10")
            except Exception:
                return False

        # a partial dataset without a Modality tag (e.g. a file
        # truncated inside the header) can never route anywhere:
        # count it failed rather than letting it vanish silently
        # (torture-archive finding). DICOMDIRs parse fine and are
        # simply not image objects: parsed_ok, not failed.
        usable = []
        for d in self.ds:
            if not d:
                usable.append(False)
            elif (0x0008, 0x0060) in d:
                usable.append(True)
            elif _is_dicomdir(d):
                usable.append(True)
            else:
                usable.append(False)
        self.report.parsed_ok = sum(usable)
        self.report.failed_files = [p for p, u in zip(paths, usable)
                                    if not u]

    def _read_batch(self, paths):
        """File IO in a small thread pool, then ONE native batch scan;
        odd files (deflated, scan errors, table overflow) fall back to
        the tolerant per-file parser."""
        from .. import native
        from ..dicom.parser import (
            dataset_from_scan, datasets_from_scan_batch)

        if native.get_lib() is None:
            return None

        def _read_bytes(p):
            try:
                with open(str(p), "rb") as f:
                    return f.read()
            except OSError:
                return b""

        # file reads release the GIL, so a pool parallelizes them on
        # real hosts — but on a single-core box the thread churn costs
        # more than it saves (measured 28 ms threaded vs 12 ms serial
        # for 320 files): read inline there
        if (os.cpu_count() or 1) <= 1:
            bufs = [_read_bytes(p) for p in paths]
        else:
            workers = min(16, max(1, len(paths)))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                bufs = list(pool.map(_read_bytes, paths))

        res = native.scan_batch(bufs, stop_before_pixels=self.only_tags)
        if res is None:
            return None
        entries, counts, metas = res
        try:
            dss = datasets_from_scan_batch(bufs, entries, counts, metas,
                                           self.only_tags, paths)
        except Exception:
            dss = [None] * len(paths)
        out = []
        for i, p in enumerate(paths):
            ds = dss[i]
            c = int(counts[i])
            if ds is None and c >= 0 and int(metas[i][0]) != 3:
                # scanned fine but not batch-flat (sequences, implicit
                # VR, odd ordering): build from the entry table per
                # file. .copy(): the table is a reused arena the next
                # scan_batch call overwrites (native.scan_batch)
                try:
                    ds = dataset_from_scan(bufs[i], entries[i, :c].copy(),
                                           metas[i], self.only_tags,
                                           filename=str(p))
                except Exception:
                    ds = None
            if ds is None and c != -1:  # -1 = not DICOM at all
                ds = thread_process_dicom(
                    p, stop_before_pixels=self.only_tags)
            out.append(ds if ds else [])
        return out

    # ------------------------------------------------------------------
    # grouping
    # ------------------------------------------------------------------
    def separate_modalities_and_images(self):
        """Series-grouping algorithm (reference read/dicom.py:218-382).

        Enhanced multi-frame CT/MR/PT files and NM RECON TOMO files are
        first expanded into per-frame views, as in the JAX package
        (read/dicom.py:265-283), so they flow through the same grouping
        and Read3D assembly."""
        from .multiframe import expand_multiframe, is_enhanced_multiframe
        from .nm import expand_nm_tomo, is_nm_tomo

        expanded = []
        for d in self.ds:
            if not (d and (0x0008, 0x0060) in d):
                expanded.append(d)
                continue
            mod = d["Modality"].value
            if mod in ("CT", "MR", "PT") and is_enhanced_multiframe(d):
                expanded.extend(expand_multiframe(d))
            elif mod == "NM" and is_nm_tomo(d):
                expanded.extend(expand_nm_tomo(d))
            else:
                expanded.append(d)
        self.ds = expanded

        buckets = {}
        for d in self.ds:
            if d and (0x0008, 0x0060) in d:
                mod = d["Modality"].value
                if not isinstance(mod, str):
                    # corrupt CS bytes can decode to a multi-value list
                    # (invalid DICOM) — skip the file (fuzz finding)
                    continue
                buckets.setdefault(mod, []).append(d)

        for modality in list(self.ds_modality.keys()):
            images = buckets.get(modality, [])
            if not images or modality not in self.only_modality:
                continue
            if modality in _2D_OR_STRUCT:
                self.ds_modality[modality].extend(images)
                continue
            if modality == "NM":
                # RECON TOMO frames (expanded above) carry IOP/IPP and
                # take the 3D grouping; planar / whole-body / gated
                # frames stack as they are (bare datasets, which
                # image_creation tells apart from grouped series)
                tomo = []
                for image in images:
                    if "ImageOrientationPatient" in image \
                            and "ImagePositionPatient" in image:
                        tomo.append(image)
                    else:
                        self.ds_modality[modality].append(image)
                images = tomo
                if not images:
                    continue

            entries = []
            for img in images:
                if ("ImageOrientationPatient" not in img
                        or "ImagePositionPatient" not in img):
                    continue
                try:
                    orient = np.asarray(
                        img["ImageOrientationPatient"].value,
                        dtype=np.float64)
                    pos = np.asarray(img["ImagePositionPatient"].value,
                                     dtype=np.float64)
                    if orient.shape != (6,) or pos.shape != (3,):
                        raise ValueError("bad multiplicity")
                    series_uid = img["SeriesInstanceUID"].value
                except (TypeError, ValueError, KeyError):
                    # corrupt geometry/UID tags: skip the slice like the
                    # reference skips unparseable files (fuzz finding)
                    continue
                acq = img.get("AcquisitionNumber")
                acq = np.int64(acq) if acq is not None else np.int64(1)
                entries.append((series_uid, acq, orient, pos, img))
            if not entries:
                continue

            series_uids = sorted({e[0] for e in entries})
            for series in series_uids:
                series_entries = [e for e in entries if e[0] == series]
                self._group_series(modality, series_entries)

    def _group_series(self, modality, series_entries):
        orientations = np.asarray([e[2] for e in series_entries])
        rounded = np.round(orientations, 3)
        _, first_idx = np.unique(rounded, axis=0, return_index=True)
        for ind in sorted(first_idx):
            key = rounded[ind]
            sel = np.all(rounded == key, axis=1)
            group = [series_entries[i] for i in np.nonzero(sel)[0]]
            self._group_orientation(modality, group)

    def _group_orientation(self, modality, group):
        orientation = group[0][2]
        x = np.abs(orientation[0]) + np.abs(orientation[3])
        y = np.abs(orientation[1]) + np.abs(orientation[4])
        z = np.abs(orientation[2]) + np.abs(orientation[5])
        slice_direction = np.cross(orientation[:3], orientation[3:])

        if x < y and x < z:
            comp, ascending = 0, slice_direction[0] > 0
        elif y < x and y < z:
            comp, ascending = 1, slice_direction[1] > 0
        else:
            comp, ascending = 2, slice_direction[2] > 0

        acq_values = sorted({int(e[1]) for e in group})
        acq_images = []
        acq_ranges = []
        for acq in acq_values:
            sub = [e for e in group if int(e[1]) == acq]
            for phase_sub in self._split_temporal_phases(sub, comp):
                positions = np.asarray([e[3][comp] for e in phase_sub])
                order = np.argsort(positions)
                if not ascending:
                    order = order[::-1]
                sorted_sub = [phase_sub[i][4] for i in order]
                sorted_pos = positions[order]
                acq_images.append(sorted_sub)
                acq_ranges.append((float(sorted_pos[0]),
                                   float(sorted_pos[-1])))

        if len(acq_images) <= 1:
            for img in acq_images:
                self.ds_modality[modality].append(img)
            return

        # pairwise overlap detection along the slice axis
        # (reference read/dicom.py:318-355)
        overlap = False
        for ii in range(len(acq_ranges)):
            for jj in range(len(acq_ranges)):
                if ii == jj:
                    continue
                b_first, b_last = acq_ranges[ii]
                c_first, c_last = acq_ranges[jj]
                if b_first > c_first and b_first > c_last:
                    pass
                elif b_last < c_first and b_last < c_last:
                    pass
                else:
                    overlap = True

        if overlap:
            for img in acq_images:
                self.ds_modality[modality].append(img)
            return

        # non-overlapping: merge if inter-acquisition gaps are uniform
        # (reference read/dicom.py:356-375)
        starts = np.asarray([r[0] for r in acq_ranges])
        order = np.argsort(starts)
        gaps = [acq_ranges[order[ii + 1]][0] - acq_ranges[order[ii]][1]
                for ii in range(len(order) - 1)]
        if len(np.unique(np.round(gaps, 2))) == 1:
            merged = []
            for ii in order:
                merged.extend(acq_images[ii])
            self.ds_modality[modality].append(merged)
        else:
            for img in acq_images:
                self.ds_modality[modality].append(img)

    def _split_temporal_phases(self, sub, comp):
        """4D-series phase splitting (BEYOND-PARITY).

        A respiratory/cardiac-gated 4D acquisition stores K phases of
        the same couch range inside ONE series — often inside one
        AcquisitionNumber (Philips-style), where every slice location
        appears K times. The reference's grouper (read/dicom.py:285)
        only splits on AcquisitionNumber, so such a series collapses
        into a single stack of duplicated positions whose mean-pitch
        spacing math and skipped-slice interpolation both break.

        Here, when every location in an acquisition repeats exactly K
        times, the stack splits into K single-phase stacks keyed by
        (in priority order) TemporalPositionIdentifier, TriggerTime, or
        the per-location occurrence rank ordered by InstanceNumber.
        Ragged duplication (only some locations repeated) is left to
        the existing irregular-spacing machinery.
        """
        from ..dicom.dataset import value_or

        if len(sub) < 2:
            return [sub]
        pos = np.asarray([e[3][comp] for e in sub], np.float64)
        from ..config import config
        quant = np.round(pos / config.spacing_tolerance_mm).astype(np.int64)
        uniq, counts = np.unique(quant, return_counts=True)
        k = int(counts.max())
        if k == 1 or not np.all(counts == k):
            return [sub]
        n_loc = len(uniq)

        # explicit temporal keys first
        for keyword, caster in (("TemporalPositionIdentifier", int),
                                ("TriggerTime", float)):
            vals = [value_or(e[4], keyword, None) for e in sub]
            if any(v is None for v in vals):
                continue
            try:
                vals = [caster(v) for v in vals]
            except (TypeError, ValueError):
                continue
            distinct = sorted(set(vals))
            if len(distinct) != k:
                continue
            groups = [[e for e, v in zip(sub, vals) if v == key]
                      for key in distinct]
            if all(len(g) == n_loc for g in groups):
                return groups

        # fallback: occurrence rank per location, ordered by
        # InstanceNumber (acquisition order within each couch position).
        # All-or-nothing on the parsed numbers: a single corrupt
        # InstanceNumber replaced by its list index would rank ahead of
        # its real-numbered siblings and shuffle one slice into the
        # wrong phase — if any fails to parse, the whole stack falls
        # back to file-enumeration order consistently.
        inst = []
        for e in sub:
            v = value_or(e[4], "InstanceNumber", None)
            try:
                inst.append(int(v))
            except (TypeError, ValueError):
                inst = list(range(len(sub)))
                break
        order = np.lexsort((np.asarray(inst), quant))
        groups = [[] for _ in range(k)]
        for start in range(0, len(order), k):
            block = order[start:start + k]
            for rank, idx in enumerate(block):
                groups[rank].append(sub[idx])
        return groups

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def _build_series(self, builder, image_set, *args, **kwargs):
        """Tolerant-ingest wrapper: a series whose pixel data fails to
        decode (hostile/corrupt stream) is recorded and skipped rather
        than aborting the whole read (reference swallow-and-continue
        policy, SURVEY §5; builders register into Data only after a
        successful assemble, so no partial state leaks)."""
        try:
            return builder(image_set, *args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - untrusted input boundary
            # slice-level tolerance: ONE corrupt slice (e.g. a file
            # truncated mid-PixelData that still parsed a full header)
            # must not poison its whole series (torture-archive
            # finding). Triage decodability per slice, drop the bad
            # ones, retry once, and flag the rebuilt image.
            if isinstance(image_set, list) and len(image_set) > 1 \
                    and not self.only_tags:
                good, bad = [], []
                for d in image_set:
                    try:
                        d.pixel_array
                        good.append(d)
                    except Exception:  # noqa: BLE001
                        bad.append(d)
                if bad and good:
                    badpaths = [getattr(d, "filename", "<memory>")
                                for d in bad]
                    try:
                        obj = builder(good, *args, **kwargs)
                    except Exception as retry_exc:  # noqa: BLE001
                        exc = retry_exc
                    else:
                        self.report.failed_files.extend(badpaths)
                        self.report.warn(
                            f"dicom: dropped {len(bad)} undecodable "
                            f"slice(s) from a {builder.__name__} "
                            f"series: {badpaths}")
                        name = getattr(obj, "image_name", None)
                        if name is not None and name in Data.image \
                                and Data.image[name].unverified is None:
                            Data.image[name].unverified = "CorruptSlices"
                        return obj
            paths = [getattr(d, "filename", "<memory>")
                     for d in (image_set if isinstance(image_set, list)
                               else [image_set])]
            self.report.failed_series.append(
                {"builder": builder.__name__, "files": paths,
                 "error": f"{type(exc).__name__}: {exc}"})
            self.report.warn(
                f"dicom: {builder.__name__} failed for {len(paths)} "
                f"file(s): {type(exc).__name__}: {exc}")
            return None

    def image_creation(self):
        """Dispatch grouped datasets to per-modality builders
        (reference read/dicom.py:384-425): images first (volumes, then
        the planar modalities), then RTSTRUCTs and
        SEGs onto their matching image, then REG registrations, RTDOSE
        grids and RTPLAN summaries."""
        from .nm import ReadNMPlanar
        from .planar import ReadRF, ReadUS, ReadXRay
        from .volume3d import Read3D

        for modality in ["CT", "MR", "PT", "NM", "DX", "RF", "CR", "MG",
                         "XA", "US"]:
            for image_set in self.ds_modality.get(modality, []):
                if modality in ("CT", "MR", "PT") or (
                        modality == "NM" and isinstance(image_set, list)):
                    # a grouped NM RECON TOMO series is a list of frame
                    # views, assembled on the card like CT
                    self._build_series(Read3D, image_set, self.only_tags,
                                       device=self.device)
                elif modality == "NM":
                    self._build_series(ReadNMPlanar, image_set,
                                       self.only_tags)
                elif modality in ("DX", "CR", "MG"):
                    self._build_series(ReadXRay, image_set, self.only_tags)
                elif modality in ("RF", "XA"):
                    self._build_series(ReadRF, image_set, self.only_tags)
                else:
                    self._build_series(ReadUS, image_set, self.only_tags)

        if self.ds_modality.get("RTSTRUCT"):
            from .rtstruct import ReadRTStruct
            for image_set in self.ds_modality["RTSTRUCT"]:
                read_rtstruct = self._build_series(
                    ReadRTStruct, image_set, self.only_tags,
                    only_load_roi_names=self.only_load_roi_names)
                if read_rtstruct is None:
                    pass
                elif read_rtstruct.match_image_name is not None:
                    Data.image[read_rtstruct.match_image_name] \
                        .input_rtstruct(read_rtstruct)
                else:
                    self.report.unmatched_rtstructs.append(
                        read_rtstruct.filepaths)
                    print("dicom: rtstruct has no matching image")

        if self.ds_modality.get("SEG"):
            from .seg import ReadSEG
            for image_set in self.ds_modality["SEG"]:
                read_seg = self._build_series(
                    ReadSEG, image_set, self.only_tags,
                    only_load_roi_names=self.only_load_roi_names,
                    device=self.device)
                if read_seg is None:
                    pass
                elif read_seg.match_image_name is not None:
                    if not self.only_tags:
                        Data.image[read_seg.match_image_name].input_seg(
                            read_seg)
                    if read_seg.skipped_frames:
                        self.report.warn(
                            f"dicom: SEG skipped "
                            f"{read_seg.skipped_frames} off-grid "
                            f"frame(s)")
                else:
                    self.report.unmatched_segs.append(read_seg.filepaths)
                    print("dicom: seg has no matching image")

        if self.ds_modality.get("REG"):
            from .reg import ReadREG
            for image_set in self.ds_modality["REG"]:
                self._build_series(ReadREG, image_set, self.only_tags,
                                   device=self.device)

        if self.ds_modality.get("RTDOSE"):
            from .rtdose import ReadRTDose
            for image_set in self.ds_modality["RTDOSE"]:
                self._build_series(ReadRTDose, image_set, self.only_tags,
                                   device=self.device)

        if self.ds_modality.get("RTPLAN"):
            from .rtplan import ReadRTPlan
            for image_set in self.ds_modality["RTPLAN"]:
                self._build_series(ReadRTPlan, image_set, self.only_tags)

