# Copied from medicalimageanalysis_tpu/dicom/parser.py.
"""DICOM binary parser (Part 10 + raw datasets).

Own implementation replacing pydicom.dcmread for this framework. Handles
implicit/explicit VR little endian, explicit big endian, deflated, and
encapsulated (RLE/JPEG-family) pixel data framing. Pixel decode itself lives
in :mod:`.pixels`.

API mirrors the subset the reference uses (reference read/dicom.py:90-111):
``dcmread(path, stop_before_pixels=False)`` plus a ``specific_tags`` filter.
"""

from __future__ import annotations

import struct
import zlib
from bisect import bisect_left

import numpy as np

from . import uids
from .dataset import DataElement, Dataset, FileMetaDataset, Sequence
from .dictionary import tag_to_vr

# VRs whose explicit encoding uses a 2-byte reserved field + 4-byte length
_LONG_VRS = {"OB", "OW", "OF", "OD", "OL", "OV", "SQ", "UC", "UR", "UT", "UN"}
_STRING_VRS = {"AE", "AS", "CS", "DA", "DT", "LO", "LT", "PN", "SH", "ST",
               "TM", "UC", "UR", "UT"}

_ITEM = 0xFFFEE000
_ITEM_DELIM = 0xFFFEE00D
_SEQ_DELIM = 0xFFFEE0DD
_PIXEL_DATA = 0x7FE00010


class InvalidDicomError(Exception):
    pass


def _convert_value(vr, raw, little):
    """Raw bytes -> python value per VR."""
    if vr in _STRING_VRS:
        s = raw.decode("latin-1", errors="replace").rstrip(" \x00")
        if "\\" in s:
            return s.split("\\")
        return s
    if vr == "UI":
        s = raw.decode("latin-1", errors="replace").rstrip(" \x00")
        return s.split("\\") if "\\" in s else s
    if vr == "DS":
        s = raw.decode("latin-1", errors="replace").strip(" \x00")
        if not s:
            return None
        parts = s.split("\\")
        try:
            vals = [float(p) for p in parts if p.strip()]
        except ValueError:
            # corrupt numeric string: a partial list would silently
            # change the multiplicity (IOP/IPP geometry!), so the whole
            # value is treated as absent — consumers skip the dataset
            # like the reference skips unparseable files (fuzz finding)
            return None
        return vals if len(vals) > 1 else (vals[0] if vals else None)
    if vr == "IS":
        s = raw.decode("latin-1", errors="replace").strip(" \x00")
        if not s:
            return None
        parts = s.split("\\")
        try:
            vals = [int(float(p)) for p in parts if p.strip()]
        except ValueError:
            return None
        return vals if len(vals) > 1 else (vals[0] if vals else None)
    order = "<" if little else ">"
    if vr in ("US", "SS", "UL", "SL", "FL", "FD", "SV", "UV"):
        fmt = {"US": "u2", "SS": "i2", "UL": "u4", "SL": "i4",
               "FL": "f4", "FD": "f8", "SV": "i8", "UV": "u8"}[vr]
        arr = np.frombuffer(raw, dtype=order + fmt)
        if arr.size == 1:
            return arr[0].item()
        return arr.tolist()
    if vr == "AT":
        arr = np.frombuffer(raw, dtype=order + "u2")
        tags = [((int(arr[i]) << 16) | int(arr[i + 1]))
                for i in range(0, len(arr) - 1, 2)]
        return tags if len(tags) > 1 else (tags[0] if tags else None)
    # binary blobs kept raw
    return bytes(raw)


class _Reader:
    __slots__ = ("buf", "pos", "explicit", "little", "stop_before_pixels",
                 "specific")

    def __init__(self, buf, explicit, little, stop_before_pixels=False,
                 specific=None):
        self.buf = buf
        self.pos = 0
        self.explicit = explicit
        self.little = little
        self.stop_before_pixels = stop_before_pixels
        self.specific = specific

    def u16(self):
        v = struct.unpack_from("<H" if self.little else ">H", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def u32(self):
        v = struct.unpack_from("<I" if self.little else ">I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def read_tag_header(self):
        """Returns (tag, vr, length)."""
        group = self.u16()
        elem = self.u16()
        tag = (group << 16) | elem
        if group == 0xFFFE:
            length = self.u32()
            return tag, None, length
        if self.explicit:
            vr = self.buf[self.pos:self.pos + 2].decode("ascii", errors="replace")
            self.pos += 2
            if vr in _LONG_VRS:
                self.pos += 2
                length = self.u32()
            else:
                length = self.u16()
        else:
            vr = tag_to_vr(tag)
            length = self.u32()
        return tag, vr, length

    def parse_dataset(self, end=None, top_level=False):
        ds = Dataset()
        n = len(self.buf) if end is None else end
        while self.pos + 8 <= n:
            start = self.pos
            tag, vr, length = self.read_tag_header()

            if tag == _ITEM_DELIM or tag == _SEQ_DELIM:
                # stray delimiter at this level: caller handles; rewind & stop
                self.pos = start
                break

            if top_level and self.stop_before_pixels and tag >= _PIXEL_DATA:
                break

            if vr is None or vr == "SQ" or (vr == "UN" and length == 0xFFFFFFFF):
                value = self.parse_sequence(length)
                ds[tag] = DataElement(tag, "SQ", value)
                continue

            if length == 0xFFFFFFFF:
                # encapsulated pixel data (or undefined-length OB)
                frags = self.parse_fragments()
                ds[tag] = DataElement(tag, vr, frags)
                continue

            raw = self.buf[self.pos:self.pos + length]
            self.pos += length

            if self.specific is not None and tag not in self.specific \
                    and tag != _PIXEL_DATA:
                continue

            if tag == _PIXEL_DATA or vr in ("OB", "OW", "OF", "OD", "OL", "OV"):
                ds[tag] = DataElement(tag, vr, bytes(raw))
            else:
                ds[tag] = DataElement(tag, vr, _convert_value(vr, raw, self.little))
        return ds

    def parse_sequence(self, length):
        seq = Sequence()
        seq_end = None if length == 0xFFFFFFFF else self.pos + length
        n = len(self.buf)
        while self.pos + 8 <= (seq_end if seq_end is not None else n):
            tag, _, ilen = self.read_tag_header()
            if tag == _SEQ_DELIM:
                break
            if tag != _ITEM:
                raise InvalidDicomError(
                    f"expected Item tag in sequence, got {tag:08X}")
            if ilen == 0xFFFFFFFF:
                item = self.parse_dataset()
                # consume the item delimiter
                tag2, _, _ = self.read_tag_header()
                if tag2 != _ITEM_DELIM:
                    raise InvalidDicomError("missing item delimiter")
            else:
                item_end = self.pos + ilen
                item = self.parse_dataset(end=item_end)
                self.pos = item_end
            seq.append(item)
            if seq_end is not None and self.pos >= seq_end:
                break
        if seq_end is not None:
            self.pos = seq_end
        return seq

    def parse_fragments(self):
        """Encapsulated pixel data: returns list of fragment bytes
        (first item = basic offset table, dropped)."""
        frags = []
        first = True
        while self.pos + 8 <= len(self.buf):
            tag, _, ilen = self.read_tag_header()
            if tag == _SEQ_DELIM:
                break
            if tag != _ITEM:
                raise InvalidDicomError("bad encapsulated pixel data item")
            raw = self.buf[self.pos:self.pos + ilen]
            self.pos += ilen
            if first:
                first = False  # basic offset table — ignored
                continue
            frags.append(bytes(raw))
        return frags


class LazyElement(DataElement):
    """DataElement whose value converts from the file buffer on first
    access (zero-copy until touched) — fed by the native scanner."""

    __slots__ = ("_buf", "_off", "_len", "_little", "_value")

    def __init__(self, tag, vr, buf, off, length, little):
        self.tag = tag
        self.VR = vr
        self._buf = buf
        self._off = off
        self._len = length
        self._little = little
        self._value = _UNSET

    @property
    def value(self):
        if self._value is _UNSET:
            raw = self._buf[self._off:self._off + self._len]
            if self.tag == _PIXEL_DATA or self.VR in (
                    "OB", "OW", "OF", "OD", "OL", "OV", "UN"):
                self._value = bytes(raw)
            else:
                self._value = _convert_value(self.VR, raw, self._little)
        return self._value

    @value.setter
    def value(self, v):
        self._value = v

    def __deepcopy__(self, memo):
        # materialize: the _UNSET sentinel loses identity under deepcopy
        # and the buffer reference need not be carried into copies
        import copy as _copy
        return DataElement(self.tag, self.VR, _copy.deepcopy(self.value,
                                                             memo))


_UNSET = object()

_VR_ITEM = 0xFFFEE000
_VR_ITEM_END = 0xFFFEE00D
_VR_SEQ_END = 0xFFFEE0DD


class _ArrayTable:
    """tag -> DataElement mapping backed directly by the native
    scanner's structured entry arrays: ZERO per-tag Python objects are
    built at parse time (the tolist/dict build was the ingest hot spot
    at cohort scale). Lookups binary-search the tag column; touched or
    assigned elements live in a small overlay dict."""

    __slots__ = ("_buf", "_tags", "_vr", "_off", "_len", "_little",
                 "_overlay", "_deleted", "_extra", "_keys")

    def __init__(self, buf, entries, little):
        tags = entries["tag"].astype(np.int64)
        if tags.size and not np.all(tags[1:] >= tags[:-1]):
            order = np.argsort(tags, kind="stable")
            entries = entries[order]
            tags = tags[order]
        self._buf = buf
        self._tags = tags
        self._vr = entries["vr"]
        self._off = entries["off"]
        self._len = entries["len"]
        self._little = little
        self._overlay = {}      # tag -> element (cache + assignments)
        self._deleted = None    # base tags removed
        self._extra = None      # assigned tags not present in base
        self._keys = None       # cached python-int base keys

    @classmethod
    def from_columns(cls, buf, tags64, vr, off, len_, little):
        """Zero-check constructor for the batch (columnar) ingest path:
        the caller has already verified ascending tag order and done the
        int64 conversion for the WHOLE cohort in one vectorized pass, so
        per-file construction is pure attribute assignment."""
        self = cls.__new__(cls)
        self._buf = buf
        self._tags = tags64
        self._vr = vr
        self._off = off
        self._len = len_
        self._little = little
        self._overlay = {}
        self._deleted = None
        self._extra = None
        self._keys = None
        return self

    # -- lookup ---------------------------------------------------------
    def _find(self, tag):
        # bisect on the cached python-int list beats np.searchsorted's
        # scalar boxing round trip at per-tag-access granularity
        keys = self._keys
        if keys is None:
            keys = self._keys = self._tags.tolist()
        i = bisect_left(keys, tag)
        if i < len(keys) and keys[i] == tag:
            return i
        return -1

    def row(self, tag):
        """(vr_code, off, len) of the ORIGINAL file bytes, or None.

        Returns None when the element was deleted OR reassigned
        (overlay): stale buffer offsets must never be staged after
        `ds.PixelData = ...` (self-review finding)."""
        if self._deleted and tag in self._deleted:
            return None
        el = self._overlay.get(tag)
        if el is not None and not isinstance(el, LazyElement):
            return None
        i = self._find(tag)
        if i < 0:
            return None
        return (int(self._vr[i]), int(self._off[i]), int(self._len[i]))

    def _materialize(self, tag, i):
        vr_code = int(self._vr[i])
        vr = (chr(vr_code & 0xFF) + chr(vr_code >> 8)) if vr_code \
            else tag_to_vr(tag)
        el = LazyElement(tag, vr, self._buf, int(self._off[i]),
                         int(self._len[i]), self._little)
        self._overlay[tag] = el
        return el

    def __contains__(self, tag):
        if tag in self._overlay:
            return True
        if self._deleted and tag in self._deleted:
            return False
        return self._find(tag) >= 0

    def __getitem__(self, tag):
        el = self._overlay.get(tag)
        if el is not None:
            return el
        if self._deleted and tag in self._deleted:
            raise KeyError(tag)
        i = self._find(tag)
        if i < 0:
            raise KeyError(tag)
        return self._materialize(tag, i)

    def get(self, tag, default=None):
        try:
            return self[tag]
        except KeyError:
            return default

    def __setitem__(self, tag, el):
        if self._deleted:
            self._deleted.discard(tag)
        if self._find(tag) < 0:
            if self._extra is None:
                self._extra = {}
            self._extra[tag] = True
        self._overlay[tag] = el

    def __delitem__(self, tag):
        if tag not in self:  # dict contract (review finding)
            raise KeyError(tag)
        self._overlay.pop(tag, None)
        if self._extra and tag in self._extra:
            del self._extra[tag]
            return
        if self._find(tag) >= 0:
            if self._deleted is None:
                self._deleted = set()
            self._deleted.add(tag)

    def pop(self, tag, *default):
        """dict-API pop (dcmwrite's encapsulated path needs it)."""
        try:
            el = self[tag]
        except KeyError:
            if default:
                return default[0]
            raise
        del self[tag]
        return el

    def setdefault(self, tag, default=None):
        try:
            return self[tag]
        except KeyError:
            self[tag] = default
            return default

    def update(self, other):
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v

    def _base_keys(self):
        if self._keys is None:
            self._keys = self._tags.tolist()
        return self._keys

    def __iter__(self):
        dele = self._deleted
        if dele:
            for t in self._base_keys():
                if t not in dele:
                    yield t
        else:
            yield from self._base_keys()
        if self._extra:
            yield from self._extra

    def __len__(self):
        return (self._tags.shape[0]
                - (len(self._deleted) if self._deleted else 0)
                + (len(self._extra) if self._extra else 0))

    def keys(self):
        return list(self)

    def values(self):
        return [self[t] for t in self]

    def items(self):
        return [(t, self[t]) for t in self]

    def __deepcopy__(self, memo):
        import copy as _copy
        out = {}
        for t in self:
            out[t] = _copy.deepcopy(self[t], memo)
        return out


def _build_from_entries(buf, entries, little, stop_before_pixels,
                        specific):
    """Reconstruct a Dataset tree from the native scanner's flat
    (tag, vr, depth, off, len) table."""
    # fast path: flat dataset (no sequences/fragments) -> one vectorized
    # index, elements materialize on first access (the CT-slice case).
    # All control pseudo-tags live in group FFFE, so one shift+compare
    # replaces the np.isin membership test (hot: 2 calls per file)
    if specific is None and len(entries) \
            and not entries["depth"].any() \
            and not (entries["tag"] >> 16 == 0xFFFE).any() \
            and not (entries["len"] == 0xFFFFFFFFFFFFFFFF).any():
        # implicit-VR sequences need the dictionary; fall back if any
        vrs = entries["vr"]
        if vrs.all():  # explicit VR everywhere: no SQ ambiguity
            implicit_sq = False
        else:
            implicit_sq = any(int(v) == 0 and tag_to_vr(int(t)) == "SQ"
                              for t, v in zip(entries["tag"], vrs))
        if not implicit_sq:
            root = Dataset()
            object.__setattr__(root, "_dict",
                               _ArrayTable(buf, entries, little))
            return root

    root = Dataset()
    stack = [root]        # dataset stack
    seq_stack = []        # open Sequence objects
    frag_stack = []       # open fragment lists
    n = len(entries)
    i = 0
    while i < n:
        e = entries[i]
        tag = int(e["tag"])
        vr_code = int(e["vr"])
        vr = (chr(vr_code & 0xFF) + chr(vr_code >> 8)) if vr_code else None
        off = int(e["off"])
        length = int(e["len"])
        i += 1

        if tag == _VR_ITEM:
            if vr == "FR":  # pixel-data fragment
                frag_stack[-1].append(bytes(buf[off:off + length]))
                continue
            item = Dataset()
            seq_stack[-1].append(item)
            stack.append(item)
            continue
        if tag == _VR_ITEM_END:
            if len(stack) > 1:
                stack.pop()
            continue
        if tag == _VR_SEQ_END:
            if frag_stack:
                frag_stack.pop()
            elif seq_stack:
                seq_stack.pop()
            continue

        if vr == "SQ" or (vr is None and length == 0xFFFFFFFFFFFFFFFF):
            seq = Sequence()
            stack[-1][tag] = DataElement(tag, "SQ", seq)
            seq_stack.append(seq)
            continue

        if length == 0xFFFFFFFFFFFFFFFF:
            frags = []
            stack[-1][tag] = DataElement(tag, vr or "OB", frags)
            frag_stack.append(frags)
            continue

        if vr is None:
            vr = tag_to_vr(tag)
            if vr == "SQ":
                # defined-length implicit sequence: the scanner can't
                # know the VR without the dictionary — sub-parse here
                r = _Reader(buf, explicit=False, little=little)
                r.pos = off
                stack[-1][tag] = DataElement(tag, "SQ",
                                             r.parse_sequence(length))
                continue
        if specific is not None and len(stack) == 1 \
                and tag not in specific and tag != _PIXEL_DATA:
            continue
        stack[-1][tag] = LazyElement(tag, vr, buf, off, length, little)
    return root


def dcmread(path_or_bytes, stop_before_pixels=False, specific_tags=None,
            force=False, use_native=True):
    """Read a DICOM file into a :class:`Dataset`.

    Parameters mirror the pydicom call the reference makes at
    read/dicom.py:90-111 (``stop_before_pixels`` backs ``only_tags``).
    The native C++ scanner (native/dicomscan.cpp) handles the element
    walk when available; values convert lazily on first access.
    """
    filename = None
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        buf = bytes(path_or_bytes)
    else:
        filename = str(path_or_bytes)
        with open(filename, "rb") as f:
            buf = f.read()

    if use_native:
        ds = _dcmread_native(buf, stop_before_pixels, specific_tags)
        if ds is not None:
            ds.filename = filename
            return ds

    specific = None
    if specific_tags is not None:
        specific = set()
        for t in specific_tags:
            if isinstance(t, tuple):
                specific.add((t[0] << 16) | t[1])
            else:
                specific.add(t)

    if len(buf) > 132 and buf[128:132] == b"DICM":
        meta_reader = _Reader(buf, explicit=True, little=True)
        meta_reader.pos = 132
        # file meta group length tells us where meta ends
        tag, vr, length = meta_reader.read_tag_header()
        if tag != 0x00020000:
            raise InvalidDicomError("missing FileMetaInformationGroupLength")
        group_len = _convert_value(vr, buf[meta_reader.pos:meta_reader.pos + length], True)
        meta_reader.pos += length
        meta_end = meta_reader.pos + group_len
        meta = meta_reader.parse_dataset(end=meta_end)
        fm = FileMetaDataset()
        fm._dict.update(meta._dict)
        fm.add(0x00020000, "UL", group_len)

        ts = fm.get("TransferSyntaxUID", uids.ExplicitVRLittleEndian)
        body = buf
        start = meta_end
        if ts == uids.DeflatedExplicitVRLittleEndian:
            body = zlib.decompress(buf[meta_end:], -15)
            start = 0
            ts = uids.ExplicitVRLittleEndian
        explicit = ts != uids.ImplicitVRLittleEndian
        little = ts != uids.ExplicitVRBigEndian
        reader = _Reader(body, explicit=explicit, little=little,
                         stop_before_pixels=stop_before_pixels,
                         specific=specific)
        reader.pos = start
        ds = reader.parse_dataset(top_level=True)
        ds.file_meta = fm
    elif force or _looks_like_raw_dicom(buf):
        # raw dataset without preamble: sniff explicit vs implicit
        explicit = buf[4:6].isalpha() and buf[4:6].decode("ascii", "replace") \
            in (_LONG_VRS | _STRING_VRS | {"UI", "US", "UL", "SS", "SL",
                                           "FL", "FD", "DS", "IS", "AT"})
        reader = _Reader(buf, explicit=explicit, little=True,
                         stop_before_pixels=stop_before_pixels,
                         specific=specific)
        ds = reader.parse_dataset(top_level=True)
        ds.file_meta = None
    else:
        raise InvalidDicomError("not a DICOM file")

    ds.filename = filename
    return ds


def _dcmread_native(buf, stop_before_pixels, specific_tags):
    """Fast path through the C++ scanner; returns None to fall back."""
    try:
        from ..native import scan
    except Exception:
        return None
    result = scan(buf, stop_before_pixels=stop_before_pixels)
    if result is None:
        return None
    entries, meta4 = result
    return dataset_from_scan(buf, entries, meta4, stop_before_pixels,
                             specific_tags)


def dataset_from_scan(buf, entries, meta4, stop_before_pixels=False,
                      specific_tags=None, filename=None):
    """Build a Dataset from a native scanner entry table (the tail of
    the fast path, shared with the batch ingest pool). Returns None for
    transfer syntaxes the scanner defers to Python (deflated)."""
    ts_code = int(meta4[0])
    if ts_code == 3:
        return None  # deflated: Python path inflates

    specific = None
    if specific_tags is not None:
        specific = set()
        for t in specific_tags:
            specific.add((t[0] << 16) | t[1] if isinstance(t, tuple)
                         else t)

    little = ts_code != 2
    # split meta entries (group 0002, always at the front) from body
    meta_mask = entries["tag"] >> 16 == 2
    meta_entries = entries[meta_mask]
    body_entries = entries[~meta_mask]

    ds = _build_from_entries(buf, body_entries, little,
                             stop_before_pixels, specific)
    if len(meta_entries):
        meta = _build_from_entries(buf, meta_entries, True, False, None)
        fm = FileMetaDataset()
        # materialize through __getitem__ (meta may be a lazy TableDict
        # whose raw C-level items are unmaterialized sentinels)
        fm._dict.update({t: meta._dict[t] for t in meta._dict})
        ds.file_meta = fm
    else:
        ds.file_meta = None
    if filename is not None:
        ds.filename = filename
    return ds


def datasets_from_scan_batch(bufs, entries, counts, metas,
                             stop_before_pixels=False, filenames=None):
    """Columnar Dataset construction for a whole scanned cohort.

    ``dataset_from_scan`` per file spends most of its time in small
    numpy reductions (meta split, flatness checks, tag sort check) whose
    per-call overhead dwarfs the work at ~40 tags/file. Here those run
    ONCE as 2-D reductions over the native scanner's (n_files,
    max_entries) table, and per-file construction collapses to slicing
    row views into :meth:`_ArrayTable.from_columns`. The file meta group
    becomes a *lazy* ``_ArrayTable`` too (the per-element materialization
    loop was ~20% of parse; consumers only ever touch
    TransferSyntaxUID/MediaStorageSOPInstanceUID).

    Returns a list aligned with ``bufs``: a Dataset, or None where the
    file needs the tolerant per-file path (scan error, deflated stream,
    implicit-VR sequences, out-of-order tags).
    """
    cnt = np.maximum(np.asarray(counts, np.int64), 0)
    # the scan table is sized for the worst file (typically 2048
    # columns); real slice headers hold ~40 tags, so slice the table to
    # the occupied prefix before any 2-D reduction (50x less work)
    m = max(int(cnt.max()) if cnt.size else 0, 1)
    n = entries.shape[0]
    # contiguous copies of the occupied prefix: the input table is a
    # reused arena (native.scan_batch) that the NEXT cohort overwrites,
    # so nothing the datasets keep may alias it — and the copies make
    # every reduction below contiguous and 50x smaller than the table
    tags64 = entries["tag"][:, :m].astype(np.int64)
    vrs = np.ascontiguousarray(entries["vr"][:, :m])
    lens = np.ascontiguousarray(entries["len"][:, :m])
    offs = np.ascontiguousarray(entries["off"][:, :m])
    depths = np.ascontiguousarray(entries["depth"][:, :m])
    valid = np.arange(m, dtype=np.int64)[None, :] < cnt[:, None]
    grp = tags64 >> 16

    # the flat fast path of _build_from_entries, vectorized: no nesting,
    # no FFFE control tags (and no group <2 oddities that would break
    # the sorted meta-prefix split), no undefined lengths, explicit VR
    # everywhere (so no implicit-SQ dictionary walk), ascending tags
    flat = ~(depths.astype(bool) & valid).any(axis=1)
    flat &= ~(((grp == 0xFFFE) | (grp < 2)) & valid).any(axis=1)
    flat &= ~((lens == np.uint64(0xFFFFFFFFFFFFFFFF)) & valid).any(axis=1)
    flat &= ((vrs != 0) | ~valid).all(axis=1)
    if m > 1:
        flat &= ((tags64[:, 1:] >= tags64[:, :-1])
                 | ~valid[:, 1:]).all(axis=1)
    meta_counts = ((grp == 2) & valid).sum(axis=1)
    ts_codes = np.asarray(metas)[:, 0].astype(np.int64)
    ok = flat & (np.asarray(counts) >= 0) & (ts_codes != 3) & (cnt > 0)

    out = []
    for i in range(n):
        if not ok[i]:
            out.append(None)
            continue
        c = int(cnt[i])
        mc = int(meta_counts[i])
        buf = bufs[i]
        ds = Dataset()
        object.__setattr__(ds, "_dict", _ArrayTable.from_columns(
            buf, tags64[i, mc:c], vrs[i, mc:c], offs[i, mc:c],
            lens[i, mc:c], bool(ts_codes[i] != 2)))
        if mc:
            fm = FileMetaDataset()
            object.__setattr__(fm, "_dict", _ArrayTable.from_columns(
                buf, tags64[i, :mc], vrs[i, :mc], offs[i, :mc],
                lens[i, :mc], True))
            ds.file_meta = fm
        if filenames is not None:
            ds.filename = str(filenames[i])
        out.append(ds)
    return out


def _looks_like_raw_dicom(buf):
    if len(buf) < 8:
        return False
    group = struct.unpack_from("<H", buf, 0)[0]
    return group in (0x0002, 0x0008, 0x0010, 0x0018, 0x0020, 0x0028)
