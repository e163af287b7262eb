"""A small DICOM Part 10 writer: Explicit VR Little Endian, defined lengths.

The ingest cell writes its study with this writer, which shares nothing
with the program's own DICOM code, so that a fault that a writer and a
reader of the program share (an axis swapped, a scaling misread) cannot
cancel out. A dataset is a dict ``{tag: (VR, value)}``; a sequence's
value is a list of such dicts. Elements are written in tag order.
"""

from __future__ import annotations

import struct

import numpy as np

EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
CT_IMAGE = "1.2.840.10008.5.1.4.1.1.2"
RT_STRUCT = "1.2.840.10008.5.1.4.1.1.481.3"
RT_DOSE = "1.2.840.10008.5.1.4.1.1.481.2"
IMPLEMENTATION = "1.2.826.0.1.3680043.10.1017.0.1"
UID_ROOT = "1.2.826.0.1.3680043.10.1017"

LONG_VRS = {"OB", "OD", "OF", "OL", "OV", "OW", "SQ", "UC", "UN", "UR",
            "UT"}
TEXT_VRS = {"AE", "AS", "CS", "DA", "DS", "DT", "IS", "LO", "LT", "PN",
            "SH", "ST", "TM", "UC", "UI", "UR", "UT"}
BINARY = {"US": "<H", "SS": "<h", "UL": "<I", "SL": "<i", "FL": "<f",
          "FD": "<d"}
ITEM, ITEM_END = 0xFFFEE000, 0xFFFEE00D


def ds(value):
    """A decimal string of at most 16 characters: the shortest that reads
    back as ``value``, else ``value`` rounded to fit."""
    v = float(value)
    s = repr(v)
    for digits in range(15, 0, -1):
        if len(s) <= 16:
            return s
        s = f"{v:.{digits}g}"
    return s


def uid(*parts):
    """A UID under the benchmark's root from whole numbers."""
    return ".".join([UID_ROOT] + [str(abs(int(p))) for p in parts])


def _text(vr, value):
    if isinstance(value, (list, tuple)):
        value = "\\".join(_one_text(vr, v) for v in value)
    else:
        value = _one_text(vr, value)
    raw = value.encode("ascii")
    if len(raw) % 2:
        raw += b"\0" if vr == "UI" else b" "
    return raw


def _one_text(vr, v):
    if vr == "DS":
        return ds(v)
    if vr == "IS":
        return str(int(v))
    return str(v)


def _value(vr, value):
    if vr == "SQ":
        return b"".join(_item(d) for d in value)
    if vr in TEXT_VRS:
        return _text(vr, value)
    if vr in BINARY:
        vals = value if isinstance(value, (list, tuple)) else [value]
        return b"".join(struct.pack(BINARY[vr], v) for v in vals)
    if vr == "AT":
        return struct.pack("<HH", value >> 16, value & 0xFFFF)
    raw = bytes(value)                       # OB, OW and the other bytes
    return raw + b"\0" if len(raw) % 2 else raw


def element(tag, vr, value):
    raw = _value(vr, value)
    head = struct.pack("<HH2s", tag >> 16, tag & 0xFFFF, vr.encode("ascii"))
    if vr in LONG_VRS:
        return head + struct.pack("<HI", 0, len(raw)) + raw
    if len(raw) > 0xFFFF:
        raise ValueError(f"({tag >> 16:04X},{tag & 0xFFFF:04X}) {vr} holds "
                         f"{len(raw)} bytes, more than a short length")
    return head + struct.pack("<H", len(raw)) + raw


def dataset(elements):
    return b"".join(element(tag, vr, value)
                    for tag, (vr, value) in sorted(elements.items()))


def _item(elements):
    body = dataset(elements)
    return struct.pack("<HHI", ITEM >> 16, ITEM & 0xFFFF, len(body)) + body


def write(path, elements):
    """``elements`` as a Part 10 file: preamble, ``DICM``, the file meta
    group (its SOP class and instance from the dataset), the dataset."""
    meta = dataset({
        0x00020001: ("OB", b"\0\1"),
        0x00020002: ("UI", elements[0x00080016][1]),
        0x00020003: ("UI", elements[0x00080018][1]),
        0x00020010: ("UI", EXPLICIT_VR_LE),
        0x00020012: ("UI", IMPLEMENTATION),
    })
    with open(path, "wb") as f:
        f.write(b"\0" * 128 + b"DICM")
        f.write(element(0x00020000, "UL", len(meta)) + meta)
        f.write(dataset(elements))


def pixels(array, dtype):
    """Little-endian pixel bytes of ``array`` as ``dtype`` ('<i2', '<u4')."""
    return np.ascontiguousarray(array).astype(dtype).tobytes()
