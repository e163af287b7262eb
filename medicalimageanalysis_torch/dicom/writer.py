# Copied from medicalimageanalysis_tpu/dicom/writer.py; ``_fmt_number``
# keeps up to DS's 16 characters.
"""DICOM file writer (Explicit VR Little Endian, Part 10).

Own implementation replacing pydicom's ``save_as`` for the synthetic-image
writer (reference utils/creation.py:132-229 writes .dcm slice series) and
for test fixtures.
"""

from __future__ import annotations

import struct

import numpy as np

from . import uids
from .dataset import FileMetaDataset

_LONG_VRS = {"OB", "OW", "OF", "OD", "OL", "OV", "SQ", "UC", "UR", "UT", "UN"}

IMPLEMENTATION_CLASS_UID = "2.25.435983256642431287462"


def _fmt_number(v):
    """A DS / IS value: the shortest string that reads back to the same
    float when it fits DS's 16 characters, else the most significant
    digits that fit (the JAX package's copy writes 10)."""
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    v = float(v)
    s = repr(v)
    digits = 15
    while len(s) > 16 and digits > 1:
        s = f"{v:.{digits}g}"
        digits -= 1
    return s


def _encode_value(vr, value, little=True):
    order = "<" if little else ">"
    if value is None:
        return b""
    if vr in ("OB", "OW", "OF", "OD", "OL", "UN"):
        if isinstance(value, np.ndarray):
            return value.tobytes()
        return bytes(value)
    if vr == "SQ":
        return _encode_sequence(value, little)
    if vr in ("US", "SS", "UL", "SL", "FL", "FD"):
        fmt = {"US": "u2", "SS": "i2", "UL": "u4", "SL": "i4",
               "FL": "f4", "FD": "f8"}[vr]
        arr = np.asarray(value if isinstance(value, (list, tuple, np.ndarray))
                         else [value], dtype=order + fmt)
        return arr.tobytes()
    if vr == "AT":
        vals = value if isinstance(value, (list, tuple)) else [value]
        out = b""
        for t in vals:
            out += struct.pack(order + "HH", t >> 16, t & 0xFFFF)
        return out
    if vr in ("DS", "IS"):
        if isinstance(value, (list, tuple, np.ndarray)):
            s = "\\".join(_fmt_number(v) for v in value)
        else:
            s = _fmt_number(value)
    else:
        if isinstance(value, (list, tuple)):
            s = "\\".join(str(v) for v in value)
        else:
            s = str(value)
    raw = s.encode("latin-1", errors="replace")
    if len(raw) % 2:
        raw += b"\x00" if vr == "UI" else b" "
    return raw


def _encode_element(tag, vr, value, little=True):
    raw = _encode_value(vr, value, little)
    if len(raw) % 2:
        raw += b"\x00"
    group, elem = tag >> 16, tag & 0xFFFF
    order = "<" if little else ">"
    head = struct.pack(order + "HH", group, elem)
    vr_b = vr.encode("ascii")
    if vr in _LONG_VRS:
        head += vr_b + b"\x00\x00" + struct.pack(order + "I", len(raw))
    else:
        head += vr_b + struct.pack(order + "H", len(raw))
    return head + raw


def _encode_dataset(ds, little=True):
    out = []
    for tag in sorted(ds._dict):
        el = ds._dict[tag]
        out.append(_encode_element(tag, el.VR, el.value, little))
    return b"".join(out)


def _encode_sequence(seq, little=True):
    order = "<" if little else ">"
    out = b""
    for item in seq:
        body = _encode_dataset(item, little)
        out += struct.pack(order + "HHI", 0xFFFE, 0xE000, len(body)) + body
    return out


def build_file_meta(ds, transfer_syntax=uids.ExplicitVRLittleEndian):
    fm = FileMetaDataset()
    fm.add(0x00020001, "OB", b"\x00\x01")
    fm.add(0x00020002, "UI", ds.get("SOPClassUID", uids.CTImageStorage))
    fm.add(0x00020003, "UI", ds.get("SOPInstanceUID", uids.generate_uid()))
    fm.add(0x00020010, "UI", transfer_syntax)
    fm.add(0x00020012, "UI", IMPLEMENTATION_CLASS_UID)
    return fm


def dcmwrite(path, ds, transfer_syntax=None):
    """Write a Dataset as Part 10 Explicit VR Little Endian."""
    fm = ds.file_meta
    if transfer_syntax is None:
        transfer_syntax = (fm.get("TransferSyntaxUID")
                           if fm is not None else None) \
            or uids.ExplicitVRLittleEndian
    if fm is None:
        fm = build_file_meta(ds, transfer_syntax)
        ds.file_meta = fm
    else:
        fm.add(0x00020010, "UI", transfer_syntax)
        if 0x00020002 not in fm._dict and "SOPClassUID" in ds:
            fm.add(0x00020002, "UI", ds.SOPClassUID)
        if 0x00020003 not in fm._dict and "SOPInstanceUID" in ds:
            fm.add(0x00020003, "UI", ds.SOPInstanceUID)

    meta_body = b"".join(
        _encode_element(tag, fm._dict[tag].VR, fm._dict[tag].value)
        for tag in sorted(fm._dict) if tag != 0x00020000)
    meta = _encode_element(0x00020000, "UL", len(meta_body)) + meta_body

    encap_pixels = None
    if transfer_syntax in uids.ENCAPSULATED_SYNTAXES and 0x7FE00010 in ds._dict:
        el = ds._dict.pop(0x7FE00010)
        if isinstance(el.value, list):
            frags = el.value
        else:
            # raw (uncompressed) pixel bytes + a compressed target
            # syntax: auto-encode per frame (RLE / JPEG-LS) — the
            # reference cannot write compressed at all
            frags = _auto_encode_frames(ds, bytes(el.value),
                                        transfer_syntax)
        encap_pixels = _encode_encapsulated(frags)

    try:
        if transfer_syntax == uids.ImplicitVRLittleEndian:
            body = _encode_dataset_implicit(ds)
        else:
            body = _encode_dataset(ds, little=True)
        if encap_pixels is not None:
            body += encap_pixels
    finally:
        if encap_pixels is not None:
            ds._dict[0x7FE00010] = el

    if transfer_syntax == uids.DeflatedExplicitVRLittleEndian:
        import zlib
        compressor = zlib.compressobj(wbits=-15)  # raw deflate per PS3.5
        body = compressor.compress(body) + compressor.flush()

    with open(str(path), "wb") as f:
        f.write(b"\x00" * 128)
        f.write(b"DICM")
        f.write(meta)
        f.write(body)


def _auto_encode_frames(ds, raw, transfer_syntax):
    """Compress raw little-endian pixel bytes into per-frame fragments
    for the target transfer syntax (RLE, JPEG-LS lossless). Signed
    data travels as its two's-complement codes at BitsAllocated
    precision — the decode path's dtype cast restores the sign, so
    round trips are exact. Near-lossless (.4.81) is intentionally NOT
    auto-selected: silently lossy writes need the caller to pass
    pre-encoded fragments with an explicit NEAR."""
    from . import pixels as px

    frames, rows, cols, samples = px._target_shape(ds)
    dtype = px._native_dtype(ds)
    arr = np.frombuffer(raw, dtype=dtype,
                        count=frames * rows * cols * samples)
    arr = px._reshape(arr, ds)
    if frames == 1:
        arr = arr[None]

    if transfer_syntax == uids.RLELossless:
        if samples != 1:
            raise ValueError("dcmwrite: RLE auto-encode supports "
                             "SamplesPerPixel=1 (per-sample byte "
                             "segment ordering); pre-encode fragments")
        return [encode_rle_frame(f) for f in arr]

    if transfer_syntax == uids.JPEGLSLossless:
        bits_alloc = int(ds.get("BitsAllocated", 16))
        signed = int(ds.get("PixelRepresentation", 0)) == 1
        if signed:
            codes = arr.astype(np.int64) & ((1 << bits_alloc) - 1)
            precision = bits_alloc
        else:
            codes = arr.astype(np.int64)
            precision = int(ds.get("BitsStored", bits_alloc)
                            or bits_alloc)
            if codes.size and int(codes.max()) >= (1 << precision):
                precision = bits_alloc
        try:
            from ..native import jpegls_t87_encode
        except Exception:
            jpegls_t87_encode = None
        out = []
        for f in codes:
            enc = jpegls_t87_encode(f, precision=precision) \
                if jpegls_t87_encode is not None else None
            if enc is None:            # native lib unavailable
                from .jpegls_t87 import encode_jpegls
                enc = encode_jpegls(f, precision=precision)
            out.append(enc)
        return out

    if transfer_syntax == uids.JPEG2000Lossless:
        from .jpeg2k_enc import encode_j2k

        bits_alloc = int(ds.get("BitsAllocated", 16))
        signed = int(ds.get("PixelRepresentation", 0)) == 1
        precision = int(ds.get("BitsStored", bits_alloc) or bits_alloc)
        data = arr.astype(np.int64)
        if data.size:
            # two's-complement bit demand: -2^(n-1) needs n bits, so
            # test the min via (-v-1).bit_length() — abs() would bump
            # the legal 12-bit value -2048 to a 13-bit demand
            hi = int(data.max())
            lo = int(data.min())
            if signed:
                need = max(hi.bit_length() + 1 if hi > 0 else 1,
                           (-lo - 1).bit_length() + 1 if lo < 0 else 1)
            else:
                need = max(hi.bit_length(), 1)
            if need > precision:
                precision = bits_alloc
        out = []
        for f in data:
            if samples == 1:
                frame = f.reshape(rows, cols)
            else:
                frame = f.reshape(rows, cols, samples)
            out.append(encode_j2k(frame, precision=precision,
                                  signed=signed, levels=5))
        return out

    raise ValueError(
        f"dcmwrite: cannot auto-encode pixels for {transfer_syntax}; "
        "pass PixelData as a list of pre-encoded frame fragments")


def _encode_encapsulated(fragments):
    """Undefined-length OB PixelData with empty basic offset table."""
    out = struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00" \
        + struct.pack("<I", 0xFFFFFFFF)
    out += struct.pack("<HHI", 0xFFFE, 0xE000, 0)  # empty BOT
    for frag in fragments:
        frag = bytes(frag)
        if len(frag) % 2:
            frag += b"\x00"
        out += struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag
    out += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    return out


def _encode_dataset_implicit(ds):
    out = []
    for tag in sorted(ds._dict):
        el = ds._dict[tag]
        if el.VR == "SQ":
            raw = _encode_sequence_implicit(el.value)
        else:
            raw = _encode_value(el.VR, el.value)
            if len(raw) % 2:
                raw += b"\x00"
        out.append(struct.pack("<HHI", tag >> 16, tag & 0xFFFF, len(raw)) + raw)
    return b"".join(out)


def _encode_sequence_implicit(seq):
    out = b""
    for item in seq:
        body = _encode_dataset_implicit(item)
        out += struct.pack("<HHI", 0xFFFE, 0xE000, len(body)) + body
    return out


def encode_rle_frame(arr):
    """RLE-encode one frame (PS3.5 annex G) — used by tests and exporters."""
    arr = np.ascontiguousarray(arr)
    bps = arr.dtype.itemsize
    flat = arr.reshape(-1)
    segs = []
    be = flat.astype(flat.dtype.newbyteorder(">")).tobytes()
    raw = np.frombuffer(be, dtype=np.uint8).reshape(-1, bps)
    for b in range(bps):
        segs.append(_packbits_encode(np.ascontiguousarray(raw[:, b])))
    header = np.zeros(16, dtype="<u4")
    header[0] = len(segs)
    off = 64
    for i, s in enumerate(segs):
        header[1 + i] = off
        off += len(s)
    out = header.tobytes() + b"".join(segs)
    if len(out) % 2:
        out += b"\x00"
    return out


def _packbits_encode(data):
    data = bytes(data)
    out = bytearray()
    n = len(data)
    i = 0
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
        else:
            j = i
            while j < n and j - i < 128:
                if j + 2 < n and data[j] == data[j + 1] == data[j + 2]:
                    break
                j += 1
            out.append(j - i - 1)
            out.extend(data[i:j])
            i = j
    return bytes(out)
