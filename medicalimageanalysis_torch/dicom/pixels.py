# Copied from medicalimageanalysis_tpu/dicom/pixels.py.
"""Pixel data decoders.

Own implementations of the decode paths the reference gets from
GDCM/pylibjpeg through pydicom (reference requirements.txt pins
python-gdcm/pylibjpeg; reference read/dicom.py:52 imports gdcm):

- native little/big-endian uncompressed
- RLE Lossless (PackBits segments, DICOM PS3.5 annex G)
- JPEG-Lossless p14/SV1, sequential-DCT 8/12-bit, and JPEG-LS
  (T.87 .4.80/.81) via the native C++ decoders (native/dicomscan.cpp)
- 8-bit baseline JPEG and JPEG2000 via OpenCV ``imdecode``
"""

from __future__ import annotations

import numpy as np

from . import uids


def _native_dtype(ds, little=True):
    bits = int(ds.get("BitsAllocated", 16))
    signed = int(ds.get("PixelRepresentation", 0)) == 1
    if bits == 8:
        base = "i1" if signed else "u1"
    elif bits == 16:
        base = "i2" if signed else "u2"
    elif bits == 32:
        base = "i4" if signed else "u4"
    else:
        raise ValueError(f"unsupported BitsAllocated={bits}")
    return np.dtype(("<" if little else ">") + base)


def _target_shape(ds):
    rows = int(ds.Rows)
    cols = int(ds.Columns)
    frames = int(ds.get("NumberOfFrames", 1) or 1)
    samples = int(ds.get("SamplesPerPixel", 1) or 1)
    return frames, rows, cols, samples


def _reshape(arr, ds):
    frames, rows, cols, samples = _target_shape(ds)
    planar = int(ds.get("PlanarConfiguration", 0) or 0)
    if samples > 1:
        if planar == 1:
            arr = arr.reshape(frames, samples, rows, cols)
            arr = np.moveaxis(arr, 1, -1)
        else:
            arr = arr.reshape(frames, rows, cols, samples)
    else:
        arr = arr.reshape(frames, rows, cols)
    if frames == 1:
        arr = arr[0]
    return arr


def ybr_full_to_rgb(arr):
    """Full-range BT.601 YCbCr -> RGB on the last axis (uint8).

    Exact on grayscale content: Cb = Cr = 128 maps to R = G = B = Y,
    so downstream uniform-channel tests (ReadUS overlay removal) see
    the same pixels as an RGB-native source."""
    a = arr.astype(np.float64)
    y, cb, cr = a[..., 0], a[..., 1] - 128.0, a[..., 2] - 128.0
    rgb = np.stack([y + 1.402 * cr,
                    y - 0.344136 * cb - 0.714136 * cr,
                    y + 1.772 * cb], axis=-1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def _decode_ybr422(ds, frames, rows, cols):
    """Uncompressed YBR_FULL_422 (PS3.3 C.7.6.3.1.2): two horizontal
    neighbours share one Cb/Cr pair, stored Y0 Y1 Cb Cr — only 2
    stored samples per pixel, which the plain samples=3 reshape cannot
    represent (pydicom expands these via its own 422 handler; the
    reference inherits that)."""
    if int(ds.get("BitsAllocated", 8) or 8) != 8:
        raise ValueError("YBR_FULL_422 requires BitsAllocated=8")
    if cols % 2:
        raise ValueError("YBR_FULL_422 requires even Columns")
    n = frames * rows * cols * 2
    raw = np.frombuffer(ds.PixelData, dtype=np.uint8, count=n)
    quads = raw.reshape(frames, rows, cols // 2, 4)
    y = quads[..., :2].reshape(frames, rows, cols)
    cb = np.repeat(quads[..., 2], 2, axis=-1)
    cr = np.repeat(quads[..., 3], 2, axis=-1)
    out = ybr_full_to_rgb(np.stack([y, cb, cr], axis=-1))
    return out[0] if frames == 1 else out


def decode_native(ds, little=True):
    frames, rows, cols, samples = _target_shape(ds)
    pmi = str(ds.get("PhotometricInterpretation", "") or "")
    if samples == 3 and pmi in ("YBR_FULL_422", "YBR_PARTIAL_422"):
        return _decode_ybr422(ds, frames, rows, cols)
    n = frames * rows * cols * samples
    dtype = _native_dtype(ds, little)
    raw = ds.PixelData
    arr = np.frombuffer(raw, dtype=dtype, count=n)
    if not little:
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    out = _reshape(arr, ds)
    if samples == 3 and pmi == "YBR_FULL":
        # full-resolution raw YCbCr: convert so every color source
        # (raw or JPEG-via-cv2) reaches readers in RGB (PARITY.md)
        out = ybr_full_to_rgb(out)
    return out


def _palette_channel_lut(ds, color, bits_stored):
    """One palette channel as a uint8/uint16 LUT array + first-mapped
    value, from the plain (0028,120x) or segmented (0028,122x) form
    (PS3.3 C.7.6.3.1.5-6, C.7.9)."""
    desc = ds.get(f"{color}PaletteColorLookupTableDescriptor")
    if desc is None:
        raise ValueError(f"PALETTE COLOR: missing {color} descriptor")
    desc = [int(v) for v in (desc if isinstance(desc, (list, tuple))
                             else [desc])]
    if len(desc) != 3:
        raise ValueError("PALETTE COLOR: descriptor needs 3 values")
    entries = desc[0] or 65536            # 0 encodes 2^16 entries
    first, out_bits = desc[1], desc[2]
    if out_bits not in (8, 16):
        raise ValueError("PALETTE COLOR: LUT bits must be 8 or 16")
    data = ds.get(f"{color}PaletteColorLookupTableData")
    if data is not None:
        buf = bytes(data)
        if out_bits == 16:
            lut = np.frombuffer(buf, "<u2", count=min(len(buf) // 2,
                                                      entries))
        else:
            # 8-bit entries may still be stored one-per-16-bit word
            if len(buf) >= 2 * entries:
                lut = np.frombuffer(buf, "<u2", count=entries) \
                    .astype(np.uint8)
            else:
                lut = np.frombuffer(buf, np.uint8, count=entries)
        if lut.size < entries:
            raise ValueError("PALETTE COLOR: LUT data shorter than "
                             "its descriptor")
        return lut, first
    seg = ds.get(f"Segmented{color}PaletteColorLookupTableData")
    if seg is None:
        raise ValueError(f"PALETTE COLOR: no {color} LUT data")
    ops = np.frombuffer(bytes(seg), "<u2")
    out = []
    i = 0
    while i < len(ops):
        if i + 1 >= len(ops):
            raise ValueError("PALETTE COLOR: truncated segment header")
        opcode, ln = int(ops[i]), int(ops[i + 1])
        i += 2
        if opcode == 0:                   # discrete
            if i + ln > len(ops):
                raise ValueError("PALETTE COLOR: truncated discrete "
                                 "segment")
            out.extend(int(v) for v in ops[i:i + ln])
            i += ln
        elif opcode == 1:                 # linear ramp to y1
            if i >= len(ops) or not out:
                raise ValueError("PALETTE COLOR: linear segment "
                                 "without start value")
            y1 = int(ops[i])
            i += 1
            y0 = out[-1]
            for k in range(1, ln + 1):
                out.append(int(round(y0 + (y1 - y0) * k / ln)))
        elif opcode == 2:                 # indirect: replay earlier ops
            raise ValueError("PALETTE COLOR: indirect segments are "
                             "not supported")
        else:
            raise ValueError(f"PALETTE COLOR: bad segment opcode "
                             f"{opcode}")
        if len(out) > entries:
            raise ValueError("PALETTE COLOR: segments exceed the "
                             "descriptor entry count")
    lut = np.asarray(out, dtype=np.uint16 if out_bits == 16
                     else np.uint8)
    if lut.size != entries:
        raise ValueError("PALETTE COLOR: segments produce "
                         f"{lut.size} entries, descriptor says "
                         f"{entries}")
    return lut, first


def apply_palette_color_lut(ds, arr=None):
    """Expand a PALETTE COLOR index array to (..., 3) color samples
    using the Red/Green/Blue Palette Color Lookup Tables, including
    the segmented form (PS3.3 C.7.9). Output dtype follows the LUT
    bit depth (uint8 or uint16).

    The reference returns the raw index array (pydicom pixel_array
    semantics) and never expands palettes; this helper is the opt-in
    equivalent of pydicom's apply_color_lut."""
    if arr is None:
        arr = decode_pixel_data(ds)
    bits_stored = int(ds.get("BitsStored", 8) or 8)
    idx = np.asarray(arr)
    chans = []
    for color in ("Red", "Green", "Blue"):
        lut, first = _palette_channel_lut(ds, color, bits_stored)
        j = np.clip(idx.astype(np.int64) - first, 0, lut.size - 1)
        chans.append(lut[j])
    return np.stack(chans, axis=-1)


def _packbits_decode(data, expected):
    """PackBits run-length decode (DICOM PS3.5 G.3.1)."""
    out = np.empty(expected, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    i = 0
    o = 0
    n = len(src)
    while i < n and o < expected:
        header = int(src[i])
        i += 1
        if header <= 127:
            # clamp against truncated/corrupt streams: a literal run may
            # claim more bytes than remain in src or fit in out
            count = min(header + 1, n - i, expected - o)
            if count <= 0:
                break
            out[o:o + count] = src[i:i + count]
            i += count
            o += count
        elif header >= 129:
            if i >= n:  # replicate header ends the stream
                break
            count = min(257 - header, expected - o)
            out[o:o + count] = src[i]
            i += 1
            o += count
        # header == 128: no-op
    return out[:o]


def decode_rle(ds):
    frames, rows, cols, samples = _target_shape(ds)
    bits = int(ds.get("BitsAllocated", 16))
    bytes_per_sample = bits // 8
    frame_px = rows * cols
    frags = ds.PixelData
    if isinstance(frags, (bytes, bytearray)):
        frags = [bytes(frags)]
    # the native scanner surfaces the Basic Offset Table as fragment 0
    # (the slow parser drops it); RLE is one fragment per frame, and a
    # BOT is structurally empty or exactly 4 bytes per frame — a real
    # RLE fragment is >= 64 bytes, so a count heuristic alone could
    # discard a real frame when the header understates the frame count
    if len(frags) == frames + 1 and len(frags[0]) in (0, 4 * frames):
        frags = frags[1:]
    if len(frags) < frames:
        raise ValueError("RLE: fewer fragments than frames")

    # native fast path (interleaved little-endian output)
    try:
        from ..native import rle_decode_frame
    except Exception:
        rle_decode_frame = None
    if rle_decode_frame is not None:
        dtype = _native_dtype(ds)
        native_frames = []
        for f in range(frames):
            raw = rle_decode_frame(frags[f], rows, cols, samples,
                                   bytes_per_sample)
            if raw is None:
                native_frames = None
                break
            arr = np.frombuffer(raw.tobytes(), dtype=dtype)
            if samples > 1:
                native_frames.append(arr.reshape(rows, cols, samples))
            else:
                native_frames.append(arr.reshape(rows, cols))
        if native_frames is not None:
            arr = np.stack(native_frames)
            return arr[0] if frames == 1 else arr

    out_frames = []
    for f in range(frames):
        frag = frags[f]
        if len(frag) < 64:
            raise ValueError("RLE: fragment shorter than segment header")
        header = np.frombuffer(frag[:64], dtype="<u4")
        nseg = int(header[0])
        if not 1 <= nseg <= 15:
            raise ValueError("RLE: bad segment count")
        if nseg != samples * bytes_per_sample:
            raise ValueError("RLE: segment count does not match "
                             "samples*bytes")
        offsets = [int(v) for v in header[1:1 + nseg]] + [len(frag)]
        if any(offsets[s] > offsets[s + 1] or offsets[s] > len(frag)
               for s in range(nseg)):
            raise ValueError("RLE: non-monotonic segment offsets")
        segs = []
        for s in range(nseg):
            seg = _packbits_decode(frag[offsets[s]:offsets[s + 1]],
                                   frame_px)
            if seg.shape[0] < frame_px:  # truncated stream: zero-pad
                seg = np.pad(seg, (0, frame_px - seg.shape[0]))
            segs.append(seg)
        # segments: for each sample, MSB..LSB byte planes
        frame = np.zeros((samples, frame_px), dtype=np.uint32)
        for samp in range(samples):
            for b in range(bytes_per_sample):
                seg = segs[samp * bytes_per_sample + b]
                shift = 8 * (bytes_per_sample - 1 - b)
                frame[samp] |= seg.astype(np.uint32) << shift
        dtype = _native_dtype(ds)
        frame = frame.astype(np.uint32).astype(dtype.newbyteorder("="))
        if samples > 1:
            out_frames.append(frame.reshape(samples, rows, cols))
        else:
            out_frames.append(frame.reshape(rows, cols))
    arr = np.stack(out_frames)
    if samples > 1:
        arr = np.moveaxis(arr, 1, -1)
    if frames == 1:
        arr = arr[0]
    return arr


def decode_jpeg_lossless(ds):
    """JPEG-Lossless (process 14 / SV1) via the native decoder —
    the path GDCM/pylibjpeg covers for the reference."""
    from ..native import jpeg_lossless_decode

    return _decode_jpeg_frames(ds, jpeg_lossless_decode,
                               "JPEG-Lossless")


def _group_jpeg_fragments(frags, frames, start=b"\xFF\xD8"):
    """Encapsulated fragments -> one byte stream per frame.

    DICOM allows any number of fragments per frame; each frame's first
    fragment begins with the codec's start marker (JPEG SOI FF D8;
    JPEG 2000 SOC FF 4F), so fragments merge into the current frame
    until the next start-initial fragment. A mismatch between the
    grouped count and the declared frame count raises (silently
    returning fewer frames than the header declares lost 9 of 10
    frames unreported — review finding)."""
    if isinstance(frags, (bytes, bytearray)):
        frags = [bytes(frags)]
    frags = [bytes(f) for f in frags if len(f) > 0]
    ns = len(start)
    # a leading non-start fragment ahead of a start-initial one is the
    # Basic Offset Table item the parser surfaces as fragment 0
    if len(frags) > 1 and frags[0][:ns] != start \
            and frags[1][:ns] == start:
        frags = frags[1:]
    frames = max(int(frames), 1)
    if len(frags) == frames:
        return frags
    groups = []
    for f in frags:
        f = bytes(f)
        if f[:ns] == start or not groups:
            groups.append(f)
        else:
            groups[-1] += f
    if len(groups) != frames:
        raise ValueError(
            f"encapsulated JPEG: {len(groups)} start-delimited frame "
            f"streams from {len(frags)} fragments, but the header "
            f"declares {frames} frames")
    return groups


def _decode_jpeg_frames(ds, decode_fn, err_label):
    """Shared frame loop for the native JPEG decoders (lossless and
    sequential-DCT): fragment grouping, per-frame decode, dtype cast."""
    frames, rows, cols, samples = _target_shape(ds)
    streams = _group_jpeg_fragments(ds.PixelData, frames)
    out = []
    for frag in streams:
        arr = decode_fn(frag)
        if arr is None:
            raise ValueError(f"{err_label} decode failed (native "
                             "decoder unavailable or bad stream)")
        out.append(arr)
    dtype = _native_dtype(ds).newbyteorder("=")
    arr = np.stack(out).astype(dtype)
    if frames == 1:
        arr = arr[0]
    return arr


def decode_jpegls(ds):
    """JPEG-LS (T.87, .4.80/.81) via the native decoder — GDCM/CharLS
    territory for the reference (read/dicom.py:52); cv2 has no JPEG-LS
    codec at all, so this is the only route."""
    from ..native import jpegls_t87_decode

    return _decode_jpeg_frames(ds, jpegls_t87_decode, "JPEG-LS")


def decode_jpeg_dct_native(ds):
    """Sequential-DCT JPEG (baseline .50 / Extended 12-bit .51) via the
    native decoder — the 12-bit path GDCM covers for the reference
    (read/dicom.py:52) that cv2 cannot decode. 3-component scans
    return the RAW decoded component values (pydicom parity: no
    implicit YBR->RGB; PhotometricInterpretation tells the caller)."""
    from ..native import jpeg_dct_decode

    return _decode_jpeg_frames(ds, jpeg_dct_decode,
                               "JPEG sequential-DCT")


def _maybe_ybr_to_rgb(arr, ds):
    """Color sources reach the readers in RGB: decoders that return
    raw YCbCr samples (native DCT fallback, RLE) are converted here
    when PhotometricInterpretation says YBR; cv2 paths and
    decode_native convert internally."""
    pmi = str(ds.get("PhotometricInterpretation", "") or "")
    if pmi in ("YBR_FULL", "YBR_FULL_422") and arr.ndim >= 3 \
            and arr.shape[-1] == 3:
        return ybr_full_to_rgb(arr)
    return arr


_CV2_J2K_UNSCALED = {}


def _cv2_j2k_precision_exact(prec):
    """One-time probe per precision: the own exact Part-1 encoder
    writes a tiny frame holding dark values (0..7) AND the full-scale
    code, cv2/OpenJPEG decodes it, and the route is accepted only on
    an exact match. A max-based range check alone cannot catch an
    upshifting build on dark frames (a 12-bit air-only slice
    upshifted x16 still fits 16 bits) — review finding. The probe is
    Part-1 but proxies HT too: precision scaling happens in the same
    component->Mat conversion layer for both coders."""
    ok = _CV2_J2K_UNSCALED.get(prec)
    if ok is None:
        try:
            import cv2
            from .jpeg2k_enc import encode_j2k
            dt = np.uint8 if prec <= 8 else np.uint16
            probe = np.arange(16, dtype=dt).reshape(4, 4) % 8
            probe[3, 0] = (1 << prec) - 1
            frag = encode_j2k(probe, levels=1, precision=prec)
            got = cv2.imdecode(np.frombuffer(frag, dtype=np.uint8),
                               cv2.IMREAD_UNCHANGED)
            ok = (got is not None and got.dtype == dt
                  and got.shape == probe.shape
                  and np.array_equal(got, probe))
        except Exception:
            ok = False
        _CV2_J2K_UNSCALED[prec] = ok
    return ok


def _decode_j2k_cv2_exact(frag, parse_siz):
    """cv2/OpenJPEG route, gated to the streams it decodes EXACTLY:
    uniform UNSIGNED components of any precision <= 16 with 1 or 3
    components (OpenJPEG refuses signed outright), where a one-time
    per-precision round-trip probe against the own exact encoder
    proves this build returns unscaled values. Serves two callers:
    the no-native-library environment (the pure-Python fallback is
    seconds per 512^2 frame) and HTJ2K codestreams, which OpenJPEG
    2.5 decodes but the built-in Part-1 codec rejects."""
    try:
        import cv2
        w, h, ncomp, comps = parse_siz(frag)
        if ncomp not in (1, 3):
            return None
        prec = comps[0][0]
        if any(c != (prec, False) for c in comps) or prec > 16:
            return None
        if not _cv2_j2k_precision_exact(prec):
            return None
        img = cv2.imdecode(np.frombuffer(frag, dtype=np.uint8),
                           cv2.IMREAD_UNCHANGED)
        if img is None or img.shape[:2] != (h, w):
            return None
        want = np.uint8 if prec <= 8 else np.uint16
        if img.dtype != want:
            return None
        if int(img.max()) >= (1 << prec):
            return None
        if img.ndim == 3:
            if img.shape[2] != 3:
                return None
            img = img[..., ::-1]            # BGR -> RGB
        return img
    except Exception:
        return None


def _siz_to_unsigned(frag):
    """Rewrite a RAW codestream's SIZ component signedness bits to
    unsigned. Returns the rewritten bytes or None when the input is
    not a raw codestream (JP2-wrapped streams keep the typed-error
    boundary). SIZ is mandatory immediately after SOC: Csiz sits at
    byte 40, then 3 bytes (Ssiz, XRsiz, YRsiz) per component with the
    signedness in Ssiz bit 7 (ISO 15444-1 A.5.1)."""
    if bytes(frag[:4]) != b"\xFF\x4F\xFF\x51" or len(frag) < 43:
        return None
    b = bytearray(frag)
    csiz = int.from_bytes(b[40:42], "big")
    if len(b) < 42 + 3 * csiz:
        return None
    for i in range(csiz):
        b[42 + 3 * i] &= 0x7F
    return bytes(b)


def _decode_j2k_cv2_signed(frag, parse_siz):
    """Signed codestreams through OpenJPEG by DC-shift transcoding.

    Component signedness selects ONLY the DC level shift (ISO 15444-1
    G.1.2): the entropy-coded wavelet data is identical for signed and
    unsigned declarations. Flipping Ssiz to unsigned, decoding, and
    subtracting 2^(P-1) is therefore exact — including lossy streams,
    where the unsigned clamp [0, 2^P-1] maps to the identical signed
    clamp [-2^(P-1), 2^(P-1)-1]. This is the signed-HTJ2K route
    (VERDICT r3 #9): OpenJPEG 2.5 decodes HT block coding but refuses
    signed components outright; the shift equivalence is pinned against
    the own Part-1 signed decoder in tests/test_jpeg2000.py."""
    try:
        w, h, ncomp, comps = parse_siz(frag)
    except Exception:
        return None
    if ncomp not in (1, 3):
        return None
    prec = comps[0][0]
    if any(c != (prec, True) for c in comps) or prec > 16:
        return None
    rewritten = _siz_to_unsigned(frag)
    if rewritten is None:
        # JP2-wrapped signed stream (non-conformant in DICOM PS3.5
        # but seen in the wild): extract the raw codestream and
        # rewrite THAT — cv2 decodes bare codestreams directly, so
        # dropping the container is lossless (VERDICT r4 #6: this was
        # the one class that fell through to the slow Python decoder,
        # which rejects HT block coding outright)
        try:
            from .jpeg2k import _find_codestream
            rewritten = _siz_to_unsigned(_find_codestream(bytes(frag)))
        except Exception:
            return None
        if rewritten is None:
            return None
    arr = _decode_j2k_cv2_exact(rewritten, parse_siz)
    if arr is None:
        return None
    return arr.astype(np.int32) - (1 << (prec - 1))


def decode_jpeg2000(ds):
    """JPEG 2000 (.4.90/.91 Part 1, .4.201-.203 HTJ2K) via the own
    codec (dicom/jpeg2k.py; native fast path when available) — the
    path GDCM/OpenJPEG covers for the reference (read/dicom.py:52).
    The cv2/OpenJPEG route backs two gaps the own codec leaves:
    unsigned streams when the native library is unavailable, and
    HTJ2K codestreams (different block coder; OpenJPEG 2.5 decodes
    them, signed HTJ2K raises a typed error)."""
    frames, rows, cols, samples = _target_shape(ds)
    # JP2-wrapped frames start with the JP2 signature box, raw
    # codestreams with SOC (FF 4F); group on whichever applies
    frags = ds.PixelData
    if isinstance(frags, (bytes, bytearray)):
        frags = [bytes(frags)]
    # full 8-byte JP2 signature-box prefix: a 2-byte 00 00 prefix
    # would also match a non-empty Basic Offset Table fragment (whose
    # first entry is offset 0) and any continuation fragment that
    # happens to begin 00 00 — review finding
    jp2_sig = b"\x00\x00\x00\x0C\x6A\x50\x20\x20"
    start = b"\xFF\x4F"
    if any(bytes(f[:8]) == jp2_sig for f in frags[:2]):
        start = jp2_sig
    streams = _group_jpeg_fragments(frags, frames, start=start)
    try:
        from ..native import j2k_decode as _native_j2k
    except Exception:
        _native_j2k = None
    from .jpeg2k import decode_j2k, parse_siz
    ts = _transfer_syntax(ds)
    out = []
    for frag in streams:
        arr = _native_j2k(frag) if _native_j2k is not None else None
        if arr is None:
            arr = _decode_j2k_cv2_exact(frag, parse_siz)
        if arr is None:
            # signed via OpenJPEG by DC-shift transcoding (the
            # signed-HTJ2K route; exactness argument on the helper)
            arr = _decode_j2k_cv2_signed(frag, parse_siz)
        if arr is None:
            try:
                arr = decode_j2k(frag)
            except ValueError:
                if ts in _HTJ2K:
                    _cv2_for(ts)   # HT block coding decodes only by cv2
                raise
        out.append(arr)
    dtype = _native_dtype(ds).newbyteorder("=")
    arr = np.stack(out).astype(dtype)
    if frames == 1:
        arr = arr[0]
    return arr


class CodecUnavailableError(ImportError):
    """A transfer syntax whose only decoder here is cv2 (OpenCV), on a
    machine without cv2. An ImportError, so 8-bit JPEG Baseline catches
    it and takes the native DCT decoder instead."""


def _cv2_for(ts):
    """cv2, or CodecUnavailableError naming the transfer syntax ``ts``."""
    try:
        import cv2
    except ImportError as e:
        raise CodecUnavailableError(
            f"transfer syntax {ts}: decoding needs cv2 (OpenCV), which is "
            "not installed") from e
    return cv2


def decode_jpeg_cv2(ds):
    cv2 = _cv2_for(_transfer_syntax(ds))

    frames, rows, cols, samples = _target_shape(ds)
    frags = ds.PixelData
    if isinstance(frags, (bytes, bytearray)):
        frags = [bytes(frags)]
    if len(frags) > frames:
        # fragments per frame unknown -> merge all into one stream per frame
        merged = b"".join(frags)
        frags = [merged]
    out = []
    for frag in frags[:frames] if frames > 1 else [b"".join(frags)]:
        buf = np.frombuffer(frag, dtype=np.uint8)
        img = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError("cv2 could not decode JPEG fragment "
                             "(unsupported process, e.g. JPEG-Lossless p14)")
        if img.ndim == 3:
            img = img[..., ::-1]  # BGR -> RGB
        out.append(img)
    arr = np.stack(out) if len(out) > 1 else out[0]
    return arr


_HTJ2K = (uids.HTJ2KLossless, uids.HTJ2KLosslessRPCL, uids.HTJ2K)


def _transfer_syntax(ds):
    return ds.file_meta.get("TransferSyntaxUID") \
        if ds.file_meta is not None else None


def decode_pixel_data(ds):
    if "PixelData" not in ds:
        if "FloatPixelData" in ds:
            frames, rows, cols, samples = _target_shape(ds)
            arr = np.frombuffer(ds.FloatPixelData, dtype="<f4",
                                count=frames * rows * cols * samples)
            return _reshape(arr, ds)
        raise AttributeError("Dataset has no PixelData")
    ts = _transfer_syntax(ds)
    if ts is None or ts in uids.UNCOMPRESSED_SYNTAXES:
        return decode_native(ds, little=(ts != uids.ExplicitVRBigEndian))
    if ts == uids.RLELossless:
        return _maybe_ybr_to_rgb(decode_rle(ds), ds)
    if ts in (uids.JPEGLossless, uids.JPEGLosslessSV1):
        return decode_jpeg_lossless(ds)
    if ts in (uids.JPEGLSLossless, uids.JPEGLSNearLossless):
        return decode_jpegls(ds)
    if ts in (uids.JPEGBaseline8Bit, uids.JPEGExtended12Bit):
        # >8-bit samples: cv2's JPEG codec is 8-bit only — the native
        # sequential-DCT decoder is the primary (12-bit Extended,
        # legacy CR/mammo); 8-bit keeps cv2 (battle-tested, handles
        # subsampled color) with the native decoder as fallback, also
        # where cv2 is not installed (ImportError)
        deep = int(ds.get("BitsAllocated", 8) or 8) > 8 \
            or int(ds.get("BitsStored", 8) or 8) > 8
        if deep:
            return _maybe_ybr_to_rgb(decode_jpeg_dct_native(ds), ds)
        try:
            return decode_jpeg_cv2(ds)
        except (ValueError, ImportError):
            return _maybe_ybr_to_rgb(decode_jpeg_dct_native(ds), ds)
    if ts in (uids.JPEG2000Lossless, uids.JPEG2000, uids.HTJ2KLossless,
              uids.HTJ2KLosslessRPCL, uids.HTJ2K):
        # HTJ2K (.4.201-.203) shares the J2K container/grouping; the
        # built-in Part-1 codec rejects HT codestreams with a typed
        # error, unsigned HT decodes exactly via the OpenJPEG route
        return decode_jpeg2000(ds)
    if ts in uids.ENCAPSULATED_SYNTAXES:
        return decode_jpeg_cv2(ds)
    # unknown syntax: try native
    return decode_native(ds)
