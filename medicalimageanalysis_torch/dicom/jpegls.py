# Copied from medicalimageanalysis_tpu/dicom/jpegls.py.
"""JPEG-Lossless (ITU T.81 process 14, SOF3) encoder.

Test-grade single-component encoder producing streams our native
decoder (native/dicomscan.cpp mia_jpegls14_decode) and any standards-
compliant decoder can read. Used by the test suite to validate the
decode path GDCM normally provides, and available for export.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["encode_jpeg_lossless"]


def _category(diff):
    """Huffman category (number of magnitude bits) of a difference."""
    mag = np.abs(diff)
    cat = np.zeros_like(mag, dtype=np.int32)
    nz = mag > 0
    cat[nz] = np.floor(np.log2(mag[nz])).astype(np.int32) + 1
    return cat


def encode_jpeg_lossless(image, precision=16, predictor=1):
    """Encode a 2D unsigned array as JPEG-Lossless SV1 bytes."""
    img = np.asarray(image)
    if img.dtype.kind == "i":
        img = img.astype(np.int64)
    else:
        img = img.astype(np.int64)
    H, W = img.shape

    # predictor-1 differences, row-major (first col predicts from above,
    # first sample from 2^(P-1))
    pred = np.empty_like(img)
    pred[:, 1:] = img[:, :-1]
    pred[1:, 0] = img[:-1, 0]
    pred[0, 0] = 1 << (precision - 1)
    diff = ((img - pred + (1 << precision))
            % (1 << precision))
    # map back to signed range for category coding
    half = 1 << (precision - 1)
    sdiff = np.where(diff >= half, diff - (1 << precision), diff)
    # special case: diff == -2^15 for 16-bit is category 16 (no bits)
    cats = _category(sdiff)

    # canonical Huffman table: category c -> code length (c==0 short)
    # lengths chosen as a valid prefix code for 17 symbols (0..16)
    lengths = [2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
    # build canonical codes ordered by (length, symbol)
    symbols = sorted(range(17), key=lambda s: (lengths[s], s))
    codes = {}
    code = 0
    prev_len = lengths[symbols[0]]
    for s in symbols:
        code <<= (lengths[s] - prev_len)
        codes[s] = (code, lengths[s])
        prev_len = lengths[s]
        code += 1

    # DHT payload: bits[1..16] counts + values in canonical order
    bits = [0] * 17
    for s in range(17):
        bits[lengths[s]] += 1
    dht_vals = symbols

    out = bytearray()
    out += b"\xFF\xD8"  # SOI
    # SOF3
    sof = struct.pack(">BHHB", precision, H, W, 1) \
        + bytes([1, 0x11, 0])
    out += b"\xFF\xC3" + struct.pack(">H", len(sof) + 2) + sof
    # DHT (class 0, id 0)
    dht = bytes([0x00]) + bytes(bits[1:]) + bytes(dht_vals)
    out += b"\xFF\xC4" + struct.pack(">H", len(dht) + 2) + dht
    # SOS
    sos = bytes([1, 1, 0x00, predictor, 0, 0])
    out += b"\xFF\xDA" + struct.pack(">H", len(sos) + 2) + sos

    # entropy-coded data
    acc = 0
    nacc = 0
    data = bytearray()

    def put(code_val, nbits):
        nonlocal acc, nacc
        acc = (acc << nbits) | code_val
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            b = (acc >> nacc) & 0xFF
            data.append(b)
            if b == 0xFF:
                data.append(0x00)  # byte stuffing

    flat_diff = sdiff.ravel()
    flat_cat = cats.ravel()
    for d, t in zip(flat_diff, flat_cat):
        t = int(t)
        if t >= 16:
            put(*codes[16])
            continue
        put(*codes[t])
        if t > 0:
            v = int(d)
            if v < 0:
                v = v + (1 << t) - 1
            put(v & ((1 << t) - 1), t)
    if nacc:
        pad = 8 - nacc
        put((1 << pad) - 1, pad)  # pad with 1s per T.81

    out += bytes(data)
    out += b"\xFF\xD9"  # EOI
    return bytes(out)
