# Copied from medicalimageanalysis_tpu/dicom/jpegls_t87.py.
"""JPEG-LS (ITU-T T.87 / ISO 14495-1) encoder — LOCO-I.

Own implementation of the codec the reference obtains through
GDCM/CharLS (reference requirements.txt pins python-gdcm; gdcm import
at reference read/dicom.py:52), covering DICOM transfer syntaxes
1.2.840.10008.1.2.4.80 (lossless, NEAR=0) and .81 (near-lossless,
NEAR>0). 2..16-bit precision; all three scan layouts: plane-separated
single-component scans (ILV 0 — the DICOM CT/MR/PT case), line
interleaved (ILV 1) and sample interleaved (ILV 2) color scans.

This encoder is deliberately an independent second implementation of
the T.87 pseudo-code (regular mode with 365 contexts, bias
correction, run mode with the 32-entry J[] ladder, run-interruption
contexts 365/366, limited-length Golomb LG(k, LIMIT), marker-stuffed
bit packing) written against the spec rather than sharing state code
with the native decoder (native/dicomscan.cpp mia_jpegls_decode), so
round-trip tests cross-validate both. Where the published pseudo-code
is ambiguous the behavior of the CharLS reference implementation is
followed: the run-interruption sample is coded with the
pre-decrement RUNindex and RUNindex is decremented after; in
multi-component scans all statistics (A/B/C/N/Nn) are shared while
RUNindex is per-component in ILV 1 and shared in ILV 2; ILV 2
interruption samples always use context 365 (RItype 0).

Pure NumPy/Python; test- and export-grade (encoding a 512x512 CT in
Python is seconds, not ms — the DECODE hot path is the native C++).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["encode_jpegls", "default_thresholds"]

_J = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
      4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def default_thresholds(maxval, near):
    """T.87 C.2.4.1.1.1 default (T1, T2, T3, RESET) for MAXVAL/NEAR.

    CLAMP_1 semantics (CharLS clamp_value): a computed default outside
    [lo, MAXVAL] on either side collapses to the LOWER bound (NEAR+1
    for T1, then T1 for T2, T2 for T3)."""
    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = factor * (3 - 2) + 2 + 3 * near
        t2 = factor * (7 - 3) + 3 + 5 * near
        t3 = factor * (21 - 4) + 4 + 7 * near
    else:
        factor = 256 // (maxval + 1)
        t1 = max(2, 3 // factor + 3 * near)
        t2 = max(3, 7 // factor + 5 * near)
        t3 = max(4, 21 // factor + 7 * near)
    t1 = near + 1 if (t1 > maxval or t1 < near + 1) else t1
    t2 = t1 if (t2 > maxval or t2 < t1) else t2
    t3 = t2 if (t3 > maxval or t3 < t2) else t3
    return t1, t2, t3, 64


class _BitWriter:
    """MSB-first bit packer with JPEG-LS marker stuffing: the byte
    after an emitted 0xFF carries only 7 payload bits (MSB = 0)."""

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.n = 0
        self.room = 8

    def put(self, value, nbits):
        for i in range(nbits - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == self.room:
                self.out.append(self.cur)
                self.room = 7 if self.cur == 0xFF else 8
                self.cur = 0
                self.n = 0

    def flush(self):
        if self.n:
            self.cur <<= self.room - self.n
            self.out.append(self.cur)
            self.cur = 0
            self.n = 0
            self.room = 8


class _Coder:
    """Per-scan encoder state: context counters + bit writer + derived
    coding parameters, with one method per T.87 coding procedure so
    all three scan layouts drive the same arithmetic. Multi-component
    scans share every statistic here (T.87 8.3); only RUNindex lives
    with the caller (per-component in ILV 1, shared in ILV 2)."""

    def __init__(self, maxval, near, t1, t2, t3, reset):
        self.maxval = maxval
        self.near = near
        self.t1, self.t2, self.t3 = t1, t2, t3
        self.reset = reset
        self.rng = (maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = max(1, (self.rng - 1).bit_length())
        bpp = max(2, int(maxval).bit_length())
        self.limit = 2 * (bpp + max(8, bpp))
        self.full = self.rng * (2 * near + 1)
        self.half_rng = (self.rng + 1) // 2
        self.twon1 = 2 * near + 1
        ainit = max(2, (self.rng + 32) // 64)
        self.A = [ainit] * 367
        self.B = [0] * 365
        self.C = [0] * 365
        self.N = [1] * 367
        self.Nn = [0, 0]                 # run-interruption negatives
        self.bw = _BitWriter()

    def quantize(self, d):
        near, t1, t2, t3 = self.near, self.t1, self.t2, self.t3
        if d <= -t3:
            return -4
        if d <= -t2:
            return -3
        if d <= -t1:
            return -2
        if d < -near:
            return -1
        if d <= near:
            return 0
        if d < t1:
            return 1
        if d < t2:
            return 2
        if d < t3:
            return 3
        return 4

    def _golomb_limited(self, val, k, limit):
        """Limited-length Golomb LG(k, limit) append (T.87 A.5.3)."""
        bw = self.bw
        hi = val >> k
        if hi < limit - self.qbpp - 1:
            bw.put(1, hi + 1)            # hi zeros then a 1
            if k:
                bw.put(val & ((1 << k) - 1), k)
        else:
            bw.put(1, limit - self.qbpp)  # (limit-qbpp-1) zeros, a 1
            bw.put(val - 1, self.qbpp)

    def _reduce(self, e):
        """Near-lossless quantization + modulo reduction of a raw
        prediction error (A.4.4/A.4.5 order — the decoder reconstructs
        from the reduced value)."""
        if self.near:
            e = (self.near + e) // self.twon1 if e > 0 \
                else -((self.near - e) // self.twon1)
        if e < 0:
            e += self.rng
        if e >= self.half_rng:
            e -= self.rng
        return e

    def _reconstruct(self, Px, sign, e):
        Rx = Px + sign * e * self.twon1
        if Rx < -self.near:
            Rx += self.full
        elif Rx > self.maxval + self.near:
            Rx -= self.full
        return min(max(Rx, 0), self.maxval)

    def regular(self, Ix, Ra, Rb, Rc, D1, D2, D3):
        """Encode one regular-mode sample; returns reconstructed Rx."""
        q1 = self.quantize(D1)
        q2 = self.quantize(D2)
        q3 = self.quantize(D3)
        sign = 1
        if q1 < 0 or (q1 == 0 and (q2 < 0 or (q2 == 0 and q3 < 0))):
            sign = -1
            q1, q2, q3 = -q1, -q2, -q3
        Q = q1 * 81 + q2 * 9 + q3

        mn, mx = (Ra, Rb) if Ra < Rb else (Rb, Ra)
        if Rc >= mx:
            Px = mn
        elif Rc <= mn:
            Px = mx
        else:
            Px = Ra + Rb - Rc
        Px += sign * self.C[Q]
        Px = min(max(Px, 0), self.maxval)

        e = self._reduce((Ix - Px) * sign)
        Rx = self._reconstruct(Px, sign, e)

        A, B, C, N = self.A, self.B, self.C, self.N
        k = 0
        while (N[Q] << k) < A[Q]:
            k += 1
        if self.near == 0 and k == 0 and 2 * B[Q] <= -N[Q]:
            merr = 2 * e + 1 if e >= 0 else -2 * (e + 1)
        else:
            merr = 2 * e if e >= 0 else -2 * e - 1
        self._golomb_limited(merr, k, self.limit)

        B[Q] += e * self.twon1
        A[Q] += abs(e)
        if N[Q] == self.reset:
            A[Q] >>= 1
            B[Q] = B[Q] >> 1 if B[Q] >= 0 else -((1 - B[Q]) >> 1)
            N[Q] >>= 1
        N[Q] += 1
        if B[Q] <= -N[Q]:
            if C[Q] > -128:
                C[Q] -= 1
            B[Q] += N[Q]
            if B[Q] <= -N[Q]:
                B[Q] = -N[Q] + 1
        elif B[Q] > 0:
            if C[Q] < 127:
                C[Q] += 1
            B[Q] -= N[Q]
            if B[Q] > 0:
                B[Q] = 0
        return Rx

    def run_interrupt(self, Ix, Ra, Rb, runindex, force_ri0=False):
        """Encode one run-interruption sample (contexts 365/366);
        force_ri0 selects the sample-interleaved rule (context 365
        regardless of |Ra - Rb|, T.87 8.3.3). Returns Rx."""
        ritype = 0 if force_ri0 else (
            1 if abs(Ra - Rb) <= self.near else 0)
        Px = Ra if ritype else Rb
        sign = -1 if (not ritype and Ra > Rb) else 1
        e = self._reduce((Ix - Px) * sign)
        Rx = self._reconstruct(Px, sign, e)

        A, N, Nn = self.A, self.N, self.Nn
        Q = 365 + ritype
        temp = A[366] + (N[366] >> 1) if ritype else A[365]
        k = 0
        while (N[Q] << k) < temp:
            k += 1
        if k == 0 and e > 0 and 2 * Nn[ritype] < N[Q]:
            emap = 1
        elif e < 0 and 2 * Nn[ritype] >= N[Q]:
            emap = 1
        elif e < 0 and k != 0:
            emap = 1
        else:
            emap = 0
        emerr = 2 * abs(e) - ritype - emap
        self._golomb_limited(emerr, k, self.limit - _J[runindex] - 1)
        if e < 0:
            Nn[ritype] += 1
        A[Q] += (emerr + 1 - ritype) >> 1
        if N[Q] == self.reset:
            A[Q] >>= 1
            N[Q] >>= 1
            Nn[ritype] >>= 1
        N[Q] += 1
        return Rx

    def emit_run(self, runcnt, runindex, hit_eol):
        """Emit the run-length ladder (T.87 A.7.1) for a run of
        `runcnt` positions; hit_eol means the run reached end of line
        (terminated without a 0 bit). Returns the updated runindex."""
        bw = self.bw
        while runcnt >= (1 << _J[runindex]):
            bw.put(1, 1)
            runcnt -= 1 << _J[runindex]
            if runindex < 31:
                runindex += 1
        if hit_eol:
            if runcnt > 0:
                bw.put(1, 1)
        else:
            bw.put(0, 1)
            if _J[runindex]:
                bw.put(runcnt, _J[runindex])
        return runindex


def _encode_line(coder, row, prev, cur, W, runindex):
    """Encode one line of one component (ILV 0 scans, per-component
    lines of ILV 1 scans); returns the updated runindex. prev/cur
    carry the decoder's margin layout: index x+1 = column x, prev[0]
    is the previous line's value of cur[0] (the T.87 Rc rule)."""
    near = coder.near
    prev[W + 1] = prev[W]
    cur[0] = prev[1]
    x = 0
    while x < W:
        Ra = cur[x]
        Rb = prev[x + 1]
        Rc = prev[x]
        Rd = prev[x + 2]
        D1 = Rd - Rb
        D2 = Rb - Rc
        D3 = Rc - Ra
        if abs(D1) <= near and abs(D2) <= near and abs(D3) <= near:
            # ---------------- run mode ----------------
            runcnt = 0
            while x + runcnt < W and abs(int(row[x + runcnt]) - Ra) \
                    <= near:
                runcnt += 1
            for i in range(runcnt):
                cur[x + 1 + i] = Ra
            end = x + runcnt
            runindex = coder.emit_run(runcnt, runindex, end >= W)
            x = end
            if x >= W:
                continue
            Rx = coder.run_interrupt(int(row[x]), cur[x], prev[x + 1],
                                     runindex)
            cur[x + 1] = Rx
            if runindex > 0:
                runindex -= 1
            x += 1
            continue

        cur[x + 1] = coder.regular(int(row[x]), Ra, Rb, Rc, D1, D2, D3)
        x += 1
    return runindex


def _encode_scan(img, W, H, maxval, near, t1, t2, t3, reset):
    """Entropy-coded bytes of ONE single-component scan (fresh context
    state per T.87 — each ILV-0 scan restarts its modeller)."""
    coder = _Coder(maxval, near, t1, t2, t3, reset)
    prev = [0] * (W + 2)
    cur = [0] * (W + 2)
    runindex = 0
    for y in range(H):
        runindex = _encode_line(coder, img[y], prev, cur, W, runindex)
        prev, cur = cur, prev
    coder.bw.flush()
    return bytes(coder.bw.out)


def _encode_scan_ilv1(planes, W, H, maxval, near, t1, t2, t3, reset):
    """Line-interleaved scan (ILV 1): per image line, one full line of
    each component in order; statistics shared, RUNindex per component
    (T.87 8.3.2)."""
    coder = _Coder(maxval, near, t1, t2, t3, reset)
    nc = len(planes)
    prevs = [[0] * (W + 2) for _ in range(nc)]
    curs = [[0] * (W + 2) for _ in range(nc)]
    runindex = [0] * nc
    for y in range(H):
        for c in range(nc):
            runindex[c] = _encode_line(coder, planes[c][y], prevs[c],
                                       curs[c], W, runindex[c])
            prevs[c], curs[c] = curs[c], prevs[c]
    coder.bw.flush()
    return bytes(coder.bw.out)


def _encode_scan_ilv2(planes, W, H, maxval, near, t1, t2, t3, reset):
    """Sample-interleaved scan (ILV 2): one sample of each component
    per position. A run requires the run condition in ALL components,
    its length is coded once, and the interruption samples are coded
    per component with RItype 0 and a single RUNindex decrement
    (T.87 8.3.3)."""
    coder = _Coder(maxval, near, t1, t2, t3, reset)
    nc = len(planes)
    prevs = [[0] * (W + 2) for _ in range(nc)]
    curs = [[0] * (W + 2) for _ in range(nc)]
    runindex = 0
    for y in range(H):
        rows = [planes[c][y] for c in range(nc)]
        for c in range(nc):
            prevs[c][W + 1] = prevs[c][W]
            curs[c][0] = prevs[c][1]
        x = 0
        while x < W:
            runmode = True
            Dv = []
            for c in range(nc):
                cur, prev = curs[c], prevs[c]
                Ra, Rb, Rc, Rd = cur[x], prev[x + 1], prev[x], \
                    prev[x + 2]
                D1, D2, D3 = Rd - Rb, Rb - Rc, Rc - Ra
                Dv.append((D1, D2, D3))
                if abs(D1) > coder.near or abs(D2) > coder.near \
                        or abs(D3) > coder.near:
                    runmode = False

            if runmode:
                Rav = [curs[c][x] for c in range(nc)]
                runcnt = 0
                while x + runcnt < W and all(
                        abs(int(rows[c][x + runcnt]) - Rav[c])
                        <= coder.near for c in range(nc)):
                    runcnt += 1
                for c in range(nc):
                    for i in range(runcnt):
                        curs[c][x + 1 + i] = Rav[c]
                end = x + runcnt
                runindex = coder.emit_run(runcnt, runindex, end >= W)
                x = end
                if x >= W:
                    continue
                for c in range(nc):
                    Rx = coder.run_interrupt(
                        int(rows[c][x]), curs[c][x], prevs[c][x + 1],
                        runindex, force_ri0=True)
                    curs[c][x + 1] = Rx
                if runindex > 0:
                    runindex -= 1
                x += 1
                continue

            for c in range(nc):
                cur, prev = curs[c], prevs[c]
                cur[x + 1] = coder.regular(
                    int(rows[c][x]), cur[x], prev[x + 1], prev[x],
                    *Dv[c])
            x += 1
        for c in range(nc):
            prevs[c], curs[c] = curs[c], prevs[c]
    coder.bw.flush()
    return bytes(coder.bw.out)


def encode_jpegls(image, precision=None, near=0, maxval=None,
                  thresholds=None, reset=64, ilv=0):
    """Encode a non-negative integer array as a JPEG-LS codestream.

    2D (H, W) -> single-component; 3D (H, W, C<=4) -> C components,
    laid out per ``ilv``: 0 = plane-separated (one SOS per component,
    the layout the DICOM writer emits), 1 = line interleaved, 2 =
    sample interleaved (both single-SOS; the CharLS color layouts the
    native decoder accepts). near=0 -> lossless (.4.80); near>0 ->
    near-lossless (.4.81) with |decoded - original| <= near
    guaranteed. Returns bytes.
    """
    img = np.ascontiguousarray(image)
    if img.dtype.kind not in "ui":
        raise ValueError("encode_jpegls: integer samples required")
    img = img.astype(np.int64)
    if img.ndim == 2:
        planes = [img]
    elif img.ndim == 3 and 1 <= img.shape[2] <= 4:
        planes = [np.ascontiguousarray(img[..., c])
                  for c in range(img.shape[2])]
    else:
        raise ValueError("encode_jpegls: expected (H, W) or "
                         "(H, W, C<=4)")
    if ilv not in (0, 1, 2):
        raise ValueError("encode_jpegls: ILV must be 0, 1 or 2")
    if ilv != 0 and len(planes) < 2:
        raise ValueError("encode_jpegls: ILV 1/2 need >= 2 components")
    if img.size and int(img.min()) < 0:
        raise ValueError("encode_jpegls: samples must be >= 0")
    H, W = planes[0].shape
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError("encode_jpegls: dimensions out of range")

    peak = int(img.max()) if img.size else 1
    if precision is None:
        precision = max(2, int(peak).bit_length())
    if not 2 <= precision <= 16:
        raise ValueError("encode_jpegls: precision must be 2..16")
    if maxval is None:
        maxval = (1 << precision) - 1
    if peak > maxval:
        raise ValueError("encode_jpegls: sample exceeds MAXVAL")
    near = int(near)
    if not 0 <= near <= min(255, maxval // 2):
        raise ValueError("encode_jpegls: NEAR out of range")

    t1d, t2d, t3d, _ = default_thresholds(maxval, near)
    if thresholds is None:
        t1, t2, t3 = t1d, t2d, t3d
    else:
        t1, t2, t3 = (int(t) for t in thresholds)
        if not near < t1 <= t2 <= t3 <= maxval:
            raise ValueError("encode_jpegls: bad thresholds")
    reset = int(reset)
    if not 3 <= reset <= max(255, maxval):
        raise ValueError("encode_jpegls: bad RESET")

    # ---- header -----------------------------------------------------
    nc = len(planes)
    out = bytearray(b"\xFF\xD8")                       # SOI
    sof = struct.pack(">BHHB", precision, H, W, nc) + b"".join(
        bytes([c + 1, 0x11, 0]) for c in range(nc))
    out += b"\xFF\xF7" + struct.pack(">H", len(sof) + 2) + sof  # SOF55
    nondefault = (maxval != (1 << precision) - 1 or reset != 64
                  or (t1, t2, t3) != (t1d, t2d, t3d))
    if nondefault:
        lse = bytes([1]) + struct.pack(">HHHHH", maxval, t1, t2, t3,
                                       reset)
        out += b"\xFF\xF8" + struct.pack(">H", len(lse) + 2) + lse
    if ilv == 0:
        for ci, plane in enumerate(planes):
            sos = bytes([1, ci + 1, 0x00, near, 0, 0])  # Cs,Tm,NEAR,ILV,Al
            out += b"\xFF\xDA" + struct.pack(">H", len(sos) + 2) + sos
            out += _encode_scan(plane, W, H, maxval, near, t1, t2, t3,
                                reset)
    else:
        comp = b"".join(bytes([c + 1, 0]) for c in range(nc))
        sos = bytes([nc]) + comp + bytes([near, ilv, 0])
        out += b"\xFF\xDA" + struct.pack(">H", len(sos) + 2) + sos
        enc = _encode_scan_ilv1 if ilv == 1 else _encode_scan_ilv2
        out += enc(planes, W, H, maxval, near, t1, t2, t3, reset)
    out += b"\xFF\xD9"                                 # EOI
    return bytes(out)
