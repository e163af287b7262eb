# Copied from medicalimageanalysis_tpu/dicom/jpeg2k_enc.py.
"""JPEG 2000 Part 1 (T.800) encoder.

Encoder counterpart of ``dicom.jpeg2k``, used for (a) DICOM
compressed WRITE of transfer syntaxes 1.2.840.10008.1.2.4.90/.91
(the reference cannot write compressed at all) and (b) generating
conformance streams that exercise every decoder feature cv2/OpenJPEG
cannot emit on this box: signed components, 12-bit precision,
multiple tiles, precincts + SOP/EPH, all five progression orders,
multiple layers, the six code-block style bits, 9/7 irreversible
coding, derived quantization.

Independence note: the *geometry* (tile/band/precinct/code-block
rectangles, progression iteration, tag trees) is shared with the
decoder module — it is purely structural — while everything
bit-producing (MQ coder, Tier-1 passes, packet headers, DWT) is
written independently against the spec text. Unsigned streams are
additionally cross-validated through OpenJPEG's decoder (cv2), which
independently checks the shared structural code.

Lossless round trips are bit-exact by construction (reversible 5/3 +
RCT, full passes, no truncation). 9/7 encoding quantizes with
delta_b = 2^(R_b - eps_b) and midpoint reconstruction bounds the
coefficient error by delta/2.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .jpeg2k import (
    CB_LAZY, CB_RESET, CB_SEGSYM, CB_TERMALL, CB_VSC,
    CTX_RL, CTX_UNI, _MQ_TABLE, _SIG_LUT, _SIGN_LUT, _build_tilecomp,
    _ceil_div, _initial_contexts, _pass_type, _seg_of_pass,
    _split_passes, _packet_sequence, _Main, CodingStyle, Quant,
    _K97, _A97, _B97, _G97, _D97, _reflect,
)

_KH_FWD = _K97         # forward high-pass scale (inverse of 1/K)

__all__ = ["encode_j2k"]

_PROGS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


# ---------------------------------------------------------------------------
# Bit / MQ writers
# ---------------------------------------------------------------------------

class BitWriter:
    """MSB-first bit packer with the packet-header / raw-segment
    stuffing rule: a byte following an emitted 0xFF carries 7 bits."""

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.n = 0
        self.room = 8

    def bit(self, b):
        self.cur = (self.cur << 1) | (b & 1)
        self.n += 1
        if self.n == self.room:
            self.out.append(self.cur)
            self.room = 7 if self.cur == 0xFF else 8
            self.cur = 0
            self.n = 0

    def bits(self, v, nbits):
        for i in range(nbits - 1, -1, -1):
            self.bit((v >> i) & 1)

    def flush(self):
        if self.n:
            self.cur <<= self.room - self.n
            self.out.append(self.cur)
            self.cur = 0
            self.n = 0
            self.room = 7 if self.out[-1] == 0xFF else 8
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0x00)
            self.room = 8
        return bytes(self.out)


class MQEncoder:
    """MQ encoder (T.800 C.2, software conventions)."""

    def __init__(self, ctx_idx, ctx_mps):
        self.idx = ctx_idx
        self.mps = ctx_mps
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.b = -1            # byte under construction (-1 = none yet)
        self.out = bytearray()

    def _byteout(self):
        if self.b == 0xFF:
            self._stuff()
            return
        if self.c & 0x8000000:   # carry bit only: after the flush
            self.b += 1          # shifts, higher bits are stale
            self.c &= 0x7FFFFFF
            if self.b == 0xFF:
                self._stuff()
                return
        self._nostuff()

    def _stuff(self):
        if self.b >= 0:
            self.out.append(self.b)
        self.b = (self.c >> 20) & 0xFF
        self.c &= 0xFFFFF
        self.ct = 7

    def _nostuff(self):
        if self.b >= 0:
            self.out.append(self.b)
        self.b = (self.c >> 19) & 0xFF
        self.c &= 0x7FFFF
        self.ct = 8

    def _renorm(self):
        while True:
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, cx, d):
        i = self.idx[cx]
        qe, nmps, nlps, switch = _MQ_TABLE[i]
        if d == self.mps[cx]:
            self.a -= qe
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.idx[cx] = nmps
                self._renorm()
            else:
                self.c += qe
        else:
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                self.mps[cx] ^= 1
            self.idx[cx] = nlps
            self._renorm()

    def flush(self):
        """Standard termination (T.800 C.2.9 FLUSH + SETBITS)."""
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        if self.b != 0xFF and self.b >= 0:
            self.out.append(self.b)
        self.b = -1
        data = bytes(self.out)
        while data and data[-1] == 0xFF:
            data = data[:-1]
        return data


class RawWriter:
    """Bypass-segment bit writer (same stuffing rule as BitWriter)."""

    def __init__(self):
        self.w = BitWriter()

    def bit(self, b):
        self.w.bit(b)

    def flush(self):
        data = self.w.flush()
        while data and data[-1] == 0xFF:
            data = data[:-1]
        return data


# ---------------------------------------------------------------------------
# Forward DWT (inverse of jpeg2k._sr1d, same boundary handling)
# ---------------------------------------------------------------------------

def _sd1d(a, i0, i1, irreversible):
    """1D analysis on the last axis; coords i0..i1-1."""
    n = i1 - i0
    if n == 1:
        if i0 % 2 == 1:
            if irreversible:
                return a / _K97
            return a * 2 if a.dtype.kind == "i" else a * 2
        return a
    shape = a.shape[:-1] + (n + 4,)
    ext = np.empty(shape, dtype=a.dtype)
    ext[..., 2:2 + n] = a

    def refresh():
        ext[..., 1] = ext[..., 2 + _reflect(-1, n)]
        ext[..., 0] = ext[..., 2 + _reflect(-2, n)]
        ext[..., 2 + n] = ext[..., 2 + _reflect(n, n)]
        ext[..., 3 + n] = ext[..., 2 + _reflect(n + 1, n)]

    refresh()
    ev = np.arange(i0 + (i0 & 1), i1, 2) - i0 + 2
    od = np.arange(i0 + 1 - (i0 & 1), i1, 2) - i0 + 2
    if not irreversible:
        ext[..., od] -= (ext[..., od - 1] + ext[..., od + 1]) >> 1
        refresh()
        ext[..., ev] += (ext[..., ev - 1] + ext[..., ev + 1] + 2) >> 2
    else:
        # standard 9/7 analysis: alpha/beta steps subtract (the spec's
        # alpha, beta are negative), gamma/delta add
        ext[..., od] -= _A97 * (ext[..., od - 1] + ext[..., od + 1])
        refresh()
        ext[..., ev] -= _B97 * (ext[..., ev - 1] + ext[..., ev + 1])
        refresh()
        ext[..., od] += _G97 * (ext[..., od - 1] + ext[..., od + 1])
        refresh()
        ext[..., ev] += _D97 * (ext[..., ev - 1] + ext[..., ev + 1])
        ext[..., ev] *= (1.0 / _K97)
        ext[..., od] *= _KH_FWD
    return ext[..., 2:2 + n]


def _fdwt(plane, tcx0, tcy0, nl, irreversible):
    """Forward multilevel DWT; returns {(r, orient): band array}."""
    out = {}
    cur = plane
    x0, y0 = tcx0, tcy0
    x1 = tcx0 + plane.shape[1]
    y1 = tcy0 + plane.shape[0]
    for lev in range(1, nl + 1):
        r = nl - lev + 1
        # analysis: columns then rows (inverse of HOR->VER synthesis)
        a = _sd1d(np.ascontiguousarray(cur.T), y0, y1, irreversible)
        a = _sd1d(np.ascontiguousarray(a.T), x0, x1, irreversible)
        ye = 0 if y0 % 2 == 0 else 1
        xe = 0 if x0 % 2 == 0 else 1
        out[(r, 1)] = np.ascontiguousarray(a[ye::2, 1 - xe::2])    # HL
        out[(r, 2)] = np.ascontiguousarray(a[1 - ye::2, xe::2])    # LH
        out[(r, 3)] = np.ascontiguousarray(a[1 - ye::2, 1 - xe::2])  # HH
        cur = np.ascontiguousarray(a[ye::2, xe::2])                # LL
        x0, y0 = _ceil_div(x0, 2), _ceil_div(y0, 2)
        x1, y1 = _ceil_div(x1, 2), _ceil_div(y1, 2)
    out[(0, 0)] = cur
    return out


# ---------------------------------------------------------------------------
# Tier-1 encoder (T.800 Annex D, encoder direction)
# ---------------------------------------------------------------------------

def _t1_encode(vals, orient, mb, cbstyle):
    """Encode one code block. `vals` is an int array (h, w) of
    sign-magnitude coefficients (already quantized for 9/7).

    Returns (zbp, [segment bytes...], total passes)."""
    h, w = vals.shape
    mag_a = np.abs(vals.astype(np.int64))
    maxmag = int(mag_a.max()) if mag_a.size else 0
    actual_bits = maxmag.bit_length()
    if actual_bits > mb:
        raise ValueError("JPEG2000 encode: coefficient magnitude exceeds "
                         "Mb; raise guard bits")
    zbp = mb - actual_bits if actual_bits else mb
    numbps = mb - zbp
    npasses = max(3 * numbps - 2, 0)
    if npasses == 0:
        return zbp, [], 0
    size = w * h
    mg = [int(v) for v in mag_a.reshape(-1)]
    sg = [1 if v < 0 else 0 for v in vals.reshape(-1)]
    sig = [0] * size
    vis = [0] * size
    ref = [0] * size
    vsc = bool(cbstyle & CB_VSC)
    lazy = bool(cbstyle & CB_LAZY)
    lut = _SIG_LUT

    def sig_at(x, y, ystripe):
        if x < 0 or x >= w or y < 0 or y >= h:
            return 0
        if vsc and (y >> 2) > ystripe:
            return 0
        return sig[y * w + x]

    def sig_ctx(x, y):
        ys = y >> 2
        hh_ = sig_at(x - 1, y, ys) + sig_at(x + 1, y, ys)
        vv = sig_at(x, y - 1, ys) + sig_at(x, y + 1, ys)
        dd = (sig_at(x - 1, y - 1, ys) + sig_at(x + 1, y - 1, ys)
              + sig_at(x - 1, y + 1, ys) + sig_at(x + 1, y + 1, ys))
        return lut[(orient, hh_, vv, dd)]

    def contrib(x, y, ystripe):
        if x < 0 or x >= w or y < 0 or y >= h:
            return 0
        if vsc and (y >> 2) > ystripe:
            return 0
        i = y * w + x
        if not sig[i]:
            return 0
        return -1 if sg[i] else 1

    def sign_ctx(x, y):
        ys = y >> 2
        hc = max(-1, min(1, contrib(x - 1, y, ys) + contrib(x + 1, y, ys)))
        vc = max(-1, min(1, contrib(x, y - 1, ys) + contrib(x, y + 1, ys)))
        return _SIGN_LUT[(hc + 1, vc + 1)]

    ctx_idx, ctx_mps = _initial_contexts()
    segments = {}
    mq = None
    raw = None
    cur_seg = -1
    plane = numbps - 1

    def close_current():
        nonlocal mq, raw
        if mq is not None:
            segments[cur_seg] = mq.flush()
            mq = None
        if raw is not None:
            segments[cur_seg] = raw.flush()
            raw = None

    for pidx in range(npasses):
        ptype = _pass_type(pidx)
        is_raw = lazy and pidx >= 10 and ptype != 2
        sid = _seg_of_pass(pidx, cbstyle)
        if sid != cur_seg:
            close_current()
            if is_raw:
                raw = RawWriter()
            else:
                mq = MQEncoder(ctx_idx, ctx_mps)
            cur_seg = sid
        elif is_raw and raw is None:
            raise AssertionError("segment mixes raw and MQ passes")
        if (cbstyle & CB_RESET) and not is_raw:
            ni, nm = _initial_contexts()
            ctx_idx[:] = ni
            ctx_mps[:] = nm
            if mq is not None:
                mq.idx = ctx_idx
                mq.mps = ctx_mps
        bit = 1 << plane

        if ptype == 0:          # significance propagation
            for y0 in range(0, h, 4):
                ylim = min(y0 + 4, h)
                for x in range(w):
                    for y in range(y0, ylim):
                        i = y * w + x
                        if sig[i]:
                            continue
                        cx = sig_ctx(x, y)
                        if cx == 0:
                            continue
                        vis[i] = 1
                        d = 1 if (mg[i] & bit) else 0
                        if is_raw:
                            raw.bit(d)
                        else:
                            mq.encode(cx, d)
                        if d:
                            if is_raw:
                                raw.bit(sg[i])
                            else:
                                sctx, xorbit = sign_ctx(x, y)
                                mq.encode(sctx, sg[i] ^ xorbit)
                            sig[i] = 1
        elif ptype == 1:        # magnitude refinement
            for y0 in range(0, h, 4):
                ylim = min(y0 + 4, h)
                for x in range(w):
                    for y in range(y0, ylim):
                        i = y * w + x
                        if not sig[i] or vis[i]:
                            continue
                        d = 1 if (mg[i] & bit) else 0
                        if is_raw:
                            raw.bit(d)
                        else:
                            if ref[i]:
                                cx = 16
                            else:
                                ys = y >> 2
                                any_sig = (
                                    sig_at(x - 1, y, ys)
                                    + sig_at(x + 1, y, ys)
                                    + sig_at(x, y - 1, ys)
                                    + sig_at(x, y + 1, ys)
                                    + sig_at(x - 1, y - 1, ys)
                                    + sig_at(x + 1, y - 1, ys)
                                    + sig_at(x - 1, y + 1, ys)
                                    + sig_at(x + 1, y + 1, ys))
                                cx = 15 if any_sig else 14
                            mq.encode(cx, d)
                        ref[i] = 1
        else:                   # cleanup
            for y0 in range(0, h, 4):
                ylim = min(y0 + 4, h)
                for x in range(w):
                    y = y0
                    if ylim - y0 == 4:
                        rl_ok = True
                        for yy in range(y0, ylim):
                            i = yy * w + x
                            if sig[i] or vis[i] or sig_ctx(x, yy) != 0:
                                rl_ok = False
                                break
                        if rl_ok:
                            first = -1
                            for rr in range(4):
                                if mg[(y0 + rr) * w + x] & bit:
                                    first = rr
                                    break
                            if first < 0:
                                mq.encode(CTX_RL, 0)
                                continue
                            mq.encode(CTX_RL, 1)
                            mq.encode(CTX_UNI, (first >> 1) & 1)
                            mq.encode(CTX_UNI, first & 1)
                            y = y0 + first
                            i = y * w + x
                            sctx, xorbit = sign_ctx(x, y)
                            mq.encode(sctx, sg[i] ^ xorbit)
                            sig[i] = 1
                            y += 1
                    while y < ylim:
                        i = y * w + x
                        if not sig[i] and not vis[i]:
                            cx = sig_ctx(x, y)
                            d = 1 if (mg[i] & bit) else 0
                            mq.encode(cx, d)
                            if d:
                                sctx, xorbit = sign_ctx(x, y)
                                mq.encode(sctx, sg[i] ^ xorbit)
                                sig[i] = 1
                        y += 1
            if cbstyle & CB_SEGSYM:
                for b in (1, 0, 1, 0):
                    mq.encode(CTX_UNI, b)
            for i in range(size):
                vis[i] = 0
            plane -= 1
    close_current()
    seg_list = [bytes(segments.get(s, b""))
                for s in range(max(segments) + 1)] if segments else []
    return zbp, seg_list, npasses


# ---------------------------------------------------------------------------
# Packet assembly + codestream writing
# ---------------------------------------------------------------------------

def _encode_zbp(wtr, tree, x, y):
    """Emit the full leaf value (decoder loops thresholds until known)."""
    t = 1
    while True:
        tree.encode(wtr, x, y, t)
        lw = tree.levels[0][0]
        if tree.known[0][y * lw + x]:
            return
        t += 1


def _write_packet(out, res, pidx, layer, scod, cbstyle, plan, nsop):
    """Emit one packet; `plan` maps id(cb) -> per-layer
    (new_passes, [(sid, portion_passes, portion_bytes), ...])."""
    if scod & 2:
        out += b"\xFF\x91" + struct.pack(">HH", 4, nsop & 0xFFFF)
    wtr = BitWriter()
    contribs = []
    any_contrib = False
    for pb in res.precincts[pidx]:
        if pb.ncbw == 0:
            continue
        for ci, cb in enumerate(pb.cbs):
            entry = plan.get(id(cb))
            if entry and entry[layer][0] > 0:
                any_contrib = True
    if not any_contrib:
        wtr.bit(0)
        out += wtr.flush()
        if scod & 4:
            out += b"\xFF\x92"
        return
    wtr.bit(1)
    for pb in res.precincts[pidx]:
        if pb.ncbw == 0:
            continue
        for ci, cb in enumerate(pb.cbs):
            x = ci % pb.ncbw
            y = ci // pb.ncbw
            entry = plan.get(id(cb))
            new_passes, portions = entry[layer] if entry else (0, [])
            if not cb.included:
                pb.incl_tree.encode(wtr, x, y, layer + 1)
                first = not cb.included and new_passes > 0
            else:
                wtr.bit(1 if new_passes else 0)
                first = False
            if new_passes == 0:
                continue
            if first:
                cb.included = True
                _encode_zbp(wtr, pb.zbp_tree, x, y)
            # pass-count code (Table B.4)
            n = new_passes
            if n == 1:
                wtr.bit(0)
            elif n == 2:
                wtr.bits(0b10, 2)
            elif n <= 5:
                wtr.bits(0b11, 2)
                wtr.bits(n - 3, 2)
            elif n <= 36:
                wtr.bits(0b1111, 4)
                wtr.bits(n - 6, 5)
            else:
                wtr.bits(0b1111, 4)
                wtr.bits(31, 5)
                wtr.bits(n - 37, 7)
            # Lblock increments so every portion length fits
            need = 0
            for sid, np_, nbytes in portions:
                bits_avail = int(math.floor(math.log2(np_)))
                need = max(need,
                           max(nbytes.bit_length(), 1)
                           - bits_avail - cb.lblock)
            for _ in range(need):
                wtr.bit(1)
            wtr.bit(0)
            cb.lblock += need
            for sid, np_, nbytes in portions:
                nbits = cb.lblock + int(math.floor(math.log2(np_)))
                wtr.bits(nbytes, nbits)
            contribs.append((cb, portions))
    out += wtr.flush()
    if scod & 4:
        out += b"\xFF\x92"
    for cb, portions in contribs:
        for sid, np_, nbytes in portions:
            seg, cur = cb.seg_state[sid]
            out += seg[cur:cur + nbytes]
            cb.seg_state[sid][1] = cur + nbytes


def _plan_layers(cb, zbp, segs, npasses, layers, cbstyle):
    """Distribute a code block's passes and bytes over layers."""
    cb.zbp = zbp
    cb.seg_state = {sid: [seg, 0] for sid, seg in enumerate(segs)}
    # per-segment pass spans
    spans = {}
    for p in range(npasses):
        sid = _seg_of_pass(p, cbstyle)
        a, b = spans.get(sid, (p, p))
        spans[sid] = (min(a, p), max(b, p))
    plan = []
    for l in range(layers):
        p0 = npasses * l // layers
        p1 = npasses * (l + 1) // layers
        n = p1 - p0
        portions = []
        for sid, np_ in _split_passes(p0, n, cbstyle):
            a, b = spans[sid]
            seg = segs[sid]

            def cum(p):
                if p < a:
                    return 0
                if p >= b:
                    return len(seg)
                return len(seg) * (p - a + 1) // (b - a + 1)
            nbytes = cum(p0 + sum(x[1] for x in portions) + np_ - 1) \
                - cum(p0 + sum(x[1] for x in portions) - 1)
            portions.append((sid, np_, nbytes))
        plan.append((n, portions))
    return plan


def _quantize_band(coefs, band, prec, irreversible):
    if not irreversible:
        return np.asarray(coefs, dtype=np.int64)
    rb = prec + band.gain
    delta = (2.0 ** (rb - band.eps)) * (1.0 + band.mant / 2048.0)
    q = np.sign(coefs) * np.floor(np.abs(coefs) / delta)
    return q.astype(np.int64)


def encode_j2k(arr, *, irreversible=False, levels=5, precision=None,
               signed=None, tile_size=None, prog="LRCP", layers=1,
               cb_exp=(6, 6), precincts=None, sop=False, eph=False,
               cbstyle=0, mct=None, quant="expounded", guard=None):
    """Encode an image as a raw JPEG 2000 Part-1 codestream.

    arr: (h, w) or (h, w, ncomp) integer array. `precision` defaults
    to the smallest of 8/12/16 covering the data; `signed` defaults to
    the dtype's signedness. `mct` defaults to True for 3+ components.
    Lossless when irreversible=False (reversible 5/3 + RCT).
    """
    arr = np.asarray(arr)
    if guard is None:
        # 9/7 low-pass gain accumulates ~sqrt(2)/level; 4 guard bits
        # absorb any practical decomposition depth (reversible needs 2)
        guard = 2 if not irreversible else 4
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, ncomp = arr.shape
    if signed is None:
        signed = arr.dtype.kind == "i"
    if precision is None:
        m = int(np.abs(arr).max()) if arr.size else 1
        bits = max(m.bit_length() + (1 if signed else 0), 1)
        precision = next(p for p in (8, 12, 16, 24, 32) if p >= bits)
    if mct is None:
        mct = ncomp >= 3
    prog_id = _PROGS[prog] if isinstance(prog, str) else int(prog)
    xts, yts = tile_size if tile_size else (max(w, 1), max(h, 1))

    m = _Main()
    m.rsiz = 0
    m.xs, m.ys, m.xo, m.yo = w, h, 0, 0
    m.xts, m.yts, m.xto, m.yto = xts, yts, 0, 0
    m.csiz = ncomp
    m.comp_prec = [precision] * ncomp
    m.comp_signed = [bool(signed)] * ncomp
    m.prog, m.layers, m.mct = prog_id, layers, (1 if mct else 0)

    cs = CodingStyle()
    cs.nl = levels
    cs.xcb, cs.ycb = cb_exp
    cs.cbstyle = cbstyle
    cs.transform = 0 if irreversible else 1
    if precincts:
        pe = list(precincts)
        while len(pe) < levels + 1:
            pe.append(pe[-1])
        cs.prec_exps = pe[:levels + 1]
    else:
        cs.prec_exps = [(15, 15)] * (levels + 1)

    q = Quant()
    q.guard = guard
    if not irreversible:
        q.style = 0
        q.steps = [(precision + 0, 0)]
        for r in range(1, levels + 1):
            for orient in (1, 2, 3):
                q.steps.append((precision + (1 if orient < 3 else 2), 0))
    elif quant == "derived":
        q.style = 1
        q.steps = [(precision, 0)]
    else:
        q.style = 2
        q.steps = [(precision + 0, 0)]
        for r in range(1, levels + 1):
            for orient in (1, 2, 3):
                q.steps.append((precision + (1 if orient < 3 else 2), 0))

    # ---- main header ----
    out = bytearray(b"\xFF\x4F")
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, xts, yts, 0, 0, ncomp)
    ssiz = (precision - 1) | (0x80 if signed else 0)
    for _ in range(ncomp):
        siz += bytes([ssiz, 1, 1])
    out += b"\xFF\x51" + struct.pack(">H", len(siz) + 2) + siz
    scod = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)
    spcod = bytes([levels, cs.xcb - 2, cs.ycb - 2, cbstyle, cs.transform])
    if precincts:
        spcod += bytes([(py << 4) | px for (px, py) in cs.prec_exps])
    cod = bytes([scod, prog_id]) + struct.pack(">H", layers) \
        + bytes([m.mct]) + spcod
    out += b"\xFF\x52" + struct.pack(">H", len(cod) + 2) + cod
    if q.style == 0:
        qcd = bytes([(guard << 5) | 0])
        qcd += bytes([e << 3 for (e, mu) in q.steps])
    elif q.style == 1:
        e, mu = q.steps[0]
        qcd = bytes([(guard << 5) | 1]) + struct.pack(">H", (e << 11) | mu)
    else:
        qcd = bytes([(guard << 5) | 2])
        for e, mu in q.steps:
            qcd += struct.pack(">H", (e << 11) | mu)
    out += b"\xFF\x5C" + struct.pack(">H", len(qcd) + 2) + qcd

    # ---- component planes (DC shift + MCT) ----
    planes = [arr[:, :, c].astype(np.int64) for c in range(ncomp)]
    if not signed:
        planes = [p - (1 << (precision - 1)) for p in planes]
    if m.mct and ncomp >= 3:
        r_, g_, b_ = planes[0], planes[1], planes[2]
        if not irreversible:       # RCT
            y_ = (r_ + 2 * g_ + b_) >> 2
            cb_ = b_ - g_
            cr_ = r_ - g_
        else:                      # ICT
            rf, gf, bf = (p.astype(np.float64) for p in (r_, g_, b_))
            y_ = 0.299 * rf + 0.587 * gf + 0.114 * bf
            cb_ = -0.168736 * rf - 0.331264 * gf + 0.5 * bf
            cr_ = 0.5 * rf - 0.418688 * gf - 0.081312 * bf
        planes[0], planes[1], planes[2] = y_, cb_, cr_
    if irreversible:
        planes = [p.astype(np.float64) for p in planes]

    # ---- tiles ----
    ntx = _ceil_div(w, xts)
    nty = _ceil_div(h, yts)
    nsop = 0
    for tidx in range(ntx * nty):
        p_, q_ = tidx % ntx, tidx // ntx
        tx0, ty0 = p_ * xts, q_ * yts
        tx1, ty1 = min(tx0 + xts, w), min(ty0 + yts, h)
        tcs = [_build_tilecomp(m, c, cs, q, tx0, ty0, tx1, ty1)
               for c in range(ncomp)]
        plan = {}
        for c, tc in enumerate(tcs):
            bands_f = _fdwt(planes[c][ty0:ty1, tx0:tx1], tx0, ty0,
                            levels, irreversible)
            for res in tc.resolutions:
                for band in res.bands:
                    coefs = bands_f[(res.r, band.orient)]
                    qc = _quantize_band(coefs, band, precision,
                                        irreversible)
                    mb = q.guard + band.eps - 1
                    for pbs in res.precincts:
                        pb = pbs[res.bands.index(band)]
                        if pb.ncbw == 0:
                            continue
                        incl_vals = np.zeros((pb.ncbh, pb.ncbw),
                                             dtype=np.int32)
                        zbp_vals = np.zeros((pb.ncbh, pb.ncbw),
                                            dtype=np.int32)
                        for ci, cb in enumerate(pb.cbs):
                            sub = qc[cb.y0 - band.y0:cb.y1 - band.y0,
                                     cb.x0 - band.x0:cb.x1 - band.x0]
                            zbp, segs, npasses = _t1_encode(
                                sub, band.orient, mb, cbstyle)
                            cx, cy = ci % pb.ncbw, ci // pb.ncbw
                            zbp_vals[cy, cx] = zbp
                            if npasses == 0:
                                incl_vals[cy, cx] = layers  # never
                                continue
                            cbplan = _plan_layers(cb, zbp, segs,
                                                  npasses, layers,
                                                  cbstyle)
                            plan[id(cb)] = cbplan
                            incl_vals[cy, cx] = next(
                                l for l, (n, _) in enumerate(cbplan)
                                if n > 0)
                        pb.incl_tree.set_values(incl_vals)
                        pb.zbp_tree.set_values(zbp_vals)
        body = bytearray()
        for (l, r, c, pidx) in _packet_sequence(m, tcs, tx0, ty0,
                                                tx1, ty1):
            res = tcs[c].resolutions[r]
            if res.npw * res.nph == 0:
                continue
            _write_packet(body, res, pidx, l, scod, cbstyle, plan, nsop)
            nsop += 1
        psot = 12 + 2 + len(body)
        out += b"\xFF\x90" + struct.pack(">HHIBB", 10, tidx, psot,
                                         0, 1)
        out += b"\xFF\x93" + body
    out += b"\xFF\xD9"
    return bytes(out)
