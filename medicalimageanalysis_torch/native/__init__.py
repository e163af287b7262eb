# Copied from medicalimageanalysis_tpu/native/__init__.py.
"""ctypes loader for libmiadicom (native host DICOM core).

Builds the shared library on first use if g++ is available; every entry
point has a pure-Python fallback, so the framework works without a
compiler (graceful degradation, never a hard dependency).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_FLAGS = ("-shared", "-fPIC", "-std=c++17", "-pthread")


def _so_path(stem, src):
    """build/torch_ext/ at the root of the checkout (git-ignored), named by
    a hash of the source and flags: never the JAX package's
    libmiadicom.so."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                        "torch_ext", f"{stem}_{digest}.so")


_SRC = os.path.join(_DIR, "dicomscan.cpp")
_SO = _so_path("libmia_torch_dicom", _SRC)
# the border tracer (contour_trace.cpp), a library of its own
_TRACE_SRC = os.path.join(_DIR, "contour_trace.cpp")

_lib = None
_tried = False
_trace_lib = None
_trace_lock = threading.Lock()


class Entry(ctypes.Structure):
    _fields_ = [("tag", ctypes.c_uint32),
                ("vr", ctypes.c_uint16),
                ("depth", ctypes.c_uint16),
                ("off", ctypes.c_uint64),
                ("len", ctypes.c_uint64)]


ENTRY_DTYPE = np.dtype([("tag", np.uint32), ("vr", np.uint16),
                        ("depth", np.uint16), ("off", np.uint64),
                        ("len", np.uint64)])


def _build(src=_SRC, so=_SO):
    # Build to a private temp path and os.replace into place: two
    # processes racing on first import (e.g. pytest + a bench script on
    # a fresh checkout) must never CDLL a half-written .so or clobber
    # each other's output mid-write. 12 s unloaded can exceed 120 s
    # under the shared-VM CPU steal documented in docs/PERF.md, so the
    # timeout is generous and a timed-out -O3 retries once at -O1
    # (compiles ~4x faster; only the inner decode loops care about -O3
    # and a slow-but-working library beats none).
    tmp = f"{so}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(so), exist_ok=True)
    for opt in ("-O3", "-O1"):
        try:
            subprocess.run(
                ["g++", opt, *_FLAGS, "-o", tmp, src],
                check=True, capture_output=True, timeout=600)
            os.replace(tmp, so)
            return True
        except subprocess.TimeoutExpired:
            continue
        except Exception:
            break
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        # a pre-existing .so can be stale/corrupt (interrupted build of
        # an older layout): rebuild once before giving up
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None

    lib.mia_scan.restype = ctypes.c_int64
    lib.mia_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(Entry), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64)]

    lib.mia_scan_batch.restype = ctypes.c_int64
    lib.mia_scan_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(Entry),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]

    lib.mia_gather_blocks.restype = ctypes.c_int64
    lib.mia_gather_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]

    lib.mia_rle_decode.restype = ctypes.c_int
    lib.mia_rle_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]

    lib.mia_jpegls14_decode.restype = ctypes.c_int
    lib.mia_jpegls14_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]

    lib.mia_jpegls_decode.restype = ctypes.c_int
    lib.mia_jpegls_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]

    lib.mia_jpegls_encode.restype = ctypes.c_int64
    lib.mia_jpegls_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]

    lib.mia_jpegdct_decode.restype = ctypes.c_int
    lib.mia_jpegdct_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]

    lib.mia_j2k_decode.restype = ctypes.c_int
    lib.mia_j2k_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]

    lib.mia_pack12.restype = ctypes.c_int
    lib.mia_pack12.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int]

    lib.mia_mc_run.restype = ctypes.c_void_p
    lib.mia_mc_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.mia_mc_fetch.restype = ctypes.c_int
    lib.mia_mc_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return _lib


def scan(buf, stop_before_pixels=False, max_entries=8192):
    """Native element scan -> (entries structured array, meta tuple)
    or None if the native path is unavailable/failed."""
    lib = get_lib()
    if lib is None:
        return None
    entries = (Entry * max_entries)()
    meta = (ctypes.c_uint64 * 4)()
    n = lib.mia_scan(buf, len(buf), int(stop_before_pixels), entries,
                     max_entries, meta)
    if n == -3 and max_entries < 262144:
        return scan(buf, stop_before_pixels, max_entries * 4)
    if n < 0:
        return None
    arr = np.frombuffer(entries, dtype=ENTRY_DTYPE, count=n).copy()
    return arr, (int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3]))


_scan_arena = threading.local()


def scan_batch(buffers, stop_before_pixels=False, max_entries=2048,
               n_threads=0):
    """Scan many in-memory DICOM buffers from a C++ thread pool (one
    GIL release for the whole batch). Returns (entries (n, max_entries)
    structured array, counts (n,) int64, metas (n, 4) uint64) or None.
    counts[i] < 0 mirrors mia_scan error codes; -3 (table overflow)
    callers should retry per-file with a bigger table.

    The entry table is a REUSED THREAD-LOCAL arena (a fresh ~16 MB
    np.zeros per cohort cost more in page faults than the scan itself,
    and thread-locality means two concurrent scan_batch callers — e.g.
    two DicomReaders in threads — can never overwrite each other's
    tables); rows beyond counts[i] hold stale garbage from earlier
    calls, and the WHOLE table is invalidated by this thread's next
    scan_batch call — callers must copy out what they keep
    (datasets_from_scan_batch does)."""
    lib = get_lib()
    if lib is None or not buffers:
        return None
    n = len(buffers)
    bufs = (ctypes.c_char_p * n)(*buffers)
    lens = (ctypes.c_uint64 * n)(*[len(b) for b in buffers])
    arena = getattr(_scan_arena, "entries", None)
    if arena is None or arena.size < n * max_entries:
        arena = np.zeros(n * max_entries, dtype=ENTRY_DTYPE)
        _scan_arena.entries = arena
    entries = arena[:n * max_entries].reshape(n, max_entries)
    counts = np.zeros(n, np.int64)
    metas = np.zeros((n, 4), np.uint64)
    lib.mia_scan_batch(
        bufs, lens, n, int(stop_before_pixels),
        entries.ctypes.data_as(ctypes.POINTER(Entry)), max_entries,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        metas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        int(n_threads))
    return entries, counts, metas


def gather_blocks(buffers, offsets, sizes, out, stride, n_threads=0):
    """Parallel memcpy of per-buffer byte blocks into a strided arena:
    out[i*stride : i*stride+sizes[i]] = buffers[i][offsets[i]:...].
    Returns the number of blocks skipped for exceeding the stride."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(buffers)
    bufs = (ctypes.c_char_p * n)(*buffers)
    offs = (ctypes.c_uint64 * n)(*[int(o) for o in offsets])
    szs = (ctypes.c_uint64 * n)(*[int(s) for s in sizes])
    return int(lib.mia_gather_blocks(
        bufs, offs, szs, n, out.ctypes.data_as(ctypes.c_void_p),
        int(stride), int(n_threads)))


def rle_decode_frame(frag, rows, cols, samples, bytes_per_sample):
    """Native RLE frame decode -> bytes, or None on fallback."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(rows * cols * samples * bytes_per_sample, np.uint8)
    rc = lib.mia_rle_decode(frag, len(frag),
                            out.ctypes.data_as(ctypes.c_void_p),
                            rows, cols, samples, bytes_per_sample)
    if rc != 0:
        return None
    return out


def _jpeg_decode_via(fn_name, frag):
    lib = get_lib()
    if lib is None:
        return None
    fn = getattr(lib, fn_name)
    # generous capacity guess; retry bigger on -6. np.empty, not
    # np.zeros: the decoder writes every used pixel, and zeroing 16 MB
    # per frame cost ~25% of a 256^2 decode. The result is COPIED out
    # of the arena — returning a view pinned the whole arena per frame
    # (4.8 GB transient for a 300-slice compressed series).
    cap = 1 << 22
    for _ in range(4):
        out = np.empty(cap, np.int32)
        w = ctypes.c_int()
        h = ctypes.c_int()
        nc = ctypes.c_int()
        prec = ctypes.c_int()
        rc = fn(frag, len(frag), out.ctypes.data_as(ctypes.c_void_p),
                cap, ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc),
                ctypes.byref(prec))
        if rc == -6:
            cap *= 4
            continue
        if rc != 0:
            return None
        n = w.value * h.value * nc.value
        arr = out[:n].copy()
        if nc.value > 1:
            return arr.reshape(h.value, w.value, nc.value)
        return arr.reshape(h.value, w.value)
    return None


def jpeg_lossless_decode(frag):
    """Native JPEG-Lossless (SOF3) decode -> (array (H, W[, C]) int32)
    or None."""
    return _jpeg_decode_via("mia_jpegls14_decode", frag)


def jpegls_t87_decode(frag):
    """Native JPEG-LS (ITU-T T.87, DICOM .4.80 lossless / .4.81
    near-lossless) decode -> array (H, W) int32, or (H, W, C) for
    multi-component plane-separated (ILV 0) streams, or None. The
    codec the reference gets from GDCM/CharLS (ref read/dicom.py:52);
    cv2 ships no JPEG-LS support."""
    return _jpeg_decode_via("mia_jpegls_decode", frag)


def jpegls_t87_encode(arr, precision, near=0):
    """Native JPEG-LS encode of (H, W) or (H, W, C<=4) non-negative
    int arrays -> codestream bytes, or None when the native library is
    unavailable (callers fall back to the Python encoder, which is
    bit-identical but ~100x slower). Default thresholds, no LSE."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, np.int32)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or not 1 <= a.shape[2] <= 4:
        raise ValueError("jpegls_t87_encode: (H, W) or (H, W, C<=4)")
    H, W, C = a.shape
    cap = a.size * 4 + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.mia_jpegls_encode(
        a.ctypes.data_as(ctypes.c_void_p), W, H, C, int(precision),
        int(near), out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise ValueError(f"jpegls_t87_encode: rc={n} (out-of-range "
                         "samples or bad parameters)")
    return out[:n].tobytes()


def j2k_decode(frag):
    """Native JPEG 2000 Part-1 decode (DICOM .4.90/.91, raw codestream
    or JP2 container) -> array (H, W) or (H, W, C) int32, or None.
    Values are DC-shifted/clipped to the component precision; signed
    components carry their sign. Validated block-for-block against the
    Python golden decoder (dicom/jpeg2k.py) and OpenJPEG."""
    return _jpeg_decode_via("mia_j2k_decode", frag)


def jpeg_dct_decode(frag):
    """Native sequential-DCT JPEG decode (SOF0 baseline 8-bit / SOF1
    Extended 12-bit, DICOM .50/.51) -> array (H, W[, C]) int32 or
    None. Covers the 12-bit JPEG-Extended path GDCM provides the
    reference and cv2 cannot decode (VERDICT r2 missing #1)."""
    return _jpeg_decode_via("mia_jpegdct_decode", frag)


def marching_cubes_native(vol8, flat_tab, starts, ntris, pad=False,
                          n_threads=0):
    """Fused native marching tetrahedra on a 0/1 uint8 volume ->
    (points (P, 3) float32 in pixel coords of the (virtually) padded
    volume, faces (F, 3) int32) or None on fallback. With pad=True the
    one-voxel zero border is applied VIRTUALLY inside the kernel (no
    host-side np.pad copy). Tables come from
    ops.marching_cubes._binary_tables (device-kernel-generated) so the
    native, numpy, and device paths stay bit-identical; output ordering
    (ascending packed-key points, emit-order faces) matches the numpy
    path exactly."""
    lib = get_lib()
    if lib is None:
        return None
    vol8 = np.ascontiguousarray(vol8, dtype=np.uint8)
    flat_tab = np.ascontiguousarray(flat_tab, dtype=np.int16)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ntris = np.ascontiguousarray(ntris, dtype=np.int64)
    npts = ctypes.c_int64()
    nfc = ctypes.c_int64()
    h = lib.mia_mc_run(
        vol8.ctypes.data_as(ctypes.c_void_p),
        vol8.shape[0], vol8.shape[1], vol8.shape[2],
        flat_tab.ctypes.data_as(ctypes.c_void_p),
        starts.ctypes.data_as(ctypes.c_void_p),
        ntris.ctypes.data_as(ctypes.c_void_p),
        int(bool(pad)), int(n_threads),
        ctypes.byref(npts), ctypes.byref(nfc))
    if not h:
        return None
    pts = np.empty((npts.value, 3), np.float32)
    faces = np.empty((nfc.value, 3), np.int32)
    lib.mia_mc_fetch(ctypes.c_void_p(h),
                     pts.ctypes.data_as(ctypes.c_void_p),
                     faces.ctypes.data_as(ctypes.c_void_p))
    return pts, faces


def pack12_native(arr_i16, lo, out_words, n_threads=0):
    """Threaded 12-bit packing: arr (groups*8,) contiguous int16 ->
    out (groups*3,) uint32. Returns False when the native lib is
    unavailable (caller falls back to numpy)."""
    lib = get_lib()
    if lib is None:
        return False
    n_groups = arr_i16.size // 8
    lib.mia_pack12(arr_i16.ctypes.data_as(ctypes.c_void_p), n_groups,
                   int(lo), out_words.ctypes.data_as(ctypes.c_void_p),
                   int(n_threads))
    return True


def get_trace_lib():
    """Load (building with g++ if needed) the border tracer's library.
    Raises RuntimeError when it cannot be built or loaded: contours have
    no other path."""
    global _trace_lib
    with _trace_lock:
        if _trace_lib is not None:
            return _trace_lib
        so = _so_path("libmia_torch_trace", _TRACE_SRC)
        if not os.path.exists(so) and not _build(_TRACE_SRC, so):
            raise RuntimeError(
                f"the contour tracer ({_TRACE_SRC}) did not build with g++")
        lib = ctypes.CDLL(so)
        lib.mia_trace_run.restype = ctypes.c_void_p
        lib.mia_trace_run.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.mia_trace_fetch.restype = None
        lib.mia_trace_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        _trace_lib = lib
        return lib


def trace_external(stack):
    """Outer borders of each 2-D slice of ``stack`` ((S, H, W) or (H, W),
    any nonzero pixel is foreground), as OpenCV's
    ``findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` gives them: per
    slice a list of (N, 2) int32 (x, y) arrays in OpenCV's list order.
    Returns one such list for a 2-D input, a list of them for 3-D."""
    arr = np.asarray(stack)
    flat = arr[None] if arr.ndim == 2 else arr
    if flat.ndim != 3:
        raise ValueError(f"trace_external: 2-D or 3-D input, got {arr.shape}")
    S, H, W = flat.shape
    if max(H, W) >= 2 ** 30:
        raise ValueError(f"trace_external: slice {H} x {W} is too large")
    u8 = np.ascontiguousarray(flat != 0, dtype=np.uint8)
    lib = get_trace_lib()
    n_contours = ctypes.c_int64()
    n_points = ctypes.c_int64()
    h = lib.mia_trace_run(u8.ctypes.data_as(ctypes.c_void_p), S, H, W,
                          ctypes.byref(n_contours), ctypes.byref(n_points))
    if not h:
        raise MemoryError("trace_external: the tracer ran out of memory")
    per_slice = np.empty(S, np.int64)
    lengths = np.empty(n_contours.value, np.int64)
    xy = np.empty((n_points.value, 2), np.int32)
    lib.mia_trace_fetch(ctypes.c_void_p(h),
                        per_slice.ctypes.data_as(ctypes.c_void_p),
                        lengths.ctypes.data_as(ctypes.c_void_p),
                        xy.ctypes.data_as(ctypes.c_void_p))
    contours = np.split(xy, np.cumsum(lengths)[:-1]) if lengths.size else []
    bounds = np.concatenate([[0], np.cumsum(per_slice)])
    out = [contours[bounds[k]:bounds[k + 1]] for k in range(S)]
    return out[0] if arr.ndim == 2 else out
