// Copied from medicalimageanalysis_tpu/native/dicomscan.cpp.
// libmiadicom — native host-side DICOM core.
//
// The reference gets its native DICOM performance from wrapped C++
// (pydicom + GDCM/pylibjpeg, reference requirements.txt); this is our
// own equivalent: a single-pass element scanner that emits a flat
// (tag, vr, offset, length, depth) table for zero-copy lazy parsing in
// Python, plus pixel decoders (RLE PackBits, JPEG-Lossless process 14)
// that GDCM normally provides.
//
// Build: g++ -O3 -shared -fPIC -o libmiadicom.so dicomscan.cpp

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

struct Entry {
    uint32_t tag;      // (group << 16) | element
    uint16_t vr;       // two ascii chars, little endian ('DA' -> 'D'|'A'<<8)
    uint16_t depth;    // sequence nesting depth; items bump depth
    uint64_t off;      // value offset into the file buffer
    uint64_t len;      // value length in bytes
};

// control pseudo-tags emitted into the table
static const uint32_t TAG_ITEM      = 0xFFFEE000u;
static const uint32_t TAG_ITEM_END  = 0xFFFEE00Du;
static const uint32_t TAG_SEQ_END   = 0xFFFEE0DDu;

struct Cursor {
    const uint8_t* buf;
    uint64_t len;
    uint64_t pos;
    bool ok;
};

static inline uint16_t rd16(Cursor& c, bool little) {
    if (c.pos + 2 > c.len) { c.ok = false; return 0; }
    uint16_t v;
    memcpy(&v, c.buf + c.pos, 2);
    c.pos += 2;
    if (!little) v = (uint16_t)((v >> 8) | (v << 8));
    return v;
}

static inline uint32_t rd32(Cursor& c, bool little) {
    if (c.pos + 4 > c.len) { c.ok = false; return 0; }
    uint32_t v;
    memcpy(&v, c.buf + c.pos, 4);
    c.pos += 4;
    if (!little) v = __builtin_bswap32(v);
    return v;
}

static inline bool is_long_vr(uint16_t vr) {
    switch (vr) {
    case ('O' | ('B' << 8)): case ('O' | ('W' << 8)):
    case ('O' | ('F' << 8)): case ('O' | ('D' << 8)):
    case ('O' | ('L' << 8)): case ('O' | ('V' << 8)):
    case ('S' | ('Q' << 8)): case ('U' | ('C' << 8)):
    case ('U' | ('R' << 8)): case ('U' | ('T' << 8)):
    case ('U' | ('N' << 8)):
        return true;
    default:
        return false;
    }
}

struct Emitter {
    Entry* out;
    int64_t max;
    int64_t n;
    bool overflow;
    void emit(uint32_t tag, uint16_t vr, uint16_t depth, uint64_t off,
              uint64_t len) {
        if (n >= max) { overflow = true; return; }
        out[n].tag = tag; out[n].vr = vr; out[n].depth = depth;
        out[n].off = off; out[n].len = len;
        n++;
    }
};

static void scan_dataset(Cursor& c, Emitter& em, bool explicit_vr,
                         bool little, uint16_t depth, uint64_t end,
                         int stop_before_pixels);

// parse items of a sequence with undefined or defined length
static void scan_sequence(Cursor& c, Emitter& em, bool explicit_vr,
                          bool little, uint16_t depth, uint64_t seq_end) {
    while (c.ok && c.pos + 8 <= (seq_end ? seq_end : c.len)) {
        uint16_t group = rd16(c, little);
        uint16_t elem = rd16(c, little);
        uint32_t tag = ((uint32_t)group << 16) | elem;
        uint32_t ilen = rd32(c, little);
        if (!c.ok) return;
        if (tag == TAG_SEQ_END) {
            em.emit(TAG_SEQ_END, 0, depth, c.pos, 0);
            return;
        }
        if (tag != TAG_ITEM) { c.ok = false; return; }
        em.emit(TAG_ITEM, 0, depth, c.pos, ilen);
        if (ilen == 0xFFFFFFFFu) {
            scan_dataset(c, em, explicit_vr, little,
                         (uint16_t)(depth + 1), 0, 0);
            // item delimiter consumed inside scan_dataset loop break
        } else {
            uint64_t item_end = c.pos + ilen;
            if (item_end > c.len) { c.ok = false; return; }
            scan_dataset(c, em, explicit_vr, little,
                         (uint16_t)(depth + 1), item_end, 0);
            c.pos = item_end;
            em.emit(TAG_ITEM_END, 0, depth, c.pos, 0);
        }
        if (seq_end && c.pos >= seq_end) return;
    }
}

static void scan_fragments(Cursor& c, Emitter& em, bool little,
                           uint16_t depth) {
    while (c.ok && c.pos + 8 <= c.len) {
        uint16_t group = rd16(c, little);
        uint16_t elem = rd16(c, little);
        uint32_t tag = ((uint32_t)group << 16) | elem;
        uint32_t ilen = rd32(c, little);
        if (!c.ok) return;
        if (tag == TAG_SEQ_END) {
            em.emit(TAG_SEQ_END, 0, depth, c.pos, 0);
            return;
        }
        if (tag != TAG_ITEM) { c.ok = false; return; }
        if (c.pos + ilen > c.len) { c.ok = false; return; }
        em.emit(TAG_ITEM, ('F' | ('R' << 8)), depth, c.pos, ilen);
        c.pos += ilen;
    }
}

static void scan_dataset(Cursor& c, Emitter& em, bool explicit_vr,
                         bool little, uint16_t depth, uint64_t end,
                         int stop_before_pixels) {
    uint64_t limit = end ? end : c.len;
    while (c.ok && c.pos + 8 <= limit && !em.overflow) {
        uint64_t start = c.pos;
        uint16_t group = rd16(c, little);
        uint16_t elem = rd16(c, little);
        uint32_t tag = ((uint32_t)group << 16) | elem;

        if (tag == TAG_ITEM_END) {
            rd32(c, little);  // length
            em.emit(TAG_ITEM_END, 0, (uint16_t)(depth - 1), c.pos, 0);
            return;  // end of undefined-length item
        }
        if (tag == TAG_SEQ_END) {
            c.pos = start;
            return;
        }

        uint16_t vr = 0;
        uint64_t vlen;
        if (group == 0xFFFE) {
            vlen = rd32(c, little);
        } else if (explicit_vr) {
            if (c.pos + 2 > c.len) { c.ok = false; return; }
            vr = (uint16_t)(c.buf[c.pos] | (c.buf[c.pos + 1] << 8));
            c.pos += 2;
            if (is_long_vr(vr)) {
                c.pos += 2;
                vlen = rd32(c, little);
            } else {
                vlen = rd16(c, little);
            }
        } else {
            vlen = rd32(c, little);
        }
        if (!c.ok) return;

        if (stop_before_pixels && depth == 0 && tag >= 0x7FE00008u)
            return;

        bool is_sq = (vr == ('S' | ('Q' << 8)));
        bool undef = (vlen == 0xFFFFFFFFu);
        // implicit VR: look for sequences by undefined length or let
        // Python decide from the dictionary — we mark undefined-length
        // values as SQ scans, defined-length unknown-VR values as raw.
        if (!explicit_vr && undef && tag < 0x7FE00000u) is_sq = true;
        if (vr == ('U' | ('N' << 8)) && undef) is_sq = true;

        if (is_sq) {
            em.emit(tag, ('S' | ('Q' << 8)), depth, c.pos,
                    undef ? 0xFFFFFFFFFFFFFFFFull : vlen);
            if (undef) {
                scan_sequence(c, em, explicit_vr, little,
                              (uint16_t)(depth + 1), 0);
            } else {
                uint64_t seq_end = c.pos + vlen;
                if (seq_end > c.len) { c.ok = false; return; }
                scan_sequence(c, em, explicit_vr, little,
                              (uint16_t)(depth + 1), seq_end);
                c.pos = seq_end;
                em.emit(TAG_SEQ_END, 0, (uint16_t)(depth + 1), c.pos, 0);
            }
            continue;
        }

        if (undef) {
            // encapsulated pixel data (or undefined-length OB)
            em.emit(tag, vr, depth, c.pos, 0xFFFFFFFFFFFFFFFFull);
            scan_fragments(c, em, little, (uint16_t)(depth + 1));
            continue;
        }

        if (c.pos + vlen > c.len) { c.ok = false; return; }
        em.emit(tag, vr, depth, c.pos, vlen);
        c.pos += vlen;
    }
}

// Scan a DICOM file buffer into an Entry table.
// Returns: number of entries (>=0); -1 not dicom; -2 parse error;
// -3 table overflow. meta_out[0..2]: transfer syntax code
// (0 implicit LE, 1 explicit LE, 2 explicit BE, 3 deflated,
//  4 encapsulated/other), body start offset, ts string offset (0 if
// none) — ts length in meta_out[3].
int64_t mia_scan(const uint8_t* buf, uint64_t len, int stop_before_pixels,
                 Entry* out, int64_t max_entries, uint64_t* meta_out) {
    Cursor c{buf, len, 0, true};
    Emitter em{out, max_entries, 0, false};

    if (len > 132 && memcmp(buf + 128, "DICM", 4) == 0) {
        c.pos = 132;
        // file meta: explicit LE. First element must be group length.
        uint16_t group = rd16(c, true);
        uint16_t elem = rd16(c, true);
        if (group != 0x0002 || elem != 0x0000) return -2;
        c.pos += 2;  // 'UL'
        uint16_t l = rd16(c, true);
        if (l != 4) return -2;
        uint32_t group_len = rd32(c, true);
        uint64_t meta_end = c.pos + group_len;
        if (meta_end > len) meta_end = len;  // attacker-controlled length
        // scan file meta elements at depth 0 (group 0002)
        uint64_t ts_off = 0, ts_len = 0;
        while (c.ok && c.pos + 8 <= meta_end) {
            uint16_t g = rd16(c, true);
            uint16_t e = rd16(c, true);
            if (c.pos + 2 > c.len) { c.ok = false; break; }
            uint16_t vr = (uint16_t)(c.buf[c.pos] | (c.buf[c.pos+1] << 8));
            c.pos += 2;
            uint64_t vlen;
            if (is_long_vr(vr)) { c.pos += 2; vlen = rd32(c, true); }
            else vlen = rd16(c, true);
            if (!c.ok || c.pos + vlen > c.len) { c.ok = false; break; }
            uint32_t tag = ((uint32_t)g << 16) | e;
            em.emit(tag, vr, 0, c.pos, vlen);
            if (tag == 0x00020010u) { ts_off = c.pos; ts_len = vlen; }
            c.pos += vlen;
        }
        if (!c.ok) return -2;
        c.pos = meta_end;

        int ts_code = 1;  // default explicit LE
        if (ts_len && ts_off + ts_len <= len) {
            const char* ts = (const char*)(buf + ts_off);
            // trim trailing nul/space
            uint64_t tl = ts_len;
            while (tl && (ts[tl-1] == '\0' || ts[tl-1] == ' ')) tl--;
            if (tl == 17 && memcmp(ts, "1.2.840.10008.1.2", 17) == 0)
                ts_code = 0;
            else if (tl == 19 && memcmp(ts, "1.2.840.10008.1.2.1", 19) == 0)
                ts_code = 1;
            else if (tl == 19 && memcmp(ts, "1.2.840.10008.1.2.2", 19) == 0)
                ts_code = 2;
            else if (tl == 22 &&
                     memcmp(ts, "1.2.840.10008.1.2.1.99", 22) == 0)
                ts_code = 3;
            else
                ts_code = 4;  // encapsulated family; still explicit LE
        }
        meta_out[0] = (uint64_t)ts_code;
        meta_out[1] = meta_end;
        meta_out[2] = ts_off;
        meta_out[3] = ts_len;
        if (ts_code == 3) return em.n;  // deflated: Python inflates body

        bool explicit_vr = (ts_code != 0);
        bool little = (ts_code != 2);
        scan_dataset(c, em, explicit_vr, little, 0, 0, stop_before_pixels);
        if (em.overflow) return -3;
        return c.ok ? em.n : -2;
    }

    // raw dataset (no preamble): sniff explicit by VR chars
    if (len < 8) return -1;
    uint16_t g0;
    memcpy(&g0, buf, 2);
    if (!(g0 == 0x0002 || g0 == 0x0008 || g0 == 0x0010 || g0 == 0x0018 ||
          g0 == 0x0020 || g0 == 0x0028))
        return -1;
    char a = (char)buf[4], b = (char)buf[5];
    bool explicit_vr = (a >= 'A' && a <= 'Z' && b >= 'A' && b <= 'Z');
    meta_out[0] = explicit_vr ? 1 : 0;
    meta_out[1] = 0;
    meta_out[2] = 0;
    meta_out[3] = 0;
    scan_dataset(c, em, explicit_vr, true, 0, 0, stop_before_pixels);
    if (em.overflow) return -3;
    return c.ok ? em.n : -2;
}

// ---------------------------------------------------------------------
// Batch entry points: scan / stage many files from a thread pool so the
// Python ingest path pays one GIL release for a whole cohort instead of
// per-file call overhead (replaces the reference's thread-per-file
// fan-out, reference read/dicom.py:202-216).

int64_t mia_scan_batch(const uint8_t** bufs, const uint64_t* lens,
                       int64_t n_files, int stop_before_pixels,
                       Entry* out, int64_t max_per_file,
                       int64_t* counts, uint64_t* metas, int n_threads) {
    std::atomic<int64_t> next(0);
    if (n_threads <= 0) {
        n_threads = (int)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 4;
    }
    if ((int64_t)n_threads > n_files) n_threads = (int)n_files;

    auto work = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_files) return;
            counts[i] = mia_scan(bufs[i], lens[i], stop_before_pixels,
                                 out + i * max_per_file, max_per_file,
                                 metas + 4 * i);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < n_threads; t++) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
    return 0;
}

// Parallel staging: copy n pixel blocks (bufs[i] + offs[i], sizes[i])
// into dst + i * stride — the volume-assembly memcpy fan-out.
int64_t mia_gather_blocks(const uint8_t** bufs, const uint64_t* offs,
                          const uint64_t* sizes, int64_t n,
                          uint8_t* dst, uint64_t stride, int n_threads) {
    std::atomic<int64_t> next(0);
    if (n_threads <= 0) {
        n_threads = (int)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 4;
    }
    if ((int64_t)n_threads > n) n_threads = (int)n;
    std::atomic<int64_t> bad(0);

    auto work = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) return;
            uint64_t sz = sizes[i];
            if (sz > stride) { bad.fetch_add(1); continue; }
            memcpy(dst + i * stride, bufs[i] + offs[i], sz);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < n_threads; t++) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
    return bad.load();
}

// ---------------------------------------------------------------------
// RLE Lossless (PS3.5 annex G): decode one frame into interleaved
// native-endian samples.
int mia_rle_decode(const uint8_t* frag, uint64_t len, uint8_t* out,
                   int64_t rows, int64_t cols, int samples,
                   int bytes_per_sample) {
    if (len < 64) return -1;
    uint32_t nseg;
    memcpy(&nseg, frag, 4);
    if (nseg > 15) return -2;
    uint32_t offsets[16];
    for (uint32_t i = 0; i < nseg; i++)
        memcpy(&offsets[i], frag + 4 + 4 * i, 4);

    int64_t frame_px = rows * cols;
    int total_segs = samples * bytes_per_sample;
    if ((int)nseg != total_segs) return -3;

    for (int s = 0; s < total_segs; s++) {
        uint64_t start = offsets[s];
        uint64_t end = (s + 1 < (int)nseg) ? offsets[s + 1] : len;
        if (end > len || start > end) return -4;
        int samp = s / bytes_per_sample;
        int byte_idx = s % bytes_per_sample;
        // DICOM segments are MSB-first; native little-endian position:
        int lepos = bytes_per_sample - 1 - byte_idx;
        uint8_t* dst_base = out + (uint64_t)samp * bytes_per_sample
                            + lepos;  // interleaved samples
        int64_t stride = (int64_t)samples * bytes_per_sample;

        const uint8_t* src = frag + start;
        uint64_t n = end - start;
        uint64_t i = 0;
        int64_t o = 0;
        while (i < n && o < frame_px) {
            int8_t header = (int8_t)src[i++];
            if (header >= 0) {
                int count = header + 1;
                if (i + count > n) count = (int)(n - i);
                for (int k = 0; k < count && o < frame_px; k++)
                    dst_base[(o++) * stride] = src[i + k];
                i += count;
            } else if (header != -128) {
                int count = 1 - header;
                if (i >= n) break;
                uint8_t v = src[i++];
                for (int k = 0; k < count && o < frame_px; k++)
                    dst_base[(o++) * stride] = v;
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------
// JPEG Lossless (process 14, ITU T.81 SOF3), all predictors, single or
// multi component, Huffman entropy coding. This is the decode GDCM
// provides that cv2 cannot.

// 64-bit refill cache (T.81 FF00 byte-stuffing aware): receive() is
// one shift/mask and Huffman decode peeks 16 bits at once — the
// per-bit walk was the p14 decode hot spot. Valid bits are the LOW
// ncache bits of `cache`; starvation (marker / end of data) clears
// `ok` exactly like the per-bit reader it replaces.
struct BitReader {
    const uint8_t* buf;
    uint64_t len;
    uint64_t pos;
    uint64_t cache;
    int ncache;
    bool ok;

    inline void fill() {
        while (ncache <= 56) {
            if (pos >= len) return;
            uint8_t b = buf[pos];
            if (b == 0xFF) {
                if (pos + 1 < len && buf[pos + 1] == 0x00) pos += 2;
                else return;   // marker or dangling FF: end of data
            } else {
                pos++;
            }
            cache = (cache << 8) | (uint64_t)b;
            ncache += 8;
        }
    }

    inline int next_bit() {
        if (ncache == 0) {
            fill();
            if (ncache == 0) { ok = false; return 0; }
        }
        ncache--;
        return (int)((cache >> ncache) & 1);
    }

    inline int receive(int n) {          // n <= 16 at every call site
        if (ncache < n) {
            fill();
            if (ncache < n) { ok = false; return 0; }
        }
        ncache -= n;
        return (int)((cache >> ncache) & ((1u << n) - 1));
    }

    // next 16 bits without consuming, zero-padded near end of data
    inline uint32_t peek16() {
        if (ncache < 16) fill();
        if (ncache >= 16)
            return (uint32_t)((cache >> (ncache - 16)) & 0xFFFF);
        uint64_t w = ncache ? (cache & ((~0ULL) >> (64 - ncache))) : 0;
        return (uint32_t)(w << (16 - ncache));
    }

    inline bool consume(int n) {         // only after a peek16 match
        if (ncache < n) {
            fill();
            if (ncache < n) { ok = false; return false; }
        }
        ncache -= n;
        return true;
    }
};

static inline int extend(int v, int t) {
    return (t && v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

struct Huff {
    // code lengths 1..16
    int mincode[17], maxcode[18], valptr[17];
    uint8_t vals[256];
    // 8-bit-prefix fast table: codes of length <= 8 decode in one
    // lookup; lut_len 0 falls through to the canonical walk
    uint8_t lut_len[256];
    uint8_t lut_val[256];
    bool valid;

    void build(const uint8_t* bits, const uint8_t* values, int nvals) {
        int code = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            valptr[l] = k;
            mincode[l] = code;
            code += bits[l - 1];
            k += bits[l - 1];
            maxcode[l] = code - 1;
            code <<= 1;
            if (bits[l - 1] == 0) maxcode[l] = -1;
        }
        maxcode[17] = 0x7FFFFFFF;
        for (int i = 0; i < nvals && i < 256; i++) vals[i] = values[i];
        for (int i = 0; i < 256; i++) lut_len[i] = 0;
        int code2 = 0, k2 = 0;
        for (int l = 1; l <= 8; l++) {
            for (int c = 0; c < bits[l - 1]; c++, code2++, k2++) {
                int prefix = code2 << (8 - l);
                if (k2 >= 256 || prefix > 255)  // hostile DHT overflow
                    continue;
                for (int f = 0; f < (1 << (8 - l)); f++) {
                    lut_len[prefix | f] = (uint8_t)l;
                    lut_val[prefix | f] = vals[k2];
                }
            }
            code2 <<= 1;
        }
        valid = true;
    }

// shared decode body for both readers (templates cannot have C
// linkage, so the two overloads expand the same macro)
#define MIA_HUFF_DECODE_BODY                                          \
    {                                                                 \
        const uint32_t pk = br.peek16();                              \
        const int hi = (int)(pk >> 8);                                \
        const int l8 = lut_len[hi];                                   \
        if (l8) {                                                     \
            if (!br.consume(l8)) return -1;                           \
            return lut_val[hi];                                       \
        }                                                             \
        for (int l = 9; l <= 16; l++) {                               \
            int code = (int)(pk >> (16 - l));                         \
            if (maxcode[l] >= 0 && code <= maxcode[l]) {              \
                if (!br.consume(l)) return -1;                        \
                int idx = valptr[l] + code - mincode[l];              \
                if (idx < 0 || idx >= 256) return -1; /* bad DHT */   \
                return vals[idx];                                     \
            }                                                         \
        }                                                             \
        if (br.ncache < 16) br.ok = false; /* starved, not invalid */ \
        return -1;                                                    \
    }

    int decode(BitReader& br) const MIA_HUFF_DECODE_BODY
    int decode(struct DctBitReader& br) const;
};

// Decode SOF3 lossless JPEG. out: int32 buffer (w*h*ncomp, interleaved).
// Returns 0 on success; fills w/h/ncomp/precision.
int mia_jpegls14_decode(const uint8_t* buf, uint64_t len, int32_t* out,
                        int64_t out_capacity, int* w_out, int* h_out,
                        int* ncomp_out, int* prec_out) {
    uint64_t p = 0;
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return -1;  // SOI
    p = 2;

    int precision = 0, H = 0, W = 0, ncomp = 0;
    int comp_id[4] = {0}, comp_tbl[4] = {0};
    Huff tables[4];
    for (int i = 0; i < 4; i++) tables[i].valid = false;
    int predictor = 1, pt = 0;
    int scan_comp[4] = {0};
    int ns = 0;
    uint64_t scan_start = 0;

    while (p + 4 <= len) {
        if (buf[p] != 0xFF) { p++; continue; }
        uint8_t marker = buf[p + 1];
        p += 2;
        if (marker == 0xFF) { p -= 1; continue; }  // fill byte (B.1.1.2)
        if (marker == 0xD8 || marker == 0x01 ||
            (marker >= 0xD0 && marker <= 0xD7))
            continue;
        if (p + 2 > len) return -2;
        int seg_len = (buf[p] << 8) | buf[p + 1];
        uint64_t seg_end = p + seg_len;
        if (seg_end > len || seg_len < 2) return -2;  // hostile length

        if (marker == 0xC3) {  // SOF3 lossless
            if (p + 8 > seg_end) return -2;
            precision = buf[p + 2];
            H = (buf[p + 3] << 8) | buf[p + 4];
            W = (buf[p + 5] << 8) | buf[p + 6];
            ncomp = buf[p + 7];
            if (ncomp > 4) return -3;
            if (p + 8 + 3 * (uint64_t)ncomp > seg_end) return -2;
            for (int i = 0; i < ncomp; i++)
                comp_id[i] = buf[p + 8 + 3 * i];
        } else if (marker == 0xC4) {  // DHT
            uint64_t q = p + 2;
            while (q < seg_end) {
                if (q + 17 > seg_end) return -2;
                int tc_th = buf[q++];
                int th = tc_th & 0x0F;
                uint8_t bits[16];
                int nvals = 0;
                for (int i = 0; i < 16; i++) {
                    bits[i] = buf[q + i];
                    nvals += bits[i];
                }
                q += 16;
                if (q + (uint64_t)nvals > seg_end) return -2;
                if (th < 4) tables[th].build(bits, buf + q, nvals);
                q += nvals;
            }
        } else if (marker == 0xDA) {  // SOS
            if (p + 3 > seg_end) return -2;
            ns = buf[p + 2];
            // scan_comp is int[4]: an unvalidated ns (up to 255) was a
            // stack write overflow on crafted input (ADVICE.md round 1)
            if (ns < 1 || ns > 4) return -3;
            if (p + 6 + 2 * (uint64_t)ns > seg_end) return -2;
            for (int i = 0; i < ns; i++) {
                int cid = buf[p + 3 + 2 * i];
                int tbl = (buf[p + 4 + 2 * i] >> 4) & 0x0F;
                if (tbl > 3) return -3;  // tables[] is Huff[4]
                for (int k = 0; k < ncomp; k++)
                    if (comp_id[k] == cid) { scan_comp[i] = k;
                                             comp_tbl[k] = tbl; }
            }
            predictor = buf[p + 3 + 2 * ns];       // Ss
            pt = buf[p + 5 + 2 * ns] & 0x0F;       // Al = point transform
            scan_start = seg_end;
            break;
        } else if (marker == 0xD9) {
            return -4;  // EOI before SOS
        }
        p = seg_end;
    }

    if (!W || !H || !ncomp || !scan_start || scan_start >= len) return -5;
    if ((int64_t)W * H * ncomp > out_capacity) return -6;
    // precision-pt-1 shift below is UB outside [2,16] / pt >= precision
    if (precision < 2 || precision > 16 || pt >= precision) return -5;

    *w_out = W; *h_out = H; *ncomp_out = ncomp; *prec_out = precision;

    BitReader br{buf + scan_start, len - scan_start, 0, 0, 0, true};
    int defaultval = 1 << (precision - pt - 1);

    // interleaved decode, row-major, component-minor (ns components)
    for (int64_t y = 0; y < H && br.ok; y++) {
        for (int64_t x = 0; x < W && br.ok; x++) {
            for (int s = 0; s < ns; s++) {
                int comp = scan_comp[s];
                const Huff& hf = tables[comp_tbl[comp]];
                if (!hf.valid) return -7;
                int t = hf.decode(br);
                if (t < 0) return -8;
                int diff = 0;
                if (t > 0 && t < 16)
                    diff = extend(br.receive(t), t);
                else if (t == 16)
                    diff = 32768;

                int32_t* row = out + (y * W + x) * ncomp + comp;
                int64_t ra = (x > 0) ? row[-ncomp] : 0;
                int64_t rb = (y > 0) ? *(row - (int64_t)W * ncomp) : 0;
                int64_t rc = (x > 0 && y > 0)
                    ? *(row - (int64_t)W * ncomp - ncomp) : 0;
                int64_t pred;
                if (y == 0 && x == 0) pred = defaultval;
                else if (y == 0) pred = ra;
                else if (x == 0) pred = rb;
                else {
                    switch (predictor) {
                    case 1: pred = ra; break;
                    case 2: pred = rb; break;
                    case 3: pred = rc; break;
                    case 4: pred = ra + rb - rc; break;
                    case 5: pred = ra + ((rb - rc) >> 1); break;
                    case 6: pred = rb + ((ra - rc) >> 1); break;
                    case 7: pred = (ra + rb) >> 1; break;
                    default: pred = ra; break;
                    }
                }
                *row = (int32_t)(((pred + diff)
                                  & ((1 << precision) - 1)) << pt);
            }
        }
    }
    return br.ok ? 0 : -9;
}

// ---------------------------------------------------------------------
// JPEG sequential DCT, baseline (SOF0, 8-bit) and Extended (SOF1,
// 12-bit) — DICOM transfer syntaxes .50 / .51 (processes 1, 2/4).
// The reference decodes these through GDCM/pylibjpeg
// (reference read/dicom.py:52, requirements.txt); cv2 covers 8-bit
// baseline but NOT 12-bit extended (legacy CR / mammo archives), which
// made such files raise in round 2 (VERDICT r2 missing #1).
//
// Supported: grayscale (any precision 2..16 the marker allows; DICOM
// uses 8 and 12), and 3-component 1x1-sampled scans (RAW component
// values — no color-space conversion; the caller interprets them per
// PhotometricInterpretation, pydicom parity); interleaved or
// one-component-per-scan; restart intervals. Hostile input returns
// negative codes, never reads out of bounds.

static const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// 64-bit refill cache like BitReader, plus pending-marker tracking for
// restart intervals. Cached-but-unused bits before a restart are the
// pad bits the marker boundary discards; the forward marker scan in
// restart() is exact because FF + non-00 can never occur as stuffed
// entropy data.
struct DctBitReader {
    const uint8_t* buf;
    uint64_t len;
    uint64_t pos;
    uint64_t cache;
    int ncache;
    bool ok;
    int marker;  // pending RST/EOI marker seen in the stream, else -1

    inline void fill() {
        while (ncache <= 56) {
            if (marker >= 0 || pos >= len) return;
            uint8_t b = buf[pos];
            if (b == 0xFF) {
                if (pos + 1 < len && buf[pos + 1] == 0x00) {
                    pos += 2;
                } else if (pos + 1 < len) {
                    marker = buf[pos + 1];  // RSTn / EOI / next SOS
                    pos += 2;
                    return;
                } else {
                    pos = len;              // dangling FF at end
                    return;
                }
            } else {
                pos++;
            }
            cache = (cache << 8) | (uint64_t)b;
            ncache += 8;
        }
    }

    inline int next_bit() {
        if (ncache == 0) {
            fill();
            if (ncache == 0) { ok = false; return 0; }
        }
        ncache--;
        return (int)((cache >> ncache) & 1);
    }

    inline int receive(int n) {          // n <= 16 at every call site
        if (ncache < n) {
            fill();
            if (ncache < n) { ok = false; return 0; }
        }
        ncache -= n;
        return (int)((cache >> ncache) & ((1u << n) - 1));
    }

    inline uint32_t peek16() {
        if (ncache < 16) fill();
        if (ncache >= 16)
            return (uint32_t)((cache >> (ncache - 16)) & 0xFFFF);
        uint64_t w = ncache ? (cache & ((~0ULL) >> (64 - ncache))) : 0;
        return (uint32_t)(w << (16 - ncache));
    }

    inline bool consume(int n) {
        if (ncache < n) {
            fill();
            if (ncache < n) { ok = false; return false; }
        }
        ncache -= n;
        return true;
    }

    // align to the next marker boundary and consume an expected RSTn
    bool restart() {
        ncache = 0;
        cache = 0;
        if (marker < 0) {
            // scan forward for the marker
            while (pos + 1 < len) {
                if (buf[pos] == 0xFF && buf[pos + 1] != 0x00) {
                    marker = buf[pos + 1];
                    pos += 2;
                    break;
                }
                pos++;
            }
        }
        if (marker >= 0xD0 && marker <= 0xD7) {
            marker = -1;
            ok = true;
            return true;
        }
        return false;
    }
};

inline int Huff::decode(DctBitReader& br) const MIA_HUFF_DECODE_BODY


// separable float IDCT (DCT-III) with the 1/2 C(u) normalization
struct CosTab {
    float c[8][8];
    CosTab() {
        for (int x = 0; x < 8; x++)
            for (int u = 0; u < 8; u++)
                c[x][u] = (float)(std::cos((2 * x + 1) * u * M_PI / 16.0)
                                  * (u == 0 ? 0.3535533906 : 0.5));
    }
};

static void idct8x8(const int32_t* in, const uint16_t* qt, float* out) {
    static const CosTab kCos;   // C++11 thread-safe static init
    const auto& cosT = kCos.c;
    float tmp[64];
    for (int y = 0; y < 8; y++) {          // rows: 1-D IDCT over u
        for (int x = 0; x < 8; x++) {
            float s = 0.f;
            // int64 product: a 16-bit-precision stream with large DQT
            // entries and accumulated DC prediction can exceed
            // INT32_MAX (signed-overflow UB otherwise)
            for (int u = 0; u < 8; u++)
                s += cosT[x][u] * (float)((int64_t)in[y * 8 + u]
                                          * (int64_t)qt[y * 8 + u]);
            tmp[y * 8 + x] = s;
        }
    }
    for (int x = 0; x < 8; x++) {          // cols: 1-D IDCT over v
        for (int y = 0; y < 8; y++) {
            float s = 0.f;
            for (int v = 0; v < 8; v++)
                s += cosT[y][v] * tmp[v * 8 + x];
            out[y * 8 + x] = s;
        }
    }
}

int mia_jpegdct_decode(const uint8_t* buf, uint64_t len, int32_t* out,
                       int64_t out_capacity, int* w_out, int* h_out,
                       int* ncomp_out, int* prec_out) {
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return -1;  // SOI
    uint64_t p = 2;

    int precision = 0, H = 0, W = 0, ncomp = 0;
    int comp_id[4] = {0}, comp_h[4] = {0}, comp_v[4] = {0};
    int comp_q[4] = {0}, comp_dc[4] = {0}, comp_ac[4] = {0};
    uint16_t qtab[4][64];
    bool q_ok[4] = {false, false, false, false};
    Huff dc_tab[4], ac_tab[4];
    for (int i = 0; i < 4; i++) {
        dc_tab[i].valid = false;
        ac_tab[i].valid = false;
    }
    int restart_interval = 0;
    bool sof_seen = false, decoded_any = false;
    // per-component decoded planes live in out (interleaved); coverage
    // tracked so multi-scan files must touch every component
    bool comp_done[4] = {false, false, false, false};

    while (p + 4 <= len) {
        if (buf[p] != 0xFF) { p++; continue; }
        uint8_t marker = buf[p + 1];
        p += 2;
        if (marker == 0xFF) { p -= 1; continue; }  // fill byte (B.1.1.2)
        if (marker == 0xD8 || marker == 0x01 ||
            (marker >= 0xD0 && marker <= 0xD7))
            continue;
        if (marker == 0xD9) break;  // EOI
        if (p + 2 > len) return -2;
        int seg_len = (buf[p] << 8) | buf[p + 1];
        uint64_t seg_end = p + seg_len;
        if (seg_end > len || seg_len < 2) return -2;

        if (marker == 0xC0 || marker == 0xC1) {  // SOF0 / SOF1
            if (p + 8 > seg_end) return -2;
            precision = buf[p + 2];
            H = (buf[p + 3] << 8) | buf[p + 4];
            W = (buf[p + 5] << 8) | buf[p + 6];
            ncomp = buf[p + 7];
            if (ncomp < 1 || ncomp > 4) return -3;
            if (p + 8 + 3 * (uint64_t)ncomp > seg_end) return -2;
            for (int i = 0; i < ncomp; i++) {
                comp_id[i] = buf[p + 8 + 3 * i];
                comp_h[i] = (buf[p + 9 + 3 * i] >> 4) & 0x0F;
                comp_v[i] = buf[p + 9 + 3 * i] & 0x0F;
                comp_q[i] = buf[p + 10 + 3 * i];
                if (comp_q[i] > 3) return -3;
                // only 1x1 sampling supported (medical grayscale /
                // RGB; subsampled color goes to cv2)
                if (comp_h[i] != 1 || comp_v[i] != 1) return -10;
            }
            if (!W || !H) return -5;
            if (precision < 2 || precision > 16) return -5;
            if ((int64_t)W * H * ncomp > out_capacity) return -6;
            sof_seen = true;
        } else if (marker == 0xC2) {
            return -11;  // progressive: not a DICOM .50/.51 process
        } else if (marker == 0xC4) {  // DHT
            uint64_t q = p + 2;
            while (q < seg_end) {
                if (q + 17 > seg_end) return -2;
                int tc_th = buf[q++];
                int tc = (tc_th >> 4) & 0x0F;
                int th = tc_th & 0x0F;
                uint8_t bits[16];
                int nvals = 0;
                for (int i = 0; i < 16; i++) {
                    bits[i] = buf[q + i];
                    nvals += bits[i];
                }
                q += 16;
                if (q + (uint64_t)nvals > seg_end) return -2;
                if (th < 4) {
                    if (tc == 0) dc_tab[th].build(bits, buf + q, nvals);
                    else if (tc == 1) ac_tab[th].build(bits, buf + q,
                                                       nvals);
                }
                q += nvals;
            }
        } else if (marker == 0xDB) {  // DQT
            uint64_t q = p + 2;
            while (q < seg_end) {
                int pq_tq = buf[q++];
                int pq = (pq_tq >> 4) & 0x0F;
                int tq = pq_tq & 0x0F;
                if (tq > 3) return -3;
                int esz = pq ? 2 : 1;
                if (q + 64 * (uint64_t)esz > seg_end) return -2;
                for (int i = 0; i < 64; i++) {
                    qtab[tq][kZigzag[i]] =
                        pq ? (uint16_t)((buf[q] << 8) | buf[q + 1])
                           : (uint16_t)buf[q];
                    q += esz;
                }
                q_ok[tq] = true;
            }
        } else if (marker == 0xDD) {  // DRI
            if (p + 4 > seg_end) return -2;
            restart_interval = (buf[p + 2] << 8) | buf[p + 3];
        } else if (marker == 0xDA) {  // SOS
            if (!sof_seen) return -5;
            if (p + 3 > seg_end) return -2;
            int ns = buf[p + 2];
            if (ns < 1 || ns > 4) return -3;
            if (p + 6 + 2 * (uint64_t)ns > seg_end) return -2;
            int scan_comp[4] = {0};
            for (int i = 0; i < ns; i++) {
                int cid = buf[p + 3 + 2 * i];
                int tdc = (buf[p + 4 + 2 * i] >> 4) & 0x0F;
                int tac = buf[p + 4 + 2 * i] & 0x0F;
                if (tdc > 3 || tac > 3) return -3;
                int found = -1;
                for (int k = 0; k < ncomp; k++)
                    if (comp_id[k] == cid) found = k;
                if (found < 0) return -3;
                scan_comp[i] = found;
                comp_dc[found] = tdc;
                comp_ac[found] = tac;
            }
            // entropy-coded data follows
            DctBitReader br{buf + seg_end, len - seg_end, 0, 0, 0,
                            true, -1};
            int mcu_w = ((W + 7) / 8);
            int mcu_h = ((H + 7) / 8);
            int64_t n_mcu = (int64_t)mcu_w * mcu_h;
            int dc_pred[4] = {0, 0, 0, 0};
            int32_t coef[64];
            float px[64];
            int level = 1 << (precision - 1);
            int maxval = (1 << precision) - 1;
            int64_t since_restart = 0;

            for (int64_t m = 0; m < n_mcu; m++) {
                if (restart_interval && since_restart == restart_interval) {
                    if (!br.restart()) return -12;
                    for (int i = 0; i < 4; i++) dc_pred[i] = 0;
                    since_restart = 0;
                }
                int64_t by = (m / mcu_w) * 8;
                int64_t bx = (m % mcu_w) * 8;
                for (int s = 0; s < ns; s++) {
                    int comp = scan_comp[s];
                    const Huff& hdc = dc_tab[comp_dc[comp]];
                    const Huff& hac = ac_tab[comp_ac[comp]];
                    if (!hdc.valid || !hac.valid) return -7;
                    if (!q_ok[comp_q[comp]]) return -7;
                    for (int i = 0; i < 64; i++) coef[i] = 0;
                    int t = hdc.decode(br);
                    if (t < 0 || t > 16) return -8;
                    int diff = t ? extend(br.receive(t), t) : 0;
                    dc_pred[comp] += diff;
                    coef[0] = dc_pred[comp];
                    for (int k = 1; k < 64;) {
                        int rs = hac.decode(br);
                        if (rs < 0) return -8;
                        int r = (rs >> 4) & 0x0F;
                        int sz = rs & 0x0F;
                        if (sz == 0) {
                            if (r == 15) { k += 16; continue; }
                            break;  // EOB
                        }
                        k += r;
                        if (k > 63) return -8;
                        coef[kZigzag[k]] = extend(br.receive(sz), sz);
                        k++;
                    }
                    if (!br.ok) return -9;
                    idct8x8(coef, qtab[comp_q[comp]], px);
                    for (int yy = 0; yy < 8; yy++) {
                        int64_t gy = by + yy;
                        if (gy >= H) break;
                        for (int xx = 0; xx < 8; xx++) {
                            int64_t gx = bx + xx;
                            if (gx >= W) break;
                            float v = px[yy * 8 + xx] + (float)level;
                            int32_t iv = (int32_t)(v + (v >= 0 ? 0.5f
                                                               : -0.5f));
                            if (iv < 0) iv = 0;
                            if (iv > maxval) iv = maxval;
                            out[(gy * W + gx) * ncomp + comp] = iv;
                        }
                    }
                }
                since_restart++;
            }
            for (int s = 0; s < ns; s++) comp_done[scan_comp[s]] = true;
            decoded_any = true;
            // continue the marker scan AFTER the entropy data; when
            // the cached reader recorded a pending marker, fill()
            // advanced br.pos TWO past its 0xFF (review finding: the
            // old per-bit reader stopped ON the marker byte, and the
            // stale p -= 1 skipped the next SOS of one-component-per-
            // scan files)
            p = seg_end + br.pos;
            if (br.marker >= 0 && p >= seg_end + 2) p -= 2;
            continue;
        }
        p = seg_end;
    }

    if (!decoded_any) return -5;
    for (int i = 0; i < ncomp; i++)
        if (!comp_done[i]) return -13;
    *w_out = W;
    *h_out = H;
    *ncomp_out = ncomp;
    *prec_out = precision;
    return 0;
}

// ---------------------------------------------------------------------
// JPEG-LS (ITU-T T.87 / ISO 14495-1) decoder — DICOM transfer syntaxes
// 1.2.840.10008.1.2.4.80 (lossless) and .81 (near-lossless). The
// reference decodes these through GDCM/CharLS (requirements.txt:~1-86,
// gdcm import at reference read/dicom.py:52); cv2 ships no JPEG-LS
// codec. Scope: 1..4 components in all three T.87 scan layouts —
// plane-separated (ILV 0, one scan per component — the DICOM
// CT/MR/PT case), line-interleaved (ILV 1) and sample-interleaved
// (ILV 2) color streams (the CharLS-encoded RGB case) — with LSE
// preset-parameter support, NEAR >= 0, 2..16-bit precision. Mapping
// tables, restart intervals, and subsampled multi-component frames
// return typed errors (negative rc -> ValueError in Python).
//
// LOCO-I essentials implemented exactly per the T.87 pseudo-code:
// gradient quantization with T1/T2/T3, 365 regular contexts + 2 run
// interruption contexts, median-edge prediction with bias correction
// C[Q], limited-length Golomb coding LG(k, LIMIT), run mode with the
// 32-entry J[] run-length ladder, k==0 mapping inversion when
// 2B[Q] <= -N[Q], RESET-halving of (A, B, N).

// Bit reader with JPEG-LS marker-stuffing semantics: a byte following
// a 0xFF carries only 7 data bits (its MSB is a stuffed 0); 0xFF
// followed by a byte with the MSB set is a marker = end of data.
// 64-bit refill cache: receive() grabs n bits in one shift/mask and
// unary() counts zero runs with clz instead of per-bit calls (the
// per-bit loop was the decode hot spot at ~6 ms per 256^2 frame).
// Valid bits are the LOW ncache bits of `cache`, next bit to read is
// bit (ncache-1); starvation (end of data / marker) clears `ok`,
// exactly like the per-bit reader it replaces.
struct LsBitReader {
    const uint8_t* buf;
    uint64_t len;
    uint64_t pos;
    uint64_t cache;
    int ncache;
    bool prev_ff;
    bool ok;

    inline void fill() {
        while (ncache <= 56) {
            if (pos >= len) return;
            uint8_t b = buf[pos];
            if (prev_ff && (b & 0x80)) return;   // marker: end of data
            pos++;
            int nb = prev_ff ? 7 : 8;            // stuffed MSB is 0
            prev_ff = (b == 0xFF);
            cache = (cache << nb) | (uint64_t)b;
            ncache += nb;
        }
    }

    inline int next_bit() {
        if (ncache == 0) {
            fill();
            if (ncache == 0) { ok = false; return 0; }
        }
        ncache--;
        return (int)((cache >> ncache) & 1);
    }

    inline int receive(int n) {          // n <= 24 at every call site
        if (ncache < n) {
            fill();
            if (ncache < n) { ok = false; return 0; }
        }
        ncache -= n;
        return (int)((cache >> ncache) & ((1u << n) - 1));
    }

    // zero-run length capped at `limit`, consuming the terminating 1;
    // -1 = cap exceeded or data starved (ok cleared on starvation)
    inline int unary(int limit) {
        int z = 0;
        for (;;) {
            if (ncache == 0) {
                fill();
                if (ncache == 0) { ok = false; return -1; }
            }
            uint64_t window = ncache >= 64
                ? cache : (cache & ((~0ULL) >> (64 - ncache)));
            if (window == 0) {
                z += ncache;
                ncache = 0;
                if (z > limit) return -1;
                continue;
            }
            int top = 63 - __builtin_clzll(window);
            z += ncache - 1 - top;
            ncache = top;                // zeros + the 1 bit consumed
            if (z > limit) return -1;
            return z;
        }
    }
};

static const int kLsJ[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                             2, 3, 3, 3, 3, 4, 4, 5, 5, 6, 6,
                             7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

static inline int ls_ceil_log2(int v) {
    int k = 0;
    while ((1 << k) < v) k++;
    return k;
}

// limited-length Golomb decode LG(k, limit): z zeros + '1' + k LSBs,
// or the (limit - qbpp - 1)-zeros escape + qbpp bits (value - 1)
static int ls_decode_limited(LsBitReader& br, int k, int limit,
                             int qbpp) {
    int z = br.unary(limit);   // hostile: no valid code longer than limit
    if (z < 0 || !br.ok) return -1;
    if (z < limit - qbpp - 1) {
        int v = br.receive(k);
        if (!br.ok) return -1;
        return (z << k) | v;
    }
    int v = br.receive(qbpp);
    if (!br.ok) return -1;
    return v + 1;
}

// first marker position inside entropy-coded JPEG-LS data: FF followed
// by an MSB-set byte can never occur as data (stuffing guarantees a
// 7-bit byte after every data FF), so this is exact
static uint64_t ls_find_marker(const uint8_t* s, uint64_t n) {
    for (uint64_t i = 0; i + 1 < n; i++)
        if (s[i] == 0xFF && (s[i + 1] & 0x80)) return i;
    return n;
}

// Shared per-scan decoder state: context counters + derived coding
// parameters + the bit reader. One instance per SOS scan (T.87
// restarts the modeller per scan); all three scan layouts — single-
// component (ILV 0), line-interleaved (ILV 1), sample-interleaved
// (ILV 2) — decode through the same sample helpers below so the
// LOCO-I arithmetic exists exactly once. Multi-component scans share
// ALL statistics (A/B/C/N/Nn) per T.87 8.3; only RUNindex is
// per-component in ILV 1 and shared in ILV 2 (CharLS rgRUNindex).
struct LsState {
    // context state (int64 so hostile streams cannot overflow updates)
    int64_t A[367], B[365], N[367];
    int C[365];
    int64_t Nn[2];
    int maxval, near_, RESET;
    int qbpp, limit;
    int64_t full;
    std::vector<int8_t> qlutv;
    const int8_t* qlut;   // centered: qlut[d], d in [-maxval, maxval]
    LsBitReader br;

    void init(const uint8_t* scan, uint64_t scan_len, int mv, int nr,
              int T1, int T2, int T3, int RST) {
        maxval = mv;
        near_ = nr;
        RESET = RST;
        const int range = (mv + 2 * nr) / (2 * nr + 1) + 1;
        qbpp = ls_ceil_log2(range);
        const int bpp_ = ls_ceil_log2(mv + 1) < 2
                             ? 2 : ls_ceil_log2(mv + 1);
        limit = 2 * (bpp_ + (bpp_ > 8 ? bpp_ : 8));
        full = (int64_t)range * (2 * nr + 1);
        int64_t ainit = (range + 32) / 64;
        if (ainit < 2) ainit = 2;
        for (int q = 0; q < 367; q++) { A[q] = ainit; N[q] = 1; }
        for (int q = 0; q < 365; q++) { B[q] = 0; C[q] = 0; }
        Nn[0] = Nn[1] = 0;
        // gradient-quantizer LUT over the full difference range
        // [-maxval, maxval] (<= 131071 entries at 16-bit): three
        // lookups per sample instead of up to 24 compares
        qlutv.assign((size_t)(2 * mv + 1), 0);
        for (int d = -mv; d <= mv; d++) {
            int q;
            if (d <= -T3) q = -4;
            else if (d <= -T2) q = -3;
            else if (d <= -T1) q = -2;
            else if (d < -nr) q = -1;
            else if (d <= nr) q = 0;
            else if (d < T1) q = 1;
            else if (d < T2) q = 2;
            else if (d < T3) q = 3;
            else q = 4;
            qlutv[(size_t)(d + mv)] = (int8_t)q;
        }
        qlut = qlutv.data() + mv;
        br = LsBitReader{scan, scan_len, 0, 0, 0, false, true};
    }
};

// one regular-mode sample (T.87 A.3-A.7 with the shared qlut):
// returns Rx >= 0, or -1 on hostile/starved input
static inline int ls_regular_sample(LsState& S, int Ra, int Rb, int Rc,
                                    int D1, int D2, int D3) {
    int q1 = S.qlut[D1], q2 = S.qlut[D2], q3 = S.qlut[D3];
    int sign = 1;
    if (q1 < 0 || (q1 == 0 && (q2 < 0 || (q2 == 0 && q3 < 0)))) {
        sign = -1;
        q1 = -q1; q2 = -q2; q3 = -q3;
    }
    const int Q = q1 * 81 + q2 * 9 + q3;   // 1..364

    // median-edge predictor + bias correction
    const int mn = Ra < Rb ? Ra : Rb, mx = Ra < Rb ? Rb : Ra;
    int Px;
    if (Rc >= mx) Px = mn;
    else if (Rc <= mn) Px = mx;
    else Px = Ra + Rb - Rc;
    Px += sign * S.C[Q];
    if (Px < 0) Px = 0;
    if (Px > S.maxval) Px = S.maxval;

    int k = 0;
    while ((S.N[Q] << k) < S.A[Q]) {
        k++;
        if (k > 24) return -1;   // hostile state blow-up
    }
    const int merr = ls_decode_limited(S.br, k, S.limit, S.qbpp);
    if (merr < 0) return -1;

    int64_t errval;
    if (S.near_ == 0 && k == 0 && 2 * S.B[Q] <= -S.N[Q]) {
        // inverted mapping: m = 2e+1 (e >= 0), m = -2(e+1) (e < 0)
        errval = (merr & 1) ? (merr - 1) / 2
                            : -(int64_t)merr / 2 - 1;
    } else {
        errval = (merr & 1) ? -((int64_t)merr + 1) / 2
                            : (int64_t)merr / 2;
    }

    S.B[Q] += errval * (2 * S.near_ + 1);
    S.A[Q] += errval < 0 ? -errval : errval;
    if (S.N[Q] == S.RESET) {
        S.A[Q] >>= 1;
        S.B[Q] = S.B[Q] >= 0 ? S.B[Q] >> 1 : -((1 - S.B[Q]) >> 1);
        S.N[Q] >>= 1;
    }
    S.N[Q]++;
    if (S.B[Q] <= -S.N[Q]) {
        if (S.C[Q] > -128) S.C[Q]--;
        S.B[Q] += S.N[Q];
        if (S.B[Q] <= -S.N[Q]) S.B[Q] = -S.N[Q] + 1;
    } else if (S.B[Q] > 0) {
        if (S.C[Q] < 127) S.C[Q]++;
        S.B[Q] -= S.N[Q];
        if (S.B[Q] > 0) S.B[Q] = 0;
    }

    int64_t Rx = Px + sign * errval * (2 * S.near_ + 1);
    if (Rx < -S.near_) Rx += S.full;
    else if (Rx > S.maxval + S.near_) Rx -= S.full;
    if (Rx < 0) Rx = 0;
    if (Rx > S.maxval) Rx = S.maxval;
    return (int)Rx;
}

// one run-interruption sample (contexts 365/366, T.87 A.7.2):
// force_ri0 selects the sample-interleaved rule — context 365
// regardless of |Ra - Rb| (T.87 8.3.3, CharLS DecodeRIPixel<Triplet>)
static inline int ls_run_interrupt_sample(LsState& S, int Ra, int Rb,
                                          int runindex,
                                          bool force_ri0) {
    const int ad = Ra > Rb ? Ra - Rb : Rb - Ra;
    const int ritype = (!force_ri0 && ad <= S.near_) ? 1 : 0;
    const int Px = ritype ? Ra : Rb;
    const int sign = (!ritype && Ra > Rb) ? -1 : 1;
    const int Q = 365 + ritype;
    const int64_t temp = ritype ? S.A[366] + (S.N[366] >> 1) : S.A[365];
    int k = 0;
    while ((S.N[Q] << k) < temp) {
        k++;
        if (k > 24) return -1;   // hostile state blow-up
    }
    // glimit > qbpp always holds here: limit >= 2*(bpp+8), J <= 15,
    // qbpp <= bpp for any NEAR >= 0
    const int glimit = S.limit - kLsJ[runindex] - 1;
    int emerr = ls_decode_limited(S.br, k, glimit, S.qbpp);
    if (emerr < 0) return -1;
    const int tmpv = emerr + ritype;   // == 2|e| - map
    const int map = tmpv & 1;
    const int64_t eabs = ((int64_t)tmpv + map) / 2;
    const bool cond = (k != 0) || (2 * S.Nn[ritype] >= S.N[Q]);
    int64_t errval = (map == (int)cond) ? -eabs : eabs;

    if (errval < 0) S.Nn[ritype]++;
    S.A[Q] += (emerr + 1 - ritype) >> 1;
    if (S.N[Q] == S.RESET) {
        S.A[Q] >>= 1;
        S.N[Q] >>= 1;
        S.Nn[ritype] >>= 1;
    }
    S.N[Q]++;

    int64_t Rx = Px + sign * errval * (2 * S.near_ + 1);
    if (Rx < -S.near_) Rx += S.full;
    else if (Rx > S.maxval + S.near_) Rx -= S.full;
    if (Rx < 0) Rx = 0;
    if (Rx > S.maxval) Rx = S.maxval;
    return (int)Rx;
}

}  // extern "C" — a template cannot carry C linkage; the ladder is
   // internal (static) and only the mia_* exports below need it

// run-length ladder (T.87 A.7.1): decodes run bits, invoking
// fill(x, n) for each n-sample stretch. interrupted=false means the
// run reached end of line (no 0 bit); true means a 0-bit occurred and
// the caller decodes the interruption sample(s). -8 on hostile input.
template <class FillFn>
static inline int ls_run_ladder(LsState& S, int& runindex, int64_t& x,
                                int64_t W, bool& interrupted,
                                FillFn fill) {
    interrupted = false;
    for (;;) {
        int bit = S.br.next_bit();
        if (!S.br.ok) return -8;
        if (bit == 1) {
            int64_t cnt = (int64_t)1 << kLsJ[runindex];
            int64_t rem = W - x;
            int64_t f = cnt < rem ? cnt : rem;
            fill(x, f);
            x += f;
            if (cnt <= rem && runindex < 31) runindex++;
            if (x >= W) return 0;    // end of line, no 0 bit
        } else {
            int jj = kLsJ[runindex];
            int cnt = jj ? S.br.receive(jj) : 0;
            if (!S.br.ok) return -8;
            if (cnt > W - x - 1) return -8;   // hostile count
            fill(x, cnt);
            x += cnt;
            interrupted = true;
            return 0;
        }
    }
}

extern "C" {

// one line of one component (ILV 0 scans, and per-component lines of
// ILV 1 scans). prev/cur carry one-sample margins: index x+1 =
// column x; prev[0] retains what cur[0] held one line earlier, which
// is exactly the T.87 Rc rule for column 0.
static int ls_decode_line(LsState& S, int& runindex, int32_t* prev,
                          int32_t* cur, int32_t* orow, int stride,
                          int W) {
    prev[W + 1] = prev[W];   // Rd at the last column = Rb
    cur[0] = prev[1];        // Ra at column 0 = Rb
    int64_t x = 0;
    while (x < W) {
        const int Ra = cur[x], Rb = prev[x + 1], Rc = prev[x],
                  Rd = prev[x + 2];
        const int D1 = Rd - Rb, D2 = Rb - Rc, D3 = Rc - Ra;
        const int aD1 = D1 < 0 ? -D1 : D1, aD2 = D2 < 0 ? -D2 : D2,
                  aD3 = D3 < 0 ? -D3 : D3;

        if (aD1 <= S.near_ && aD2 <= S.near_ && aD3 <= S.near_) {
            // ---------------- run mode ----------------
            bool interrupted;
            int rc = ls_run_ladder(
                S, runindex, x, W, interrupted,
                [&](int64_t xs, int64_t n) {
                    for (int64_t i = 0; i < n; i++) {
                        cur[xs + 1 + i] = Ra;
                        orow[(xs + i) * stride] = Ra;
                    }
                });
            if (rc) return rc;
            if (!interrupted) continue;   // line ended inside run

            int Rx = ls_run_interrupt_sample(S, cur[x], prev[x + 1],
                                             runindex, false);
            if (Rx < 0) return -8;
            cur[x + 1] = Rx;
            orow[x * stride] = Rx;
            x++;
            if (runindex > 0) runindex--;
            continue;
        }

        // ---------------- regular mode ----------------
        int Rx = ls_regular_sample(S, Ra, Rb, Rc, D1, D2, D3);
        if (Rx < 0) return -8;
        cur[x + 1] = Rx;
        orow[x * stride] = Rx;
        x++;
    }
    return 0;
}

// one JPEG-LS scan (single component, ILV 0) into a strided output
// plane: out[(y*W + x) * stride]
static int ls_decode_scan(const uint8_t* scan, uint64_t scan_len,
                          int32_t* out, int stride, int W, int H,
                          int maxval, int near, int T1, int T2, int T3,
                          int RESET) {
    LsState S;
    S.init(scan, scan_len, maxval, near, T1, T2, T3, RESET);
    std::vector<int32_t> prevv((size_t)W + 2, 0), curv((size_t)W + 2, 0);
    int32_t* prev = prevv.data();
    int32_t* cur = curv.data();
    int runindex = 0;
    for (int64_t y = 0; y < H; y++) {
        int rc = ls_decode_line(S, runindex, prev, cur,
                                out + y * W * stride, stride, W);
        if (rc) return rc;
        std::swap(prev, cur);
    }
    return 0;
}

// line-interleaved scan (ILV 1): each image line carries one full
// line of every component in scan order. Statistics shared, RUNindex
// per component (T.87 8.3.2). cmap[c] = frame-component offset of
// scan component c in the interleaved (H, W, ncomp) output.
static int ls_decode_scan_ilv1(const uint8_t* scan, uint64_t scan_len,
                               int32_t* out, int ncomp, const int* cmap,
                               int W, int H, int maxval, int near,
                               int T1, int T2, int T3, int RESET) {
    LsState S;
    S.init(scan, scan_len, maxval, near, T1, T2, T3, RESET);
    std::vector<std::vector<int32_t>> prevs(ncomp), curs(ncomp);
    for (int c = 0; c < ncomp; c++) {
        prevs[c].assign((size_t)W + 2, 0);
        curs[c].assign((size_t)W + 2, 0);
    }
    int runindex[4] = {0, 0, 0, 0};
    for (int64_t y = 0; y < H; y++) {
        for (int c = 0; c < ncomp; c++) {
            int rc = ls_decode_line(S, runindex[c], prevs[c].data(),
                                    curs[c].data(),
                                    out + y * W * ncomp + cmap[c],
                                    ncomp, W);
            if (rc) return rc;
            prevs[c].swap(curs[c]);
        }
    }
    return 0;
}

// sample-interleaved scan (ILV 2): one sample of each component per
// position. Run mode requires the run condition in ALL components,
// codes the run length ONCE, and codes the interruption samples per
// component with RItype = 0 and a single RUNindex decrement
// (T.87 8.3.3).
static int ls_decode_scan_ilv2(const uint8_t* scan, uint64_t scan_len,
                               int32_t* out, int ncomp, const int* cmap,
                               int W, int H, int maxval, int near,
                               int T1, int T2, int T3, int RESET) {
    LsState S;
    S.init(scan, scan_len, maxval, near, T1, T2, T3, RESET);
    std::vector<std::vector<int32_t>> prevs(ncomp), curs(ncomp);
    for (int c = 0; c < ncomp; c++) {
        prevs[c].assign((size_t)W + 2, 0);
        curs[c].assign((size_t)W + 2, 0);
    }
    int runindex = 0;
    for (int64_t y = 0; y < H; y++) {
        for (int c = 0; c < ncomp; c++) {
            int32_t* prev = prevs[c].data();
            int32_t* cur = curs[c].data();
            prev[W + 1] = prev[W];
            cur[0] = prev[1];
        }
        int32_t* orow = out + y * W * ncomp;
        int64_t x = 0;
        while (x < W) {
            bool runmode = true;
            int Dv[4][3];
            for (int c = 0; c < ncomp; c++) {
                const int32_t* prev = prevs[c].data();
                const int32_t* cur = curs[c].data();
                const int Ra = cur[x], Rb = prev[x + 1],
                          Rc = prev[x], Rd = prev[x + 2];
                const int D1 = Rd - Rb, D2 = Rb - Rc, D3 = Rc - Ra;
                Dv[c][0] = D1; Dv[c][1] = D2; Dv[c][2] = D3;
                const int aD1 = D1 < 0 ? -D1 : D1,
                          aD2 = D2 < 0 ? -D2 : D2,
                          aD3 = D3 < 0 ? -D3 : D3;
                if (aD1 > S.near_ || aD2 > S.near_ || aD3 > S.near_)
                    runmode = false;
            }

            if (runmode) {
                int32_t Rav[4];
                for (int c = 0; c < ncomp; c++) Rav[c] = curs[c][x];
                bool interrupted;
                int rc = ls_run_ladder(
                    S, runindex, x, W, interrupted,
                    [&](int64_t xs, int64_t n) {
                        for (int c = 0; c < ncomp; c++) {
                            int32_t* cur = curs[c].data();
                            const int32_t v = Rav[c];
                            for (int64_t i = 0; i < n; i++) {
                                cur[xs + 1 + i] = v;
                                orow[(xs + i) * ncomp + cmap[c]] = v;
                            }
                        }
                    });
                if (rc) return rc;
                if (!interrupted) continue;   // line ended inside run

                for (int c = 0; c < ncomp; c++) {
                    int Rx = ls_run_interrupt_sample(
                        S, curs[c][x], prevs[c][x + 1], runindex,
                        true);
                    if (Rx < 0) return -8;
                    curs[c][x + 1] = Rx;
                    orow[x * ncomp + cmap[c]] = Rx;
                }
                x++;
                if (runindex > 0) runindex--;
                continue;
            }

            for (int c = 0; c < ncomp; c++) {
                const int32_t* prev = prevs[c].data();
                int32_t* cur = curs[c].data();
                int Rx = ls_regular_sample(S, cur[x], prev[x + 1],
                                           prev[x], Dv[c][0],
                                           Dv[c][1], Dv[c][2]);
                if (Rx < 0) return -8;
                cur[x + 1] = Rx;
                orow[x * ncomp + cmap[c]] = Rx;
            }
            x++;
        }
        for (int c = 0; c < ncomp; c++) prevs[c].swap(curs[c]);
    }
    return 0;
}

int mia_jpegls_decode(const uint8_t* buf, uint64_t len, int32_t* out,
                      int64_t out_capacity, int* w_out, int* h_out,
                      int* ncomp_out, int* prec_out) {
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return -1;  // SOI
    uint64_t p = 2;

    int precision = 0, H = 0, W = 0, ncomp = 0;
    int comp_id[4] = {0};
    bool comp_done[4] = {false, false, false, false};
    int n_done = 0;
    int maxval = 0, T1 = 0, T2 = 0, T3 = 0, RESET = 0;

    while (p + 4 <= len) {
        if (buf[p] != 0xFF) { p++; continue; }
        uint8_t marker = buf[p + 1];
        p += 2;
        if (marker == 0xFF) { p -= 1; continue; }  // fill byte (B.1.1.2)
        if (marker == 0xD8 || marker == 0x01 ||
            (marker >= 0xD0 && marker <= 0xD7))
            continue;
        if (marker == 0xD9)              // EOI
            return (ncomp && n_done == ncomp) ? 0 : -4;
        if (p + 2 > len) return -2;
        int seg_len = (buf[p] << 8) | buf[p + 1];
        uint64_t seg_end = p + seg_len;
        if (seg_end > len || seg_len < 2) return -2;

        if (marker == 0xF7) {            // SOF55 (JPEG-LS frame)
            if (p + 8 > seg_end) return -2;
            precision = buf[p + 2];
            H = (buf[p + 3] << 8) | buf[p + 4];
            W = (buf[p + 5] << 8) | buf[p + 6];
            ncomp = buf[p + 7];
            if (ncomp < 1 || ncomp > 4) return -3;
            if (p + 8 + 3 * (uint64_t)ncomp > seg_end) return -2;
            for (int i = 0; i < ncomp; i++) {
                comp_id[i] = buf[p + 8 + 3 * i];
                // multi-component decode assumes co-sited 1x1
                // sampling (the DICOM case); subsampled frames would
                // silently mis-decode
                if (ncomp > 1 && buf[p + 9 + 3 * i] != 0x11) return -3;
            }
        } else if (marker == 0xF8) {     // LSE preset parameters
            if (p + 3 > seg_end) return -2;
            int id = buf[p + 2];
            if (id == 1) {
                if (p + 13 > seg_end) return -2;
                maxval = (buf[p + 3] << 8) | buf[p + 4];
                T1 = (buf[p + 5] << 8) | buf[p + 6];
                T2 = (buf[p + 7] << 8) | buf[p + 8];
                T3 = (buf[p + 9] << 8) | buf[p + 10];
                RESET = (buf[p + 11] << 8) | buf[p + 12];
            } else {
                return -3;  // mapping tables / extensions unsupported
            }
        } else if (marker == 0xDD) {     // DRI
            if (p + 4 > seg_end) return -2;
            int dri = (buf[p + 2] << 8) | buf[p + 3];
            if (dri != 0) return -3;     // restart intervals unsupported
        } else if (marker == 0xDA) {     // SOS: decode one scan
            if (!W || !H || !ncomp) return -5;
            if (precision < 2 || precision > 16) return -5;
            if (p + 3 > seg_end) return -2;
            int ns = buf[p + 2];
            // one component per scan (ILV 0) or ALL components in one
            // scan (ILV 1 line / ILV 2 sample interleaved, T.87 8.3)
            if (ns != 1 && ns != ncomp) return -3;
            if (p + 6 + 2 * (uint64_t)ns > seg_end) return -2;
            int cmap[4] = {0, 0, 0, 0};
            for (int s = 0; s < ns; s++) {
                int cs = buf[p + 3 + 2 * s];
                int tm = buf[p + 4 + 2 * s];   // mapping table selector
                if (tm != 0) return -3;
                int ci = -1;
                for (int i = 0; i < ncomp; i++)
                    if (comp_id[i] == cs) ci = i;
                if (ci < 0 || comp_done[ci]) return -5;
                for (int s2 = 0; s2 < s; s2++)
                    if (cmap[s2] == ci) return -5;   // duplicate Cs
                cmap[s] = ci;
            }
            const uint64_t q = p + 3 + 2 * (uint64_t)ns;
            int near = buf[q];
            int ilv = buf[q + 1];
            if (ns == 1 ? (ilv != 0) : (ilv != 1 && ilv != 2))
                return -3;
            // Ah/Al byte: a nonzero point transform (Al) shifts every
            // sample; decoding it as 0 would be silently wrong
            if ((buf[q + 2] & 0x0F) != 0) return -3;

            int mv = maxval ? maxval : (1 << precision) - 1;
            if (mv < 1 || mv > (1 << precision) - 1 || mv > 65535)
                return -5;
            if (near < 0 || near > (mv < 255 ? mv / 2 : 255)) return -5;
            if ((int64_t)W * H * ncomp > out_capacity) return -6;

            // per-scan thresholds: defaults per T.87 C.2.4.1.1.1 with
            // CLAMP_1 semantics (CharLS clamp_value — out-of-range on
            // EITHER side collapses to the LOWER bound: NEAR+1 for
            // T1, then T1 for T2, T2 for T3); an LSE value of 0
            // selects the default, explicit values must already obey
            // the ordering contract (silently clamping mis-decodes)
            int t1 = T1, t2 = T2, t3 = T3, rst = RESET;
            {
                int dT1, dT2, dT3;
                if (mv >= 128) {
                    int factor = ((mv < 4095 ? mv : 4095) + 128) / 256;
                    dT1 = factor * (3 - 2) + 2 + 3 * near;
                    dT2 = factor * (7 - 3) + 3 + 5 * near;
                    dT3 = factor * (21 - 4) + 4 + 7 * near;
                } else {
                    int factor = 256 / (mv + 1);
                    dT1 = 3 / factor + 3 * near;
                    if (dT1 < 2) dT1 = 2;
                    dT2 = 7 / factor + 5 * near;
                    if (dT2 < 3) dT2 = 3;
                    dT3 = 21 / factor + 7 * near;
                    if (dT3 < 4) dT3 = 4;
                }
                if (t1 == 0) t1 = (dT1 > mv || dT1 < near + 1)
                                      ? near + 1 : dT1;
                if (t2 == 0) t2 = (dT2 > mv || dT2 < t1) ? t1 : dT2;
                if (t3 == 0) t3 = (dT3 > mv || dT3 < t2) ? t2 : dT3;
                if (rst == 0) rst = 64;
                if (!(near < t1 && t1 <= t2 && t2 <= t3 && t3 <= mv))
                    return -5;
                if (rst < 3) return -5;
            }

            if (seg_end >= len) return -5;
            int rc;
            if (ns == 1) {
                rc = ls_decode_scan(buf + seg_end, len - seg_end,
                                    out + cmap[0], ncomp, W, H, mv,
                                    near, t1, t2, t3, rst);
            } else if (ilv == 1) {
                rc = ls_decode_scan_ilv1(buf + seg_end, len - seg_end,
                                         out, ncomp, cmap, W, H, mv,
                                         near, t1, t2, t3, rst);
            } else {
                rc = ls_decode_scan_ilv2(buf + seg_end, len - seg_end,
                                         out, ncomp, cmap, W, H, mv,
                                         near, t1, t2, t3, rst);
            }
            if (rc != 0) return rc;
            for (int s = 0; s < ns; s++) comp_done[cmap[s]] = true;
            n_done += ns;
            *w_out = W; *h_out = H; *ncomp_out = ncomp;
            *prec_out = precision;
            if (n_done == ncomp) return 0;
            // skip this scan's entropy data (FF + MSB-set byte cannot
            // occur as stuffed data, so the next marker is exact)
            p = seg_end + ls_find_marker(buf + seg_end, len - seg_end);
            continue;
        }
        p = seg_end;
    }
    return (ncomp && n_done == ncomp) ? 0 : -5;
}

// ---------------------------------------------------------------------
// JPEG-LS encoder (T.87 LOCO-I), mirror of the validated Python
// encoder dicom/jpegls_t87.py so the two are bit-identical — the
// Python one stays the conformance reference, this one makes
// compressed DICOM export production-speed (the Python scan loop is
// ~0.5 s per 256^2 slice). Default thresholds only (no LSE), NEAR>=0,
// 1..4 plane-separated components (ILV 0).

struct LsBitWriter {
    std::vector<uint8_t> out;
    uint32_t cur = 0;
    int n = 0;
    int room = 8;   // 7 after an emitted 0xFF (stuffed MSB)

    inline void put(uint32_t v, int nb) {
        for (int i = nb - 1; i >= 0; i--) {
            cur = (cur << 1) | ((v >> i) & 1u);
            if (++n == room) {
                out.push_back((uint8_t)cur);
                room = (cur == 0xFF) ? 7 : 8;
                cur = 0;
                n = 0;
            }
        }
    }

    inline void zeros(int count) {
        for (int i = 0; i < count; i++) put(0, 1);
    }

    void flush() {
        if (n) {
            cur <<= (room - n);
            out.push_back((uint8_t)cur);
            cur = 0;
            n = 0;
            room = 8;
        }
    }
};

static void ls_put_limited(LsBitWriter& bw, int64_t val, int k,
                           int limit, int qbpp) {
    int64_t hi = val >> k;
    if (hi < limit - qbpp - 1) {
        bw.zeros((int)hi);
        bw.put(1, 1);
        if (k) bw.put((uint32_t)(val & ((1 << k) - 1)), k);
    } else {
        bw.zeros(limit - qbpp - 1);
        bw.put(1, 1);
        bw.put((uint32_t)(val - 1), qbpp);
    }
}

// one single-component scan (fresh modeller state per T.87)
static void ls_encode_scan(const int32_t* img, int stride, int W,
                           int H, int maxval, int near, int T1, int T2,
                           int T3, int RESET, LsBitWriter& bw) {
    const int range = (maxval + 2 * near) / (2 * near + 1) + 1;
    const int qbpp = ls_ceil_log2(range);
    const int bpp_ = ls_ceil_log2(maxval + 1) < 2
                         ? 2 : ls_ceil_log2(maxval + 1);
    const int limit = 2 * (bpp_ + (bpp_ > 8 ? bpp_ : 8));
    const int64_t full = (int64_t)range * (2 * near + 1);
    const int half_rng = (range + 1) / 2;
    const int twon1 = 2 * near + 1;

    int64_t A[367], B[365], N[367];
    int C[365];
    int64_t Nn[2] = {0, 0};
    {
        int64_t ainit = (range + 32) / 64;
        if (ainit < 2) ainit = 2;
        for (int q = 0; q < 367; q++) { A[q] = ainit; N[q] = 1; }
        for (int q = 0; q < 365; q++) { B[q] = 0; C[q] = 0; }
    }
    int runindex = 0;

    std::vector<int8_t> qlutv((size_t)(2 * maxval + 1));
    for (int d = -maxval; d <= maxval; d++) {
        int q;
        if (d <= -T3) q = -4;
        else if (d <= -T2) q = -3;
        else if (d <= -T1) q = -2;
        else if (d < -near) q = -1;
        else if (d <= near) q = 0;
        else if (d < T1) q = 1;
        else if (d < T2) q = 2;
        else if (d < T3) q = 3;
        else q = 4;
        qlutv[(size_t)(d + maxval)] = (int8_t)q;
    }
    const int8_t* qlut = qlutv.data() + maxval;

    std::vector<int32_t> prevv((size_t)W + 2, 0), curv((size_t)W + 2, 0);
    int32_t* prev = prevv.data();
    int32_t* cur = curv.data();

    for (int64_t y = 0; y < H; y++) {
        const int32_t* row = img + y * W * stride;
        prev[W + 1] = prev[W];
        cur[0] = prev[1];
        int64_t x = 0;
        while (x < W) {
            const int Ra = cur[x], Rb = prev[x + 1], Rc = prev[x],
                      Rd = prev[x + 2];
            const int D1 = Rd - Rb, D2 = Rb - Rc, D3 = Rc - Ra;
            const int aD1 = D1 < 0 ? -D1 : D1, aD2 = D2 < 0 ? -D2 : D2,
                      aD3 = D3 < 0 ? -D3 : D3;

            if (aD1 <= near && aD2 <= near && aD3 <= near) {
                // ---------------- run mode ----------------
                int64_t runcnt = 0;
                while (x + runcnt < W) {
                    int diff = (int)row[(x + runcnt) * stride] - Ra;
                    if (diff < 0) diff = -diff;
                    if (diff > near) break;
                    runcnt++;
                }
                for (int64_t i = 0; i < runcnt; i++)
                    cur[x + 1 + i] = Ra;
                int64_t end = x + runcnt;
                while (runcnt >= ((int64_t)1 << kLsJ[runindex])) {
                    bw.put(1, 1);
                    runcnt -= (int64_t)1 << kLsJ[runindex];
                    if (runindex < 31) runindex++;
                }
                if (end >= W) {           // run to end of line
                    if (runcnt > 0) bw.put(1, 1);
                    x = end;
                    continue;
                }
                bw.put(0, 1);
                if (kLsJ[runindex])
                    bw.put((uint32_t)runcnt, kLsJ[runindex]);
                x = end;

                // ------- run interruption sample (ctx 365/366)
                const int Ix = (int)row[x * stride];
                const int Ra2 = cur[x], Rb2 = prev[x + 1];
                const int ad = Ra2 > Rb2 ? Ra2 - Rb2 : Rb2 - Ra2;
                const int ritype = ad <= near ? 1 : 0;
                const int Px = ritype ? Ra2 : Rb2;
                const int sign = (!ritype && Ra2 > Rb2) ? -1 : 1;
                int64_t e = (int64_t)(Ix - Px) * sign;
                if (near)
                    e = e > 0 ? (near + e) / twon1
                              : -((near - e) / twon1);
                if (e < 0) e += range;
                if (e >= half_rng) e -= range;
                int64_t Rx = Px + sign * e * twon1;
                if (Rx < -near) Rx += full;
                else if (Rx > maxval + near) Rx -= full;
                if (Rx < 0) Rx = 0;
                if (Rx > maxval) Rx = maxval;
                cur[x + 1] = (int32_t)Rx;
                const int Q = 365 + ritype;
                const int64_t temp =
                    ritype ? A[366] + (N[366] >> 1) : A[365];
                int k = 0;
                while ((N[Q] << k) < temp) k++;
                int emap;
                if (k == 0 && e > 0 && 2 * Nn[ritype] < N[Q]) emap = 1;
                else if (e < 0 && 2 * Nn[ritype] >= N[Q]) emap = 1;
                else if (e < 0 && k != 0) emap = 1;
                else emap = 0;
                const int64_t emerr =
                    2 * (e < 0 ? -e : e) - ritype - emap;
                ls_put_limited(bw, emerr, k,
                               limit - kLsJ[runindex] - 1, qbpp);
                if (e < 0) Nn[ritype]++;
                A[Q] += (emerr + 1 - ritype) >> 1;
                if (N[Q] == RESET) {
                    A[Q] >>= 1;
                    N[Q] >>= 1;
                    Nn[ritype] >>= 1;
                }
                N[Q]++;
                if (runindex > 0) runindex--;
                x++;
                continue;
            }

            // ---------------- regular mode ----------------
            int q1 = qlut[D1], q2 = qlut[D2], q3 = qlut[D3];
            int sign = 1;
            if (q1 < 0 || (q1 == 0 && (q2 < 0 || (q2 == 0 && q3 < 0)))) {
                sign = -1;
                q1 = -q1; q2 = -q2; q3 = -q3;
            }
            const int Q = q1 * 81 + q2 * 9 + q3;

            const int mn = Ra < Rb ? Ra : Rb, mx = Ra < Rb ? Rb : Ra;
            int Px;
            if (Rc >= mx) Px = mn;
            else if (Rc <= mn) Px = mx;
            else Px = Ra + Rb - Rc;
            Px += sign * C[Q];
            if (Px < 0) Px = 0;
            if (Px > maxval) Px = maxval;

            const int Ix = (int)row[x * stride];
            int64_t e = (int64_t)(Ix - Px) * sign;
            if (near)
                e = e > 0 ? (near + e) / twon1 : -((near - e) / twon1);
            if (e < 0) e += range;
            if (e >= half_rng) e -= range;
            int64_t Rx = Px + sign * e * twon1;
            if (Rx < -near) Rx += full;
            else if (Rx > maxval + near) Rx -= full;
            if (Rx < 0) Rx = 0;
            if (Rx > maxval) Rx = maxval;
            cur[x + 1] = (int32_t)Rx;

            int k = 0;
            while ((N[Q] << k) < A[Q]) k++;
            int64_t merr;
            if (near == 0 && k == 0 && 2 * B[Q] <= -N[Q])
                merr = e >= 0 ? 2 * e + 1 : -2 * (e + 1);
            else
                merr = e >= 0 ? 2 * e : -2 * e - 1;
            ls_put_limited(bw, merr, k, limit, qbpp);

            B[Q] += e * twon1;
            A[Q] += e < 0 ? -e : e;
            if (N[Q] == RESET) {
                A[Q] >>= 1;
                B[Q] = B[Q] >= 0 ? B[Q] >> 1 : -((1 - B[Q]) >> 1);
                N[Q] >>= 1;
            }
            N[Q]++;
            if (B[Q] <= -N[Q]) {
                if (C[Q] > -128) C[Q]--;
                B[Q] += N[Q];
                if (B[Q] <= -N[Q]) B[Q] = -N[Q] + 1;
            } else if (B[Q] > 0) {
                if (C[Q] < 127) C[Q]++;
                B[Q] -= N[Q];
                if (B[Q] > 0) B[Q] = 0;
            }
            x++;
        }
        std::swap(prev, cur);
    }
}

// img: (H, W, ncomp) interleaved int32, values in [0, 2^precision).
// Writes a full codestream (SOI..EOI); returns byte count or negative.
int64_t mia_jpegls_encode(const int32_t* img, int W, int H, int ncomp,
                          int precision, int near, uint8_t* out,
                          int64_t out_capacity) {
    if (W < 1 || W > 65535 || H < 1 || H > 65535) return -1;
    if (ncomp < 1 || ncomp > 4) return -1;
    if (precision < 2 || precision > 16) return -1;
    const int maxval = (1 << precision) - 1;
    if (near < 0 || near > (maxval < 255 ? maxval / 2 : 255)) return -1;
    for (int64_t i = 0; i < (int64_t)W * H * ncomp; i++)
        if (img[i] < 0 || img[i] > maxval) return -2;

    // defaults with CLAMP_1 (identical to the decoder / Python)
    int t1, t2, t3;
    {
        int dT1, dT2, dT3;
        if (maxval >= 128) {
            int factor = ((maxval < 4095 ? maxval : 4095) + 128) / 256;
            dT1 = factor * (3 - 2) + 2 + 3 * near;
            dT2 = factor * (7 - 3) + 3 + 5 * near;
            dT3 = factor * (21 - 4) + 4 + 7 * near;
        } else {
            int factor = 256 / (maxval + 1);
            dT1 = 3 / factor + 3 * near;
            if (dT1 < 2) dT1 = 2;
            dT2 = 7 / factor + 5 * near;
            if (dT2 < 3) dT2 = 3;
            dT3 = 21 / factor + 7 * near;
            if (dT3 < 4) dT3 = 4;
        }
        t1 = (dT1 > maxval || dT1 < near + 1) ? near + 1 : dT1;
        t2 = (dT2 > maxval || dT2 < t1) ? t1 : dT2;
        t3 = (dT3 > maxval || dT3 < t2) ? t2 : dT3;
    }

    LsBitWriter bw;
    bw.out.reserve((size_t)W * H * 2 + 64);
    bw.out.push_back(0xFF); bw.out.push_back(0xD8);        // SOI
    // SOF55
    const int sof_len = 8 + 3 * ncomp;
    bw.out.push_back(0xFF); bw.out.push_back(0xF7);
    bw.out.push_back((uint8_t)(sof_len >> 8));
    bw.out.push_back((uint8_t)sof_len);
    bw.out.push_back((uint8_t)precision);
    bw.out.push_back((uint8_t)(H >> 8)); bw.out.push_back((uint8_t)H);
    bw.out.push_back((uint8_t)(W >> 8)); bw.out.push_back((uint8_t)W);
    bw.out.push_back((uint8_t)ncomp);
    for (int c = 0; c < ncomp; c++) {
        bw.out.push_back((uint8_t)(c + 1));
        bw.out.push_back(0x11);
        bw.out.push_back(0);
    }
    for (int c = 0; c < ncomp; c++) {
        // SOS (Cs = c+1, Tm 0, NEAR, ILV 0, Al 0)
        bw.out.push_back(0xFF); bw.out.push_back(0xDA);
        bw.out.push_back(0); bw.out.push_back(8);
        bw.out.push_back(1);
        bw.out.push_back((uint8_t)(c + 1));
        bw.out.push_back(0);
        bw.out.push_back((uint8_t)near);
        bw.out.push_back(0);
        bw.out.push_back(0);
        ls_encode_scan(img + c, ncomp, W, H, maxval, near, t1, t2, t3,
                       64, bw);
        bw.flush();
    }
    bw.out.push_back(0xFF); bw.out.push_back(0xD9);        // EOI
    if ((int64_t)bw.out.size() > out_capacity) return -3;
    memcpy(out, bw.out.data(), bw.out.size());
    return (int64_t)bw.out.size();
}

// ---------------------------------------------------------------------
// 12-bit pixel packing for host->device staging (ops/bitpack.py): 8
// int16 values (offset by lo, range-checked by the caller) -> 3 uint32
// words. Threaded; the numpy chain costs ~0.24 s on a bench cohort,
// most of it temporaries.

int mia_pack12(const int16_t* in, uint64_t n_groups, int32_t lo,
               uint32_t* out, int n_threads) {
    if (n_threads <= 0) {
        unsigned hc = std::thread::hardware_concurrency();
        n_threads = hc ? (int)hc : 1;
    }
    if (n_threads > 16) n_threads = 16;
    auto work = [&](uint64_t g0, uint64_t g1) {
        for (uint64_t g = g0; g < g1; g++) {
            const int16_t* p = in + g * 8;
            uint32_t v[8];
            for (int i = 0; i < 8; i++)
                v[i] = (uint32_t)(int32_t)(p[i] - lo) & 0xFFFu;
            uint32_t* w = out + g * 3;
            w[0] = v[0] | (v[1] << 12) | ((v[2] & 0xFFu) << 24);
            w[1] = (v[2] >> 8) | (v[3] << 4) | (v[4] << 16)
                 | ((v[5] & 0xFu) << 28);
            w[2] = (v[5] >> 4) | (v[6] << 8) | (v[7] << 20);
        }
    };
    if (n_threads == 1 || n_groups < 4096) {
        work(0, n_groups);
        return 0;
    }
    std::vector<std::thread> pool;
    uint64_t chunk = (n_groups + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        uint64_t g0 = (uint64_t)t * chunk;
        uint64_t g1 = g0 + chunk < n_groups ? g0 + chunk : n_groups;
        if (g0 >= g1) break;
        pool.emplace_back(work, g0, g1);
    }
    for (auto& th : pool) th.join();
    return 0;
}

// ---------------------------------------------------------------------
// Marching tetrahedra on a 0/1 mask — fused native twin of
// ops/marching_cubes._binary_mc_host (itself bit-parity with the device
// kernel). The numpy path's best case is ~0.29 s at organ scale and
// its many large temporaries (pattern planes, (M,3,3) int64 key math,
// factorize weld) make it the bench row most exposed to CPU steal;
// this does pattern+emit+key-pack in one streaming pass and welds with
// a z-bucketed sort, reproducing the exact (ascending packed-key
// uniques, emit-order faces) contract so the two paths stay
// bit-identical. Tables are PASSED IN from Python (generated from the
// device kernel by _binary_tables) — no table logic is duplicated here.

struct MiaMcState {
    std::vector<float> pts;
    std::vector<int32_t> faces;
};

void* mia_mc_run(const uint8_t* vol, int64_t nz, int64_t ny, int64_t nx,
                 const int16_t* flat_tab, const int64_t* starts,
                 const int64_t* ntris_tab, int pad, int n_threads,
                 int64_t* n_points, int64_t* n_faces) {
    *n_points = 0;
    *n_faces = 0;
    if (nz < 1 || ny < 1 || nx < 1) return new MiaMcState();
    if (!pad && (nz < 2 || ny < 2 || nx < 2)) return new MiaMcState();
    if (n_threads <= 0) {
        unsigned hc = std::thread::hardware_concurrency();
        n_threads = hc ? (int)hc : 1;
    }
    if (n_threads > 16) n_threads = 16;

    // 1. nonzero bounding box (numpy: argwhere of per-axis any)
    int64_t zmin = nz, zmax = -1, ymin = ny, ymax = -1,
            xmin = nx, xmax = -1;
    {
        std::vector<int64_t> part((size_t)n_threads * 6);
        auto work = [&](int t, int64_t lo, int64_t hi) {
            int64_t* b = part.data() + (size_t)t * 6;
            b[0] = nz; b[1] = -1; b[2] = ny; b[3] = -1; b[4] = nx; b[5] = -1;
            for (int64_t z = lo; z < hi; z++) {
                const uint8_t* sl = vol + z * ny * nx;
                for (int64_t y = 0; y < ny; y++) {
                    const uint8_t* row = sl + y * nx;
                    int64_t x = 0;
                    for (; x + 8 <= nx; x += 8) {
                        uint64_t w;
                        memcpy(&w, row + x, 8);
                        if (w) break;
                    }
                    int64_t first = -1;
                    for (; x < nx; x++)
                        if (row[x]) { first = x; break; }
                    if (first < 0) continue;
                    int64_t last = nx - 1;
                    while (!row[last]) last--;
                    if (z < b[0]) b[0] = z;
                    if (z > b[1]) b[1] = z;
                    if (y < b[2]) b[2] = y;
                    if (y > b[3]) b[3] = y;
                    if (first < b[4]) b[4] = first;
                    if (last > b[5]) b[5] = last;
                }
            }
        };
        int nt = (int)std::min<int64_t>(n_threads, nz);
        std::vector<std::thread> pool;
        int64_t chunk = (nz + nt - 1) / nt;
        for (int t = 1; t < nt; t++) {
            int64_t lo = (int64_t)t * chunk;
            if (lo >= nz) break;
            pool.emplace_back(work, t, lo, std::min(lo + chunk, nz));
        }
        work(0, 0, std::min(chunk, nz));
        for (auto& th : pool) th.join();
        for (int t = 0; t < nt; t++) {
            int64_t* b = part.data() + (size_t)t * 6;
            zmin = std::min(zmin, b[0]); zmax = std::max(zmax, b[1]);
            ymin = std::min(ymin, b[2]); ymax = std::max(ymax, b[3]);
            xmin = std::min(xmin, b[4]); xmax = std::max(xmax, b[5]);
        }
    }
    if (zmax < 0) return new MiaMcState();   // empty mask

    // crop exactly like the numpy path — one voxel of margin, clamped —
    // but in the coordinates of the VIRTUALLY zero-padded volume when
    // pad=1: the caller's 31 MB np.pad copy was the single most
    // CPU-steal-exposed step of the old flow, replaced here by a ~5x
    // smaller guarded memcpy of just the cropped bounding box.
    const int64_t d = pad ? 1 : 0;
    const int64_t nzP = nz + 2 * d, nyP = ny + 2 * d, nxP = nx + 2 * d;
    const int64_t zminP = zmin + d, ymin_p = ymin + d, xmin_p = xmin + d;
    const int64_t z0 = zminP > 0 ? zminP - 1 : 0;
    const int64_t y0 = ymin_p > 0 ? ymin_p - 1 : 0;
    const int64_t x0 = xmin_p > 0 ? xmin_p - 1 : 0;
    const int64_t sz = std::min(zmax + d + 2, nzP) - z0;
    const int64_t sy = std::min(ymax + d + 2, nyP) - y0;
    const int64_t sx = std::min(xmax + d + 2, nxP) - x0;
    const int64_t cz = sz - 1, cy = sy - 1, cx = sx - 1;
    if (cz <= 0 || cy <= 0 || cx <= 0) return new MiaMcState();
    // doubled coords must fit the 16-bit key fields
    if (2 * (x0 + cx + 1) > 0x7FFF || 2 * (y0 + cy + 1) > 0x7FFF
        || 2 * (z0 + cz + 1) > 0x7FFF)
        return nullptr;

    // materialize the cropped (and virtually padded) subvolume
    std::vector<uint8_t> sub((size_t)sz * sy * sx, 0);
    {
        const int64_t rx0 = x0 - d;   // source x of sub column 0
        const int64_t cpy0 = std::max<int64_t>(rx0, 0);
        const int64_t cpy1 = std::min<int64_t>(rx0 + sx, nx);
        const int64_t ncpy = cpy1 - cpy0;
        if (ncpy > 0) {
            for (int64_t z = 0; z < sz; z++) {
                const int64_t rz = z0 + z - d;
                if (rz < 0 || rz >= nz) continue;
                for (int64_t y = 0; y < sy; y++) {
                    const int64_t ry = y0 + y - d;
                    if (ry < 0 || ry >= ny) continue;
                    memcpy(sub.data() + ((size_t)z * sy + y) * sx
                               + (cpy0 - rx0),
                           vol + (rz * ny + ry) * nx + cpy0,
                           (size_t)ncpy);
                }
            }
        }
    }

    uint8_t nt8[256];
    for (int i = 0; i < 256; i++) nt8[i] = (uint8_t)ntris_tab[i];

    // 2. corner patterns + per-layer triangle counts (one streaming
    // pass; numpy builds eight full shifted planes for this)
    std::vector<uint8_t> pat;
    std::vector<int64_t> layer_off((size_t)cz + 1, 0);
    pat.resize((size_t)cz * cy * cx);
    {
        auto work = [&](int64_t lo, int64_t hi) {
            for (int64_t z = lo; z < hi; z++) {
                int64_t cnt = 0;
                const uint8_t* s0 = sub.data() + (size_t)z * sy * sx;
                const uint8_t* s1 = s0 + sy * sx;
                uint8_t* pz = pat.data() + (size_t)z * cy * cx;
                for (int64_t y = 0; y < cy; y++) {
                    const uint8_t* r00 = s0 + y * sx;
                    const uint8_t* r01 = r00 + sx;
                    const uint8_t* r10 = s1 + y * sx;
                    const uint8_t* r11 = r10 + sx;
                    uint8_t* pr = pz + y * cx;
                    for (int64_t x = 0; x < cx; x++) {
                        uint8_t p = (uint8_t)(
                            (r00[x] & 1) | ((r00[x + 1] & 1) << 1)
                            | ((r01[x + 1] & 1) << 2) | ((r01[x] & 1) << 3)
                            | ((r10[x] & 1) << 4) | ((r10[x + 1] & 1) << 5)
                            | ((r11[x + 1] & 1) << 6)
                            | ((r11[x] & 1) << 7));
                        pr[x] = p;
                        cnt += nt8[p];
                    }
                }
                layer_off[z + 1] = cnt;
            }
        };
        int nt = (int)std::min<int64_t>(n_threads, cz);
        std::vector<std::thread> pool;
        int64_t chunk = (cz + nt - 1) / nt;
        for (int t = 1; t < nt; t++) {
            int64_t lo = (int64_t)t * chunk;
            if (lo >= cz) break;
            pool.emplace_back(work, lo, std::min(lo + chunk, cz));
        }
        work(0, std::min(chunk, cz));
        for (auto& th : pool) th.join();
    }
    sub.clear();
    sub.shrink_to_fit();
    for (int64_t z = 0; z < cz; z++) layer_off[z + 1] += layer_off[z];
    const int64_t M = layer_off[cz];
    if (M == 0) return new MiaMcState();
    const int64_t NK = M * 3;
    if (NK >= ((int64_t)1 << 27)) return nullptr;   // idx field overflow

    // 3. emit packed vertex keys (x' | y'<<16 | z'<<32, coords doubled,
    // relative to the crop — a per-axis constant shift preserves the
    // ascending-key order the weld sorts by, so ranks match the numpy
    // path's global-coordinate keys exactly)
    std::vector<uint64_t> keys((size_t)NK);
    {
        auto work = [&](int64_t lo, int64_t hi) {
            for (int64_t z = lo; z < hi; z++) {
                uint64_t* kp = keys.data() + (size_t)layer_off[z] * 3;
                const uint8_t* pz = pat.data() + (size_t)z * cy * cx;
                const uint64_t bz = (uint64_t)(2 * z) << 32;
                for (int64_t y = 0; y < cy; y++) {
                    const uint8_t* pr = pz + y * cx;
                    const uint64_t by = (uint64_t)(2 * y) << 16;
                    for (int64_t x = 0; x < cx; x++) {
                        int ntr = nt8[pr[x]];
                        if (!ntr) continue;
                        const int16_t* tp = flat_tab + starts[pr[x]] * 9;
                        const uint64_t base =
                            bz + by + (uint64_t)(2 * x);
                        for (int k = 0; k < ntr * 3; k++) {
                            *kp++ = base + (uint64_t)tp[k * 3]
                                  + ((uint64_t)tp[k * 3 + 1] << 16)
                                  + ((uint64_t)tp[k * 3 + 2] << 32);
                        }
                    }
                }
            }
        };
        int nt = (int)std::min<int64_t>(n_threads, cz);
        std::vector<std::thread> pool;
        int64_t chunk = (cz + nt - 1) / nt;
        for (int t = 1; t < nt; t++) {
            int64_t lo = (int64_t)t * chunk;
            if (lo >= cz) break;
            pool.emplace_back(work, lo, std::min(lo + chunk, cz));
        }
        work(0, std::min(chunk, cz));
        for (auto& th : pool) th.join();
    }
    pat.clear();
    pat.shrink_to_fit();

    // 4. weld: bucket by z' (emission is z-ordered so the scatter is
    // cache-local), sort (y'x' , emit idx) packs per bucket, rank
    // uniques ascending — exactly unique_inverse's sorted contract
    const int64_t NB = 2 * cz + 1;
    std::vector<int64_t> boff((size_t)NB + 1, 0);
    for (int64_t i = 0; i < NK; i++) boff[(keys[i] >> 32) + 1]++;
    for (int64_t b = 0; b < NB; b++) boff[b + 1] += boff[b];
    std::vector<uint64_t> packed((size_t)NK);
    {
        std::vector<int64_t> fill(boff.begin(), boff.end() - 1);
        for (int64_t i = 0; i < NK; i++) {
            uint64_t k = keys[i];
            packed[fill[k >> 32]++] =
                ((k & 0xFFFFFFFFull) << 27) | (uint64_t)i;
        }
    }
    keys.clear();
    keys.shrink_to_fit();

    std::vector<int64_t> ucnt((size_t)NB + 1, 0);
    {
        // per z-bucket: counting sort on the y' field (≤ 2*cy+1
        // values), then tiny std::sorts of the (z', y') segments —
        // ~4x over whole-bucket std::sort at organ scale (the bucket
        // is ~17k packs; segments are ~dozens)
        const int64_t nyb = 2 * cy + 1;
        auto work = [&](int64_t lo, int64_t hi) {
            std::vector<int64_t> hist((size_t)nyb + 1);
            std::vector<uint64_t> tmp;
            for (int64_t b = lo; b < hi; b++) {
                const int64_t s = boff[b], e = boff[b + 1], n = e - s;
                if (n > 1) {
                    std::fill(hist.begin(), hist.end(), 0);
                    for (int64_t i = s; i < e; i++)
                        hist[(packed[i] >> 43) + 1]++;
                    for (int64_t y = 0; y < nyb; y++)
                        hist[y + 1] += hist[y];
                    tmp.resize((size_t)n);
                    for (int64_t i = s; i < e; i++)
                        tmp[hist[packed[i] >> 43]++] = packed[i];
                    // hist[y] is now the segment END for y'
                    int64_t seg0 = 0;
                    for (int64_t y = 0; y < nyb && seg0 < n; y++) {
                        const int64_t seg1 = hist[y];
                        if (seg1 > seg0 + 1)
                            std::sort(tmp.begin() + seg0,
                                      tmp.begin() + seg1);
                        seg0 = seg1;
                    }
                    memcpy(packed.data() + s, tmp.data(),
                           (size_t)n * sizeof(uint64_t));
                }
                int64_t u = 0;
                uint64_t prev = ~0ull;
                for (int64_t i = s; i < e; i++) {
                    uint64_t kk = packed[i] >> 27;
                    if (kk != prev) { u++; prev = kk; }
                }
                ucnt[b + 1] = u;
            }
        };
        int nt = (int)std::min<int64_t>(n_threads, NB);
        std::vector<std::thread> pool;
        int64_t chunk = (NB + nt - 1) / nt;
        for (int t = 1; t < nt; t++) {
            int64_t lo = (int64_t)t * chunk;
            if (lo >= NB) break;
            pool.emplace_back(work, lo, std::min(lo + chunk, NB));
        }
        work(0, std::min(chunk, NB));
        for (auto& th : pool) th.join();
    }
    for (int64_t b = 0; b < NB; b++) ucnt[b + 1] += ucnt[b];
    const int64_t NP = ucnt[NB];

    MiaMcState* st = new MiaMcState();
    st->pts.resize((size_t)NP * 3);
    std::vector<int32_t> inverse((size_t)NK);
    {
        auto work = [&](int64_t lo, int64_t hi) {
            for (int64_t b = lo; b < hi; b++) {
                int64_t r = ucnt[b] - 1;
                uint64_t prev = ~0ull;
                const float pz =
                    (float)((uint64_t)b + 2 * (uint64_t)z0) * 0.5f;
                for (int64_t i = boff[b]; i < boff[b + 1]; i++) {
                    uint64_t kk = packed[i] >> 27;
                    if (kk != prev) {
                        prev = kk;
                        r++;
                        float* p = st->pts.data() + (size_t)r * 3;
                        p[0] = (float)((kk & 0xFFFF)
                                       + 2 * (uint64_t)x0) * 0.5f;
                        p[1] = (float)((kk >> 16)
                                       + 2 * (uint64_t)y0) * 0.5f;
                        p[2] = pz;
                    }
                    inverse[packed[i] & 0x7FFFFFF] = (int32_t)r;
                }
            }
        };
        int nt = (int)std::min<int64_t>(n_threads, NB);
        std::vector<std::thread> pool;
        int64_t chunk = (NB + nt - 1) / nt;
        for (int t = 1; t < nt; t++) {
            int64_t lo = (int64_t)t * chunk;
            if (lo >= NB) break;
            pool.emplace_back(work, lo, std::min(lo + chunk, NB));
        }
        work(0, std::min(chunk, NB));
        for (auto& th : pool) th.join();
    }

    // 5. faces in emit order, degenerate rows dropped (numpy `good`)
    st->faces.reserve((size_t)NK);
    for (int64_t t = 0; t < M; t++) {
        int32_t a = inverse[t * 3], b = inverse[t * 3 + 1],
                c = inverse[t * 3 + 2];
        if (a != b && b != c && a != c) {
            st->faces.push_back(a);
            st->faces.push_back(b);
            st->faces.push_back(c);
        }
    }
    *n_points = NP;
    *n_faces = (int64_t)(st->faces.size() / 3);
    return st;
}

int mia_mc_fetch(void* h, float* pts_out, int32_t* faces_out) {
    MiaMcState* st = (MiaMcState*)h;
    if (!st) return -1;
    if (!st->pts.empty())
        memcpy(pts_out, st->pts.data(), st->pts.size() * sizeof(float));
    if (!st->faces.empty())
        memcpy(faces_out, st->faces.data(),
               st->faces.size() * sizeof(int32_t));
    delete st;
    return 0;
}

void mia_mc_free(void* h) { delete (MiaMcState*)h; }

}  // extern "C"

// ======================= JPEG 2000 Part 1 decoder =======================
//
// Native port of the Python golden decoder (dicom/jpeg2k.py) for DICOM
// transfer syntaxes 1.2.840.10008.1.2.4.90/.91 — the codec the reference
// obtains through GDCM/OpenJPEG (reference read/dicom.py:52). Feature
// coverage and the typed-error contract match the Python implementation;
// parity is asserted codestream-by-codestream in tests/test_jpeg2000.py.
// Unsupported (clean negative return): subsampling != 1, POC, PPM/PPT,
// RGN.

namespace j2k {

struct Err {};                       // parse failure -> longjmp-free throw

static inline int64_t ceil_div_i64(int64_t a, int64_t b) {
    return (a + b - 1) / b;          // callers guarantee a >= 0, b > 0
}

// ---- MQ decoder (T.800 Annex C software conventions) ----

struct MqTabEntry { uint16_t qe; uint8_t nmps, nlps, sw; };
static const MqTabEntry kMqTab[47] = {
    {0x5601,1,1,1},{0x3401,2,6,0},{0x1801,3,9,0},{0x0AC1,4,12,0},
    {0x0521,5,29,0},{0x0221,38,33,0},{0x5601,7,6,1},{0x5401,8,14,0},
    {0x4801,9,14,0},{0x3801,10,14,0},{0x3001,11,17,0},{0x2401,12,18,0},
    {0x1C01,13,20,0},{0x1601,29,21,0},{0x5601,15,14,1},{0x5401,16,14,0},
    {0x5101,17,15,0},{0x4801,18,16,0},{0x3801,19,17,0},{0x3401,20,18,0},
    {0x3001,21,19,0},{0x2801,22,19,0},{0x2401,23,20,0},{0x2201,24,21,0},
    {0x1C01,25,22,0},{0x1801,26,23,0},{0x1601,27,24,0},{0x1401,28,25,0},
    {0x1201,29,26,0},{0x1101,30,27,0},{0x0AC1,31,28,0},{0x09C1,32,29,0},
    {0x08A1,33,30,0},{0x0521,34,31,0},{0x0441,35,32,0},{0x02A1,36,33,0},
    {0x0221,37,34,0},{0x0141,38,35,0},{0x0111,39,36,0},{0x0085,40,37,0},
    {0x0049,41,38,0},{0x0025,42,39,0},{0x0015,43,40,0},{0x0009,44,41,0},
    {0x0005,45,42,0},{0x0001,45,43,0},{0x5601,46,46,0},
};

static const int kNCtx = 19, kCtxRL = 17, kCtxUni = 18;

struct Ctx {
    uint8_t idx[kNCtx];
    uint8_t mps[kNCtx];
    void init() {
        memset(idx, 0, sizeof(idx));
        memset(mps, 0, sizeof(mps));
        idx[0] = 4; idx[kCtxRL] = 3; idx[kCtxUni] = 46;
    }
};

struct Mq {
    const uint8_t* d;
    size_t n, bp;
    uint32_t c, a;
    int ct;
    Ctx* cx;

    inline uint8_t byte_at(size_t i) const { return i < n ? d[i] : 0xFF; }

    void init(const uint8_t* data, size_t len, Ctx* ctx) {
        d = data; n = len; bp = 0; cx = ctx;
        c = (uint32_t)byte_at(0) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }

    inline void bytein() {
        if (byte_at(bp) == 0xFF) {
            if (byte_at(bp + 1) > 0x8F) { c += 0xFF00; ct = 8; }
            else { bp += 1; c += (uint32_t)byte_at(bp) << 9; ct = 7; }
        } else {
            bp += 1; c += (uint32_t)byte_at(bp) << 8; ct = 8;
        }
    }

    inline int decode(int k) {
        const MqTabEntry& e = kMqTab[cx->idx[k]];
        uint32_t qe = e.qe;
        int d_;
        a -= qe;
        if (((c >> 16) & 0xFFFF) < qe) {
            if (a < qe) { d_ = cx->mps[k]; cx->idx[k] = e.nmps; }
            else {
                d_ = 1 - cx->mps[k];
                if (e.sw) cx->mps[k] ^= 1;
                cx->idx[k] = e.nlps;
            }
            a = qe;
        } else {
            c -= qe << 16;
            if (a & 0x8000) return cx->mps[k];
            if (a < qe) {
                d_ = 1 - cx->mps[k];
                if (e.sw) cx->mps[k] ^= 1;
                cx->idx[k] = e.nlps;
            } else { d_ = cx->mps[k]; cx->idx[k] = e.nmps; }
        }
        do {
            if (ct == 0) bytein();
            a <<= 1; c <<= 1; ct -= 1;
        } while (!(a & 0x8000));
        return d_;
    }
};

// ---- raw (bypass) bit reader with 0xFF stuffing ----

struct RawBits {
    const uint8_t* d;
    size_t n, pos;
    int cur, nbits;
    void init(const uint8_t* data, size_t len) {
        d = data; n = len; pos = 0; cur = 0; nbits = 0;
    }
    inline int bit() {
        if (nbits == 0) {
            int prev = cur;
            cur = pos < n ? d[pos++] : 0;
            nbits = (prev == 0xFF) ? 7 : 8;
        }
        nbits -= 1;
        return (cur >> nbits) & 1;
    }
};

// ---- packet-header bit reader ----

struct HdrBits {
    const uint8_t* d;
    size_t n, pos;
    int cur, nbits;
    void init(const uint8_t* data, size_t len, size_t p) {
        d = data; n = len; pos = p; cur = 0; nbits = 0;
    }
    inline int bit() {
        if (nbits == 0) {
            int prev = cur;
            if (pos >= n) throw Err();
            cur = d[pos++];
            nbits = (prev == 0xFF) ? 7 : 8;
        }
        nbits -= 1;
        return (cur >> nbits) & 1;
    }
    inline uint64_t bits(int k) {
        uint64_t v = 0;
        for (int i = 0; i < k; i++) v = (v << 1) | (uint64_t)bit();
        return v;
    }
    size_t align() {
        if (nbits == 0 && cur == 0xFF) {
            if (pos >= n) throw Err();
            pos += 1;
        }
        nbits = 0; cur = 0;
        return pos;
    }
};

// ---- tag tree ----

struct TagTree {
    int w = 0, h = 0, nlev = 0;
    std::vector<int> lw, lh;
    std::vector<std::vector<int32_t>> low;
    std::vector<std::vector<uint8_t>> known;

    void init(int w_, int h_) {
        w = w_; h = h_;
        lw.clear(); lh.clear(); low.clear(); known.clear();
        int a = w, b = h;
        for (;;) {
            lw.push_back(a); lh.push_back(b);
            low.emplace_back((size_t)a * b, 0);
            known.emplace_back((size_t)a * b, 0);
            if (a == 1 && b == 1) break;
            a = (a + 1) / 2; b = (b + 1) / 2;
        }
        nlev = (int)lw.size();
    }

    bool decode(HdrBits& r, int x, int y, int threshold) {
        int path[24][2];
        int lx = x, ly = y, np = 0;
        for (int lev = 0; lev < nlev; lev++) {
            path[np][0] = lev;
            path[np][1] = ly * lw[lev] + lx;
            np++;
            lx >>= 1; ly >>= 1;
        }
        int lowv = 0;
        for (int i = np - 1; i >= 0; i--) {
            int lev = path[i][0], idx = path[i][1];
            if (low[lev][idx] < lowv) low[lev][idx] = lowv;
            while (!known[lev][idx] && low[lev][idx] < threshold) {
                if (r.bit()) known[lev][idx] = 1;
                else low[lev][idx] += 1;
            }
            lowv = low[lev][idx];
            if (!known[lev][idx]) return false;
        }
        return lowv < threshold;
    }

    int value(HdrBits& r, int x, int y) {
        int t = 1;
        while (!decode(r, x, y, t)) {
            t += 1;
            if (t > 1 << 20) throw Err();
        }
        return low[0][(size_t)y * lw[0] + x];
    }
};

// ---- significance/sign context tables (T.800 D.1/D.2) ----

static uint8_t kSigLut[4][3][3][5];
static uint8_t kSignLut[3][3][2];
static bool kLutsReady = false;

static void build_luts() {
    if (kLutsReady) return;
    auto ll_lh = [](int hh, int vv, int dd) -> int {
        if (hh == 2) return 8;
        if (hh == 1) return vv >= 1 ? 7 : (dd >= 1 ? 6 : 5);
        if (vv == 2) return 4;
        if (vv == 1) return 3;
        if (dd >= 2) return 2;
        return dd;
    };
    auto hhb = [](int hh, int vv, int dd) -> int {
        int hv = hh + vv;
        if (dd >= 3) return 8;
        if (dd == 2) return hv >= 1 ? 7 : 6;
        if (dd == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
        return hv >= 2 ? 2 : hv;
    };
    for (int hh = 0; hh < 3; hh++)
        for (int vv = 0; vv < 3; vv++)
            for (int dd = 0; dd < 5; dd++) {
                kSigLut[0][hh][vv][dd] = (uint8_t)ll_lh(hh, vv, dd);
                kSigLut[2][hh][vv][dd] = (uint8_t)ll_lh(hh, vv, dd);
                kSigLut[1][hh][vv][dd] = (uint8_t)ll_lh(vv, hh, dd);
                kSigLut[3][hh][vv][dd] = (uint8_t)hhb(hh, vv, dd);
            }
    // (hc+1, vc+1) -> {context, xor}
    static const int tbl[3][3][2] = {
        {{13, 1}, {12, 1}, {11, 1}},   // hc = -1: vc = -1, 0, +1
        {{10, 1}, {9, 0}, {10, 0}},    // hc = 0
        {{11, 0}, {12, 0}, {13, 0}},   // hc = +1
    };
    for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++) {
            kSignLut[i][j][0] = (uint8_t)tbl[i][j][0];
            kSignLut[i][j][1] = (uint8_t)tbl[i][j][1];
        }
    kLutsReady = true;
}

// ---- codestream structures ----

enum : uint16_t {
    M_SOC = 0xFF4F, M_SOT = 0xFF90, M_SOD = 0xFF93, M_EOC = 0xFFD9,
    M_SIZ = 0xFF51, M_COD = 0xFF52, M_COC = 0xFF53, M_QCD = 0xFF5C,
    M_QCC = 0xFF5D, M_RGN = 0xFF5E, M_POC = 0xFF5F, M_PPM = 0xFF60,
    M_PPT = 0xFF61, M_SOP = 0xFF91, M_EPH = 0xFF92,
};

enum : int {
    CB_LAZY = 0x01, CB_RESET = 0x02, CB_TERMALL = 0x04,
    CB_VSC = 0x08, CB_SEGSYM = 0x20,
};

struct CodStyle {
    int nl = 0, xcb = 0, ycb = 0, cbstyle = 0, transform = 0;
    std::vector<std::pair<int, int>> prec;     // (ppx, ppy) per res
};

struct QuantInfo {
    int style = 0, guard = 0;
    std::vector<std::pair<int, int>> steps;    // (eps, mant)
};

struct CodeBlk {
    int x0, y0, x1, y1;
    bool included = false;
    int zbp = 0, npasses = 0, lblock = 3;
    std::vector<std::vector<uint8_t>> segs;
};

struct PrecBand {
    int ncbw = 0, ncbh = 0;
    std::vector<CodeBlk> cbs;
    TagTree incl, zbpt;
};

struct BandT {
    int orient, x0, y0, x1, y1, eps, mant, gain;
    std::vector<int32_t> icoef;     // reversible
    std::vector<double> fcoef;      // irreversible
};

struct ResT {
    int r, x0, y0, x1, y1, ppx, ppy, npw = 0, nph = 0;
    std::vector<BandT> bands;
    std::vector<std::vector<PrecBand>> precincts;
};

struct TileCompT {
    int c;
    CodStyle cs;
    QuantInfo qi;
    int x0, y0, x1, y1;
    std::vector<ResT> res;
};

struct MainHdr {
    int64_t xs, ys, xo, yo, xts, yts, xto, yto;
    int csiz = 0;
    std::vector<int> prec;
    std::vector<uint8_t> sgnd;
    int prog = 0, layers = 1, mct = 0;
    int scod = 0;
    CodStyle cod;
    QuantInfo qcd;
    std::vector<CodStyle> coc;        // per component (valid flag below)
    std::vector<uint8_t> has_coc;
    std::vector<QuantInfo> qcc;
    std::vector<uint8_t> has_qcc;
};

struct Rd {
    const uint8_t* d;
    size_t n, pos = 0;
    inline uint16_t u16() {
        if (pos + 2 > n) throw Err();
        uint16_t v = ((uint16_t)d[pos] << 8) | d[pos + 1];
        pos += 2;
        return v;
    }
    inline uint32_t u32() {
        if (pos + 4 > n) throw Err();
        uint32_t v = ((uint32_t)d[pos] << 24) | ((uint32_t)d[pos+1] << 16)
                   | ((uint32_t)d[pos+2] << 8) | d[pos+3];
        pos += 4;
        return v;
    }
    inline uint8_t u8() {
        if (pos >= n) throw Err();
        return d[pos++];
    }
};

static CodStyle parse_spcod(Rd& r, size_t end, bool has_prec) {
    CodStyle cs;
    cs.nl = r.u8();
    cs.xcb = (r.u8() & 0x0F) + 2;
    cs.ycb = (r.u8() & 0x0F) + 2;
    if (cs.nl > 32 || cs.xcb > 10 || cs.ycb > 10 || cs.xcb + cs.ycb > 12)
        throw Err();
    cs.cbstyle = r.u8();
    cs.transform = r.u8();
    if (cs.transform > 1) throw Err();
    if (has_prec) {
        for (int i = 0; i <= cs.nl; i++) {
            if (r.pos >= end) throw Err();
            uint8_t b = r.u8();
            cs.prec.push_back({b & 0x0F, (b >> 4) & 0x0F});
        }
    } else {
        cs.prec.assign(cs.nl + 1, {15, 15});
    }
    return cs;
}

static QuantInfo parse_sqcx(Rd& r, size_t end) {
    QuantInfo q;
    uint8_t sq = r.u8();
    q.style = sq & 0x1F;
    q.guard = (sq >> 5) & 7;
    if (q.style == 0) {
        while (r.pos < end) q.steps.push_back({r.u8() >> 3, 0});
    } else if (q.style == 1) {
        uint16_t v = r.u16();
        q.steps.push_back({v >> 11, v & 0x7FF});
    } else if (q.style == 2) {
        while (r.pos + 1 < end) {
            uint16_t v = r.u16();
            q.steps.push_back({v >> 11, v & 0x7FF});
        }
    } else {
        throw Err();
    }
    return q;
}

struct TileData {
    std::vector<uint8_t> data;      // concatenated tile-part payloads
};

// parse marker segments until SOD (in tile-part) / SOT / EOC (main)
static uint16_t parse_headers(Rd& r, size_t end, MainHdr& m, int tile_idx,
                              CodStyle* tcod, QuantInfo* tqcd,
                              int* tscod, int* tprog, int* tlayers,
                              int* tmct, bool* has_tcod, bool* has_tqcd,
                              std::vector<CodStyle>* tcoc,
                              std::vector<uint8_t>* has_tcoc,
                              std::vector<QuantInfo>* tqcc,
                              std::vector<uint8_t>* has_tqcc) {
    for (;;) {
        if (r.pos + 2 > end) throw Err();
        uint16_t mk = r.u16();
        if (mk == M_SOT || mk == M_EOC) { r.pos -= 2; return mk; }
        if (mk == M_SOD) return mk;
        if (mk < 0xFF30) throw Err();
        uint16_t ln = r.u16();
        if (ln < 2 || r.pos + ln - 2 > end) throw Err();
        size_t seg_end = r.pos + ln - 2;
        switch (mk) {
        case M_SIZ: {
            // Rsiz bit 14 = CAP-marker capabilities (HTJ2K Part 15),
            // bit 15 = Part-2 extensions: different block/transform
            // machinery; reject rather than decode garbage (the
            // Python route raises the typed error)
            if (r.u16() & 0xC000) throw Err();
            m.xs = r.u32(); m.ys = r.u32();
            m.xo = r.u32(); m.yo = r.u32();
            m.xts = r.u32(); m.yts = r.u32();
            m.xto = r.u32(); m.yto = r.u32();
            m.csiz = r.u16();
            if (m.csiz < 1 || m.csiz > 16384) throw Err();
            if (m.xts <= 0 || m.yts <= 0) throw Err();
            if (m.xs <= m.xo || m.ys <= m.yo) throw Err();
            if (m.xto > m.xo || m.yto > m.yo) throw Err();
            for (int c = 0; c < m.csiz; c++) {
                uint8_t ssiz = r.u8();
                uint8_t xr = r.u8(), yr = r.u8();
                if (xr != 1 || yr != 1) throw Err();   // no subsampling
                m.prec.push_back((ssiz & 0x7F) + 1);
                m.sgnd.push_back((ssiz & 0x80) ? 1 : 0);
                if (m.prec.back() > 31) throw Err();
            }
            m.coc.resize(m.csiz);
            m.has_coc.assign(m.csiz, 0);
            m.qcc.resize(m.csiz);
            m.has_qcc.assign(m.csiz, 0);
            break;
        }
        case M_COD: {
            int scod = r.u8();
            int prog = r.u8();
            int layers = r.u16();
            int mct = r.u8();
            if (layers < 1 || layers > 65535) throw Err();
            CodStyle cs = parse_spcod(r, seg_end, scod & 1);
            if (tile_idx < 0) {
                m.scod = scod; m.prog = prog; m.layers = layers;
                m.mct = mct; m.cod = cs;
            } else {
                *tscod = scod; *tprog = prog; *tlayers = layers;
                *tmct = mct; *tcod = cs; *has_tcod = true;
            }
            break;
        }
        case M_COC: {
            int ci = (m.csiz < 257) ? r.u8() : r.u16();
            if (ci >= m.csiz) throw Err();
            int scoc = r.u8();
            CodStyle cs = parse_spcod(r, seg_end, scoc & 1);
            if (tile_idx < 0) { m.coc[ci] = cs; m.has_coc[ci] = 1; }
            else { (*tcoc)[ci] = cs; (*has_tcoc)[ci] = 1; }
            break;
        }
        case M_QCD: {
            QuantInfo q = parse_sqcx(r, seg_end);
            if (tile_idx < 0) m.qcd = q;
            else { *tqcd = q; *has_tqcd = true; }
            break;
        }
        case M_QCC: {
            int ci = (m.csiz < 257) ? r.u8() : r.u16();
            if (ci >= m.csiz) throw Err();
            QuantInfo q = parse_sqcx(r, seg_end);
            if (tile_idx < 0) { m.qcc[ci] = q; m.has_qcc[ci] = 1; }
            else { (*tqcc)[ci] = q; (*has_tqcc)[ci] = 1; }
            break;
        }
        case M_POC: case M_PPM: case M_PPT: case M_RGN:
            throw Err();                        // unsupported features
        default:
            break;                              // skippable segment
        }
        r.pos = seg_end;
    }
}

// ---- tile-component geometry (T.800 Annex B) ----

static const int kGain[4] = {0, 1, 1, 2};

static void band_quant(const QuantInfo& q, int r, int orient, int nl,
                       int* eps, int* mant) {
    int lev = (r == 0) ? nl : nl - r + 1;
    if (q.style == 1) {
        *eps = q.steps[0].first - nl + lev;
        *mant = q.steps[0].second;
        return;
    }
    size_t bi = (r == 0) ? 0 : (size_t)(3 * (r - 1) + orient);
    if (bi >= q.steps.size()) throw Err();
    *eps = q.steps[bi].first;
    *mant = q.steps[bi].second;
}

static void build_tilecomp(TileCompT& tc, const MainHdr& m, int c,
                           const CodStyle& cs, const QuantInfo& qi,
                           int64_t tx0, int64_t ty0, int64_t tx1,
                           int64_t ty1) {
    tc.c = c;
    tc.cs = cs;
    tc.qi = qi;
    tc.x0 = (int)tx0; tc.y0 = (int)ty0;
    tc.x1 = (int)tx1; tc.y1 = (int)ty1;
    int nl = cs.nl;
    tc.res.resize(nl + 1);
    for (int r = 0; r <= nl; r++) {
        ResT& res = tc.res[r];
        res.r = r;
        int sh = nl - r;
        res.x0 = (int)ceil_div_i64(tx0, 1LL << sh);
        res.y0 = (int)ceil_div_i64(ty0, 1LL << sh);
        res.x1 = (int)ceil_div_i64(tx1, 1LL << sh);
        res.y1 = (int)ceil_div_i64(ty1, 1LL << sh);
        res.ppx = cs.prec[r].first;
        res.ppy = cs.prec[r].second;
        if (r > 0 && (res.ppx < 1 || res.ppy < 1)) throw Err();
        struct BG { int o, x0, y0, x1, y1; };
        std::vector<BG> geo;
        if (r == 0) {
            geo.push_back({0, res.x0, res.y0, res.x1, res.y1});
        } else {
            int lev = nl - r + 1;
            const int ob[3][2] = {{1, 0}, {0, 1}, {1, 1}};
            for (int k = 0; k < 3; k++) {
                int xob = ob[k][0], yob = ob[k][1];
                int64_t half = 1LL << (lev - 1), full = 1LL << lev;
                auto cdiv = [](int64_t a, int64_t b) {
                    // floor-safe ceil for possibly negative numerators
                    return (a >= 0) ? (a + b - 1) / b : -((-a) / b);
                };
                geo.push_back({k + 1,
                               (int)cdiv(tx0 - half * xob, full),
                               (int)cdiv(ty0 - half * yob, full),
                               (int)cdiv(tx1 - half * xob, full),
                               (int)cdiv(ty1 - half * yob, full)});
            }
        }
        for (auto& g : geo) {
            BandT b;
            b.orient = g.o;
            b.x0 = g.x0; b.y0 = g.y0; b.x1 = g.x1; b.y1 = g.y1;
            band_quant(qi, r, g.o, nl, &b.eps, &b.mant);
            b.gain = kGain[g.o];
            size_t w = (size_t)std::max(g.x1 - g.x0, 0);
            size_t h = (size_t)std::max(g.y1 - g.y0, 0);
            if (cs.transform == 1) b.icoef.assign(w * h, 0);
            else b.fcoef.assign(w * h, 0.0);
            res.bands.push_back(std::move(b));
        }
        if (res.x1 > res.x0 && res.y1 > res.y0) {
            res.npw = (int)(ceil_div_i64(res.x1, 1LL << res.ppx)
                            - (res.x0 >> res.ppx));
            res.nph = (int)(ceil_div_i64(res.y1, 1LL << res.ppy)
                            - (res.y0 >> res.ppy));
        }
        if ((int64_t)res.npw * res.nph > (1 << 22)) throw Err();
        int shift = (r == 0) ? 0 : 1;
        int xcb_eff = std::min(cs.xcb,
                               r == 0 ? res.ppx : std::max(res.ppx - 1, 0));
        int ycb_eff = std::min(cs.ycb,
                               r == 0 ? res.ppy : std::max(res.ppy - 1, 0));
        res.precincts.resize((size_t)res.npw * res.nph);
        for (int pj = 0; pj < res.nph; pj++)
            for (int pi = 0; pi < res.npw; pi++) {
                int64_t ax0 = ((int64_t)(res.x0 >> res.ppx) + pi)
                              << res.ppx;
                int64_t ay0 = ((int64_t)(res.y0 >> res.ppy) + pj)
                              << res.ppy;
                int64_t ax1 = ax0 + (1LL << res.ppx);
                int64_t ay1 = ay0 + (1LL << res.ppy);
                auto& pbs = res.precincts[(size_t)pj * res.npw + pi];
                pbs.resize(res.bands.size());
                for (size_t bi = 0; bi < res.bands.size(); bi++) {
                    BandT& b = res.bands[bi];
                    PrecBand& pb = pbs[bi];
                    int gx0 = std::max(b.x0, (int)(ax0 >> shift));
                    int gy0 = std::max(b.y0, (int)(ay0 >> shift));
                    int gx1 = std::min(b.x1, (int)(ax1 >> shift));
                    int gy1 = std::min(b.y1, (int)(ay1 >> shift));
                    if (gx1 <= gx0 || gy1 <= gy0) continue;
                    int cw = 1 << xcb_eff, ch = 1 << ycb_eff;
                    int ci0 = gx0 / cw, cj0 = gy0 / ch;
                    pb.ncbw = (int)(ceil_div_i64(gx1, cw) - ci0);
                    pb.ncbh = (int)(ceil_div_i64(gy1, ch) - cj0);
                    if ((int64_t)pb.ncbw * pb.ncbh > (1 << 20)) throw Err();
                    pb.cbs.reserve((size_t)pb.ncbw * pb.ncbh);
                    for (int cj = 0; cj < pb.ncbh; cj++)
                        for (int ci = 0; ci < pb.ncbw; ci++) {
                            CodeBlk cb;
                            cb.x0 = std::max(gx0, (ci0 + ci) * cw);
                            cb.y0 = std::max(gy0, (cj0 + cj) * ch);
                            cb.x1 = std::min(gx1, (ci0 + ci + 1) * cw);
                            cb.y1 = std::min(gy1, (cj0 + cj + 1) * ch);
                            pb.cbs.push_back(std::move(cb));
                        }
                    pb.incl.init(pb.ncbw, pb.ncbh);
                    pb.zbpt.init(pb.ncbw, pb.ncbh);
                }
            }
    }
}

// ---- coding-pass / segment mapping ----

static inline int pass_type(int idx) {
    return idx == 0 ? 2 : (idx - 1) % 3;
}

static inline int seg_of_pass(int idx, int cbstyle) {
    if (cbstyle & CB_TERMALL) return idx;
    if (cbstyle & CB_LAZY) {
        if (idx < 10) return 0;
        int k = idx - 10;
        return 1 + 2 * (k / 3) + ((k % 3 == 2) ? 1 : 0);
    }
    return 0;
}

static inline int seg_last_pass(int idx, int cbstyle) {
    if (cbstyle & CB_TERMALL) return idx;
    if (cbstyle & CB_LAZY) {
        if (idx < 10) return 9;
        int k = idx - 10;
        if (k % 3 == 2) return idx;
        return 10 + 3 * (k / 3) + 1;
    }
    return INT32_MAX;
}

// ---- Tier-1 code-block decode (T.800 Annex D) ----

struct T1 {
    int w = 0, h = 0;
    std::vector<uint8_t> sig, vis, refd, sgn, lastp;
    std::vector<int32_t> mag;

    inline int sig_at(int x, int y, int ystripe, bool vsc) const {
        if (x < 0 || x >= w || y < 0 || y >= h) return 0;
        if (vsc && (y >> 2) > ystripe) return 0;
        return sig[(size_t)y * w + x];
    }

    inline int sig_ctx(int x, int y, int orient, bool vsc) const {
        int ys = y >> 2;
        int hh = sig_at(x - 1, y, ys, vsc) + sig_at(x + 1, y, ys, vsc);
        int vv = sig_at(x, y - 1, ys, vsc) + sig_at(x, y + 1, ys, vsc);
        int dd = sig_at(x - 1, y - 1, ys, vsc)
               + sig_at(x + 1, y - 1, ys, vsc)
               + sig_at(x - 1, y + 1, ys, vsc)
               + sig_at(x + 1, y + 1, ys, vsc);
        return kSigLut[orient][hh][vv][dd];
    }

    inline int contrib(int x, int y, int ystripe, bool vsc) const {
        if (x < 0 || x >= w || y < 0 || y >= h) return 0;
        if (vsc && (y >> 2) > ystripe) return 0;
        size_t i = (size_t)y * w + x;
        if (!sig[i]) return 0;
        return sgn[i] ? -1 : 1;
    }

    inline void sign_ctx(int x, int y, bool vsc, int* cx, int* xr) const {
        int ys = y >> 2;
        int hc = contrib(x - 1, y, ys, vsc) + contrib(x + 1, y, ys, vsc);
        hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
        int vc = contrib(x, y - 1, ys, vsc) + contrib(x, y + 1, ys, vsc);
        vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
        *cx = kSignLut[hc + 1][vc + 1][0];
        *xr = kSignLut[hc + 1][vc + 1][1];
    }
};

// decode one code block into mag/sgn arrays of the T1 scratch
static void t1_decode(T1& t, CodeBlk& cb, int orient, int mb,
                      int cbstyle) {
    int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
    t.w = w; t.h = h;
    size_t size = (size_t)w * h;
    t.sig.assign(size, 0);
    t.vis.assign(size, 0);
    t.refd.assign(size, 0);
    t.sgn.assign(size, 0);
    t.lastp.assign(size, 0);
    t.mag.assign(size, 0);
    int numbps = mb - cb.zbp;
    if (cb.npasses == 0 || numbps <= 0 || w <= 0 || h <= 0) return;
    if (numbps > 31) throw Err();
    bool vsc = (cbstyle & CB_VSC) != 0;
    bool lazy = (cbstyle & CB_LAZY) != 0;

    Ctx ctx;
    ctx.init();
    Mq mq;
    RawBits raw;
    int cur_seg = -1;
    bool cur_raw = false;
    int plane = numbps - 1;
    static const std::vector<uint8_t> kEmpty;

    for (int pidx = 0; pidx < cb.npasses; pidx++) {
        if (plane < 0) throw Err();   // more passes than bitplanes
        int pt = pass_type(pidx);
        bool is_raw = lazy && pidx >= 10 && pt != 2;
        int sid = seg_of_pass(pidx, cbstyle);
        if (sid != cur_seg) {
            const std::vector<uint8_t>& seg =
                (size_t)sid < cb.segs.size() ? cb.segs[sid] : kEmpty;
            if (is_raw) raw.init(seg.data(), seg.size());
            else mq.init(seg.data(), seg.size(), &ctx);
            cur_seg = sid;
            cur_raw = is_raw;
        }
        if ((cbstyle & CB_RESET) && !is_raw) ctx.init();
        (void)cur_raw;
        int32_t bit = 1 << plane;

        if (pt == 0) {                 // significance propagation
            for (int y0 = 0; y0 < h; y0 += 4) {
                int ylim = std::min(y0 + 4, h);
                for (int x = 0; x < w; x++)
                    for (int y = y0; y < ylim; y++) {
                        size_t i = (size_t)y * w + x;
                        if (t.sig[i]) continue;
                        int cx = t.sig_ctx(x, y, orient, vsc);
                        if (cx == 0) continue;
                        t.vis[i] = 1;
                        int d = is_raw ? raw.bit() : mq.decode(cx);
                        if (d) {
                            int s;
                            if (is_raw) s = raw.bit();
                            else {
                                int sc, xr;
                                t.sign_ctx(x, y, vsc, &sc, &xr);
                                s = mq.decode(sc) ^ xr;
                            }
                            t.sig[i] = 1;
                            t.sgn[i] = (uint8_t)s;
                            t.mag[i] |= bit;
                            t.lastp[i] = (uint8_t)plane;
                        }
                    }
            }
        } else if (pt == 1) {          // magnitude refinement
            for (int y0 = 0; y0 < h; y0 += 4) {
                int ylim = std::min(y0 + 4, h);
                for (int x = 0; x < w; x++)
                    for (int y = y0; y < ylim; y++) {
                        size_t i = (size_t)y * w + x;
                        if (!t.sig[i] || t.vis[i]) continue;
                        int d;
                        if (is_raw) d = raw.bit();
                        else {
                            int cx;
                            if (t.refd[i]) cx = 16;
                            else {
                                int ys = y >> 2;
                                int any =
                                    t.sig_at(x-1, y, ys, vsc)
                                  + t.sig_at(x+1, y, ys, vsc)
                                  + t.sig_at(x, y-1, ys, vsc)
                                  + t.sig_at(x, y+1, ys, vsc)
                                  + t.sig_at(x-1, y-1, ys, vsc)
                                  + t.sig_at(x+1, y-1, ys, vsc)
                                  + t.sig_at(x-1, y+1, ys, vsc)
                                  + t.sig_at(x+1, y+1, ys, vsc);
                                cx = any ? 15 : 14;
                            }
                            d = mq.decode(cx);
                        }
                        if (d) t.mag[i] |= bit;
                        t.lastp[i] = (uint8_t)plane;
                        t.refd[i] = 1;
                    }
            }
        } else {                       // cleanup
            for (int y0 = 0; y0 < h; y0 += 4) {
                int ylim = std::min(y0 + 4, h);
                for (int x = 0; x < w; x++) {
                    int y = y0;
                    if (ylim - y0 == 4) {
                        bool rl = true;
                        for (int yy = y0; yy < ylim; yy++) {
                            size_t i = (size_t)yy * w + x;
                            if (t.sig[i] || t.vis[i]
                                || t.sig_ctx(x, yy, orient, vsc) != 0) {
                                rl = false;
                                break;
                            }
                        }
                        if (rl) {
                            if (mq.decode(kCtxRL) == 0) continue;
                            int rr = (mq.decode(kCtxUni) << 1)
                                   | mq.decode(kCtxUni);
                            y = y0 + rr;
                            size_t i = (size_t)y * w + x;
                            int sc, xr;
                            t.sign_ctx(x, y, vsc, &sc, &xr);
                            int s = mq.decode(sc) ^ xr;
                            t.sig[i] = 1;
                            t.sgn[i] = (uint8_t)s;
                            t.mag[i] |= bit;
                            t.lastp[i] = (uint8_t)plane;
                            y += 1;
                        }
                    }
                    for (; y < ylim; y++) {
                        size_t i = (size_t)y * w + x;
                        if (!t.sig[i] && !t.vis[i]) {
                            int cx = t.sig_ctx(x, y, orient, vsc);
                            if (mq.decode(cx)) {
                                int sc, xr;
                                t.sign_ctx(x, y, vsc, &sc, &xr);
                                int s = mq.decode(sc) ^ xr;
                                t.sig[i] = 1;
                                t.sgn[i] = (uint8_t)s;
                                t.mag[i] |= bit;
                                t.lastp[i] = (uint8_t)plane;
                            }
                        }
                    }
                }
            }
            if (cbstyle & CB_SEGSYM) {
                int v = 0;
                for (int k = 0; k < 4; k++)
                    v = (v << 1) | mq.decode(kCtxUni);
                if (v != 0xA) throw Err();
            }
            std::fill(t.vis.begin(), t.vis.end(), 0);
            plane -= 1;
        }
    }
    // per-coefficient midpoint reconstruction (matches the Python
    // golden decoder: half the last coded plane's LSB)
    for (size_t i = 0; i < size; i++)
        if (t.mag[i] && t.lastp[i] > 0)
            t.mag[i] += 1 << (t.lastp[i] - 1);
}

// ---- packet decoding ----

struct TileStream {
    const uint8_t* d;
    size_t n, pos = 0;
};

static void read_packet(TileStream& ts, ResT& res, int pidx, int layer,
                        int scod, int cbstyle) {
    if (ts.pos >= ts.n) throw Err();
    size_t pos = ts.pos;
    if ((scod & 2) && pos + 2 <= ts.n && ts.d[pos] == 0xFF
        && ts.d[pos + 1] == 0x91) {
        pos += 6;
        if (pos > ts.n) throw Err();
    }
    HdrBits rdr;
    rdr.init(ts.d, ts.n, pos);
    struct Portion { int sid; int64_t nbytes; };
    struct Contrib { CodeBlk* cb; std::vector<Portion> lens; };
    std::vector<Contrib> contribs;
    if (rdr.bit()) {
        auto& pbs = res.precincts[pidx];
        for (auto& pb : pbs) {
            if (pb.ncbw == 0) continue;
            for (size_t ci = 0; ci < pb.cbs.size(); ci++) {
                CodeBlk& cb = pb.cbs[ci];
                int x = (int)(ci % pb.ncbw);
                int y = (int)(ci / pb.ncbw);
                bool inc;
                if (!cb.included) inc = pb.incl.decode(rdr, x, y, layer + 1);
                else inc = rdr.bit() != 0;
                if (!inc) continue;
                if (!cb.included) {
                    cb.included = true;
                    cb.zbp = pb.zbpt.value(rdr, x, y);
                }
                int n;
                if (rdr.bit() == 0) n = 1;
                else if (rdr.bit() == 0) n = 2;
                else {
                    int v = (int)rdr.bits(2);
                    if (v < 3) n = 3 + v;
                    else {
                        v = (int)rdr.bits(5);
                        if (v < 31) n = 6 + v;
                        else n = 37 + (int)rdr.bits(7);
                    }
                }
                while (rdr.bit()) {
                    cb.lblock += 1;
                    if (cb.lblock > 64) throw Err();
                }
                Contrib con;
                con.cb = &cb;
                int p = cb.npasses, rem = n;
                while (rem > 0) {
                    int sid = seg_of_pass(p, cbstyle);
                    int last = seg_last_pass(p, cbstyle);
                    int take = (int)std::min((int64_t)rem,
                                             (int64_t)last - p + 1);
                    int lg = 0;
                    while ((1 << (lg + 1)) <= take) lg++;
                    int nbits = cb.lblock + lg;
                    if (nbits > 62) throw Err();
                    int64_t nbytes = (int64_t)rdr.bits(nbits);
                    con.lens.push_back({sid, nbytes});
                    p += take;
                    rem -= take;
                }
                cb.npasses += n;
                if (cb.npasses > 3 * 31 + 1) throw Err();
                contribs.push_back(std::move(con));
            }
        }
    }
    pos = rdr.align();
    if (scod & 4) {
        if (pos + 2 > ts.n || ts.d[pos] != 0xFF || ts.d[pos + 1] != 0x92)
            throw Err();
        pos += 2;
    }
    for (auto& con : contribs) {
        for (auto& pr : con.lens) {
            if (pos + (size_t)pr.nbytes > ts.n) throw Err();
            if ((size_t)pr.sid >= con.cb->segs.size())
                con.cb->segs.resize(pr.sid + 1);
            auto& seg = con.cb->segs[pr.sid];
            seg.insert(seg.end(), ts.d + pos, ts.d + pos + pr.nbytes);
            pos += (size_t)pr.nbytes;
        }
    }
    ts.pos = pos;
}

// ---- progression iteration ----

struct PktRef { int l, r, c, p; };

static void packet_sequence(const MainHdr& m, int prog, int layers,
                            std::vector<TileCompT>& tcs,
                            int64_t tx0, int64_t ty0,
                            std::vector<PktRef>& out) {
    int ncomp = (int)tcs.size();
    int maxres = 0;
    for (auto& tc : tcs) maxres = std::max(maxres, tc.cs.nl + 1);
    if (prog == 0) {                               // LRCP
        for (int l = 0; l < layers; l++)
            for (int r = 0; r < maxres; r++)
                for (int c = 0; c < ncomp; c++) {
                    if (r > tcs[c].cs.nl) continue;
                    ResT& res = tcs[c].res[r];
                    for (int p = 0; p < res.npw * res.nph; p++)
                        out.push_back({l, r, c, p});
                }
        return;
    }
    if (prog == 1) {                               // RLCP
        for (int r = 0; r < maxres; r++)
            for (int l = 0; l < layers; l++)
                for (int c = 0; c < ncomp; c++) {
                    if (r > tcs[c].cs.nl) continue;
                    ResT& res = tcs[c].res[r];
                    for (int p = 0; p < res.npw * res.nph; p++)
                        out.push_back({l, r, c, p});
                }
        return;
    }
    if (prog < 2 || prog > 4) throw Err();
    struct Ev { int c, r, p; int64_t x, y; };
    std::vector<Ev> events;
    for (int c = 0; c < ncomp; c++) {
        int nl = tcs[c].cs.nl;
        for (int r = 0; r <= nl; r++) {
            ResT& res = tcs[c].res[r];
            int sh = nl - r;
            for (int pj = 0; pj < res.nph; pj++) {
                int64_t ay = ((((int64_t)res.y0 >> res.ppy) + pj)
                              << res.ppy) << sh;
                int64_t y = std::max(ay, ty0);
                for (int pi = 0; pi < res.npw; pi++) {
                    int64_t ax = ((((int64_t)res.x0 >> res.ppx) + pi)
                                  << res.ppx) << sh;
                    int64_t x = std::max(ax, tx0);
                    events.push_back({c, r, pj * res.npw + pi, x, y});
                }
            }
        }
    }
    auto key_rpcl = [](const Ev& a, const Ev& b) {
        if (a.r != b.r) return a.r < b.r;
        if (a.y != b.y) return a.y < b.y;
        if (a.x != b.x) return a.x < b.x;
        return a.c < b.c;
    };
    auto key_pcrl = [](const Ev& a, const Ev& b) {
        if (a.y != b.y) return a.y < b.y;
        if (a.x != b.x) return a.x < b.x;
        if (a.c != b.c) return a.c < b.c;
        return a.r < b.r;
    };
    auto key_cprl = [](const Ev& a, const Ev& b) {
        if (a.c != b.c) return a.c < b.c;
        if (a.y != b.y) return a.y < b.y;
        if (a.x != b.x) return a.x < b.x;
        return a.r < b.r;
    };
    if (prog == 2) std::stable_sort(events.begin(), events.end(), key_rpcl);
    else if (prog == 3) std::stable_sort(events.begin(), events.end(),
                                         key_pcrl);
    else std::stable_sort(events.begin(), events.end(), key_cprl);
    for (auto& e : events)
        for (int l = 0; l < layers; l++)
            out.push_back({l, e.r, e.c, e.p});
}

// ---- inverse DWT (T.800 Annex F) ----

static const double kK97 = 1.230174104914001;
static const double kA97 = 1.586134342059924;
static const double kB97 = 0.052980118572961;
static const double kG97 = 0.882911075530934;
static const double kD97 = 0.443506852043971;

static inline int reflect_idx(int64_t k, int64_t n) {
    if (n == 1) return 0;
    int64_t period = 2 * (n - 1);
    k %= period;
    if (k < 0) k += period;
    return (int)(k < n ? k : period - k);
}

// 1D synthesis in place on a line of length n at coords [i0, i0+n);
// scratch must hold n + 4 elements
template <typename T>
static void sr1d_line(T* line, int64_t i0, int64_t n, bool irr,
                      T* ext) {
    if (n == 1) {
        if (i0 & 1) {
            if (irr) line[0] = (T)(line[0] * kK97);
            else line[0] = (T)(((int64_t)line[0]) >> 1);
        }
        return;
    }
    memcpy(ext + 2, line, (size_t)n * sizeof(T));
    auto refresh = [&]() {
        ext[1] = ext[2 + reflect_idx(-1, n)];
        ext[0] = ext[2 + reflect_idx(-2, n)];
        ext[2 + n] = ext[2 + reflect_idx(n, n)];
        ext[3 + n] = ext[2 + reflect_idx(n + 1, n)];
    };
    refresh();
    int64_t ev0 = (i0 & 1) ? 1 : 0;   // local index of first even coord
    int64_t od0 = 1 - ev0;
    if (!irr) {
        // 64-bit intermediates: crafted streams can legally signal
        // mb up to 31, putting coefficients near INT32_MAX where the
        // two-term sums would be signed-overflow UB in int32
        int32_t* e = (int32_t*)ext;
        for (int64_t k = ev0; k < n; k += 2)
            e[2 + k] -= (int32_t)(((int64_t)e[1 + k] + e[3 + k] + 2) >> 2);
        refresh();
        for (int64_t k = od0; k < n; k += 2)
            e[2 + k] += (int32_t)(((int64_t)e[1 + k] + e[3 + k]) >> 1);
    } else {
        double* e = (double*)ext;
        for (int64_t k = ev0; k < n; k += 2) e[2 + k] *= kK97;
        for (int64_t k = od0; k < n; k += 2) e[2 + k] *= 1.0 / kK97;
        refresh();
        for (int64_t k = ev0; k < n; k += 2)
            e[2 + k] -= kD97 * (e[1 + k] + e[3 + k]);
        refresh();
        for (int64_t k = od0; k < n; k += 2)
            e[2 + k] -= kG97 * (e[1 + k] + e[3 + k]);
        refresh();
        for (int64_t k = ev0; k < n; k += 2)
            e[2 + k] += kB97 * (e[1 + k] + e[3 + k]);
        refresh();
        for (int64_t k = od0; k < n; k += 2)
            e[2 + k] += kA97 * (e[1 + k] + e[3 + k]);
    }
    memcpy(line, ext + 2, (size_t)n * sizeof(T));
}

// one 2D synthesis level: interleave LL/HL/LH/HH into out, then
// horizontal and vertical 1D passes
template <typename T>
static void idwt_level(std::vector<T>& ll, int llw, int llh,
                       const std::vector<T>& hl, int hlw,
                       const std::vector<T>& lh, int lhw,
                       const std::vector<T>& hh, int hhw,
                       int64_t ox0, int64_t oy0, int64_t ox1, int64_t oy1,
                       bool irr, std::vector<T>& out) {
    int64_t ow = ox1 - ox0, oh = oy1 - oy0;
    out.assign((size_t)ow * oh, (T)0);
    int ye = (oy0 & 1) ? 1 : 0, xe = (ox0 & 1) ? 1 : 0;
    int yo = 1 - ye, xo = 1 - xe;
    for (int64_t j = ye, r = 0; j < oh; j += 2, r++) {
        for (int64_t i = xe, c = 0; i < ow; i += 2, c++)
            out[(size_t)j * ow + i] = ll[(size_t)r * llw + c];
        for (int64_t i = xo, c = 0; i < ow; i += 2, c++)
            out[(size_t)j * ow + i] = hl[(size_t)r * hlw + c];
    }
    for (int64_t j = yo, r = 0; j < oh; j += 2, r++) {
        for (int64_t i = xe, c = 0; i < ow; i += 2, c++)
            out[(size_t)j * ow + i] = lh[(size_t)r * lhw + c];
        for (int64_t i = xo, c = 0; i < ow; i += 2, c++)
            out[(size_t)j * ow + i] = hh[(size_t)r * hhw + c];
    }
    std::vector<T> ext((size_t)std::max(ow, oh) + 4);
    for (int64_t j = 0; j < oh; j++)
        sr1d_line(out.data() + (size_t)j * ow, ox0, ow, irr, ext.data());
    std::vector<T> col((size_t)oh);
    for (int64_t i = 0; i < ow; i++) {
        for (int64_t j = 0; j < oh; j++) col[j] = out[(size_t)j * ow + i];
        sr1d_line(col.data(), oy0, oh, irr, ext.data());
        for (int64_t j = 0; j < oh; j++) out[(size_t)j * ow + i] = col[j];
    }
}

// ---- tile decode ----

static void decode_tile(const MainHdr& m, const TileData& td, int tidx,
                        int64_t ntx, int32_t* out, int64_t out_w,
                        int64_t out_h) {
    int64_t p = tidx % ntx, q = tidx / ntx;
    int64_t tx0 = std::max(m.xto + p * m.xts, m.xo);
    int64_t ty0 = std::max(m.yto + q * m.yts, m.yo);
    int64_t tx1 = std::min(m.xto + (p + 1) * m.xts, m.xs);
    int64_t ty1 = std::min(m.yto + (q + 1) * m.yts, m.ys);
    if (tx1 <= tx0 || ty1 <= ty0) return;

    // per-tile header overrides were collected during the tile-part
    // scan; decode_j2k_impl passes them via the MainHdr copy in `m`
    int scod = m.scod, prog = m.prog, layers = m.layers, mct = m.mct;

    std::vector<TileCompT> tcs((size_t)m.csiz);
    for (int c = 0; c < m.csiz; c++) {
        const CodStyle& cs = m.has_coc[c] ? m.coc[c] : m.cod;
        const QuantInfo& qi = m.has_qcc[c] ? m.qcc[c] : m.qcd;
        if (cs.transform == 1 && qi.style != 0) throw Err();
        build_tilecomp(tcs[c], m, c, cs, qi, tx0, ty0, tx1, ty1);
    }

    std::vector<PktRef> seq;
    packet_sequence(m, prog, layers, tcs, tx0, ty0, seq);
    TileStream ts{td.data.data(), td.data.size(), 0};
    for (auto& pk : seq) {
        ResT& res = tcs[pk.c].res[pk.r];
        if (res.npw * res.nph == 0) continue;
        read_packet(ts, res, pk.p, pk.l,
                    scod, tcs[pk.c].cs.cbstyle);
    }

    // Tier-1 + dequant + IDWT per component
    std::vector<std::vector<int32_t>> iplanes;
    std::vector<std::vector<double>> fplanes;
    T1 t1;
    for (int c = 0; c < m.csiz; c++) {
        TileCompT& tc = tcs[c];
        bool irr = tc.cs.transform == 0;
        int precb = m.prec[c];
        for (auto& res : tc.res) {
            for (size_t bi = 0; bi < res.bands.size(); bi++) {
                BandT& b = res.bands[bi];
                int bw = std::max(b.x1 - b.x0, 0);
                int mb = tc.qi.guard + b.eps - 1;
                if (mb < 0 || mb > 37) throw Err();
                double delta = 1.0;
                if (irr) {
                    int rb = precb + b.gain;
                    delta = std::pow(2.0, rb - b.eps)
                            * (1.0 + b.mant / 2048.0);
                }
                for (auto& pbs : res.precincts)
                    for (auto& cb : pbs[bi].cbs) {
                        t1_decode(t1, cb, b.orient, mb, tc.cs.cbstyle);
                        int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
                        for (int y = 0; y < h; y++)
                            for (int x = 0; x < w; x++) {
                                size_t si = (size_t)y * w + x;
                                int64_t v = t1.mag[si];
                                if (t1.sgn[si]) v = -v;
                                size_t di = (size_t)(cb.y0 - b.y0 + y)
                                            * bw + (cb.x0 - b.x0 + x);
                                if (irr) b.fcoef[di] = v * delta;
                                else b.icoef[di] = (int32_t)v;
                            }
                    }
            }
        }
        int nl = tc.cs.nl;
        if (irr) {
            std::vector<double> cur = tc.res[0].bands[0].fcoef;
            int curw = std::max(tc.res[0].x1 - tc.res[0].x0, 0);
            int curh = std::max(tc.res[0].y1 - tc.res[0].y0, 0);
            for (int r = 1; r <= nl; r++) {
                ResT& res = tc.res[r];
                std::vector<double> nxt;
                idwt_level(cur, curw, curh,
                           res.bands[0].fcoef,
                           std::max(res.bands[0].x1 - res.bands[0].x0, 0),
                           res.bands[1].fcoef,
                           std::max(res.bands[1].x1 - res.bands[1].x0, 0),
                           res.bands[2].fcoef,
                           std::max(res.bands[2].x1 - res.bands[2].x0, 0),
                           res.x0, res.y0, res.x1, res.y1, true, nxt);
                cur = std::move(nxt);
                curw = res.x1 - res.x0;
                curh = res.y1 - res.y0;
            }
            fplanes.push_back(std::move(cur));
            iplanes.emplace_back();
        } else {
            std::vector<int32_t> cur = tc.res[0].bands[0].icoef;
            int curw = std::max(tc.res[0].x1 - tc.res[0].x0, 0);
            int curh = std::max(tc.res[0].y1 - tc.res[0].y0, 0);
            for (int r = 1; r <= nl; r++) {
                ResT& res = tc.res[r];
                std::vector<int32_t> nxt;
                idwt_level(cur, curw, curh,
                           res.bands[0].icoef,
                           std::max(res.bands[0].x1 - res.bands[0].x0, 0),
                           res.bands[1].icoef,
                           std::max(res.bands[1].x1 - res.bands[1].x0, 0),
                           res.bands[2].icoef,
                           std::max(res.bands[2].x1 - res.bands[2].x0, 0),
                           res.x0, res.y0, res.x1, res.y1, false, nxt);
                cur = std::move(nxt);
                curw = res.x1 - res.x0;
                curh = res.y1 - res.y0;
            }
            iplanes.push_back(std::move(cur));
            fplanes.emplace_back();
        }
        // free coefficient storage early
        for (auto& res : tc.res)
            for (auto& b : res.bands) {
                b.icoef.clear(); b.icoef.shrink_to_fit();
                b.fcoef.clear(); b.fcoef.shrink_to_fit();
            }
    }

    int64_t tw = tx1 - tx0, th = ty1 - ty0;
    bool rev = tcs[0].cs.transform == 1;
    // multi-component transform on the first three components.
    // T.800 requires components 0..2 to share the wavelet transform
    // when MCT is signalled; a crafted stream mixing them via COC
    // would otherwise index the wrong (empty) plane storage below.
    if (mct && m.csiz >= 3) {
        for (int c = 1; c < 3; c++)
            if (tcs[c].cs.transform != tcs[0].cs.transform) throw Err();
        size_t npx = (size_t)tw * th;
        if (rev) {
            for (size_t i = 0; i < npx; i++) {
                int64_t y_ = iplanes[0][i], cb_ = iplanes[1][i],
                        cr_ = iplanes[2][i];
                int64_t g = y_ - ((cb_ + cr_) >> 2);
                iplanes[0][i] = (int32_t)(cr_ + g);
                iplanes[1][i] = (int32_t)g;
                iplanes[2][i] = (int32_t)(cb_ + g);
            }
        } else {
            for (size_t i = 0; i < npx; i++) {
                double y_ = fplanes[0][i], cb_ = fplanes[1][i],
                       cr_ = fplanes[2][i];
                fplanes[0][i] = y_ + 1.402 * cr_;
                fplanes[1][i] = y_ - 0.344136 * cb_ - 0.714136 * cr_;
                fplanes[2][i] = y_ + 1.772 * cb_;
            }
        }
    }

    for (int c = 0; c < m.csiz; c++) {
        int precb = m.prec[c];
        bool sgnd = m.sgnd[c] != 0;
        bool irr = tcs[c].cs.transform == 0;
        int64_t lo = sgnd ? -(1LL << (precb - 1)) : 0;
        int64_t hi = sgnd ? (1LL << (precb - 1)) - 1 : (1LL << precb) - 1;
        int64_t shift = sgnd ? 0 : (1LL << (precb - 1));
        for (int64_t y = 0; y < th; y++)
            for (int64_t x = 0; x < tw; x++) {
                int64_t v;
                if (irr) {
                    double f = fplanes[c][(size_t)y * tw + x];
                    v = (int64_t)llround(f);
                } else {
                    v = iplanes[c][(size_t)y * tw + x];
                }
                v += shift;
                if (v < lo) v = lo;
                if (v > hi) v = hi;
                size_t oidx = ((size_t)(ty0 - m.yo + y) * out_w
                               + (tx0 - m.xo + x)) * m.csiz + c;
                out[oidx] = (int32_t)v;
            }
    }
    (void)out_h;
}

// ---- top level ----

struct TileOverride {
    bool has_cod = false, has_qcd = false;
    int scod = 0, prog = 0, layers = 1, mct = 0;
    CodStyle cod;
    QuantInfo qcd;
    std::vector<CodStyle> coc;
    std::vector<uint8_t> has_coc;
    std::vector<QuantInfo> qcc;
    std::vector<uint8_t> has_qcc;
};

static const uint8_t* find_codestream(const uint8_t* buf, size_t len,
                                      size_t* cs_len) {
    if (len >= 4 && buf[0] == 0xFF && buf[1] == 0x4F && buf[2] == 0xFF
        && buf[3] == 0x51) {
        *cs_len = len;
        return buf;
    }
    static const uint8_t jp2sig[12] = {0, 0, 0, 0x0C, 'j', 'P', ' ', ' ',
                                       0x0D, 0x0A, 0x87, 0x0A};
    if (len >= 12 && memcmp(buf, jp2sig, 12) == 0) {
        size_t pos = 12;
        while (pos + 8 <= len) {
            uint64_t lbox = ((uint64_t)buf[pos] << 24)
                          | ((uint64_t)buf[pos+1] << 16)
                          | ((uint64_t)buf[pos+2] << 8) | buf[pos+3];
            const uint8_t* tbox = buf + pos + 4;
            size_t hdr = 8;
            if (lbox == 1) {
                if (pos + 16 > len) throw Err();
                lbox = 0;
                for (int k = 0; k < 8; k++)
                    lbox = (lbox << 8) | buf[pos + 8 + k];
                hdr = 16;
            }
            if (memcmp(tbox, "jp2c", 4) == 0) {
                size_t end = lbox == 0 ? len : pos + (size_t)lbox;
                if (end > len || pos + hdr > end) throw Err();
                *cs_len = end - pos - hdr;
                return buf + pos + hdr;
            }
            if (lbox == 0) break;
            if (pos + lbox <= pos) throw Err();
            pos += (size_t)lbox;
        }
        throw Err();
    }
    // scan for an embedded SOC+SIZ
    for (size_t i = 0; i + 4 <= len; i++)
        if (buf[i] == 0xFF && buf[i+1] == 0x4F && buf[i+2] == 0xFF
            && buf[i+3] == 0x51) {
            *cs_len = len - i;
            return buf + i;
        }
    throw Err();
}

static int decode_j2k_impl(const uint8_t* inbuf, size_t inlen,
                           int32_t* out, int64_t cap,
                           int* w_out, int* h_out, int* nc_out,
                           int* prec_out) {
    build_luts();
    size_t len = 0;
    const uint8_t* buf = find_codestream(inbuf, inlen, &len);
    Rd r{buf, len, 0};
    if (r.u16() != M_SOC) throw Err();
    MainHdr m;
    bool dummyb = false;
    int dummyi = 0;
    uint16_t mk = parse_headers(r, len, m, -1, nullptr, nullptr,
                                &dummyi, &dummyi, &dummyi, &dummyi,
                                &dummyb, &dummyb, nullptr, nullptr,
                                nullptr, nullptr);
    if (m.csiz == 0) throw Err();
    if (m.cod.prec.empty() || m.qcd.steps.empty()) throw Err();

    int64_t w = m.xs - m.xo, h = m.ys - m.yo;
    if (w <= 0 || h <= 0 || w > (1 << 20) || h > (1 << 20)) throw Err();
    if (w * h > (1LL << 28) || w * h * m.csiz > (1LL << 29)) throw Err();
    *w_out = (int)w;
    *h_out = (int)h;
    *nc_out = m.csiz;
    int maxprec = 0;
    for (int c = 0; c < m.csiz; c++) maxprec = std::max(maxprec, m.prec[c]);
    *prec_out = maxprec;
    if (w * h * m.csiz > cap) return -6;

    int64_t ntx = ceil_div_i64(m.xs - m.xto, m.xts);
    int64_t nty = ceil_div_i64(m.ys - m.yto, m.yts);
    if (ntx * nty > (1 << 20)) throw Err();

    std::vector<TileData> tiles((size_t)(ntx * nty));
    std::vector<TileOverride> ovr((size_t)(ntx * nty));
    std::vector<uint8_t> seen((size_t)(ntx * nty), 0);

    while (mk != M_EOC && r.pos < len) {
        // SOT
        if (r.u16() != M_SOT) throw Err();
        uint16_t lsot = r.u16();
        if (lsot != 10) throw Err();
        uint16_t isot = r.u16();
        uint32_t psot = r.u32();
        r.u8();                                    // TPsot
        r.u8();                                    // TNsot
        if (isot >= ntx * nty) throw Err();
        size_t tp_start = r.pos - 12;
        size_t tp_end = psot ? tp_start + psot : len;
        if (tp_end > len || tp_end < r.pos) throw Err();
        TileOverride& o = ovr[isot];
        if (!seen[isot]) {
            o.coc.resize(m.csiz);
            o.has_coc.assign(m.csiz, 0);
            o.qcc.resize(m.csiz);
            o.has_qcc.assign(m.csiz, 0);
            seen[isot] = 1;
        }
        uint16_t hmk = parse_headers(r, tp_end, m, isot, &o.cod, &o.qcd,
                                     &o.scod, &o.prog, &o.layers, &o.mct,
                                     &o.has_cod, &o.has_qcd, &o.coc,
                                     &o.has_coc, &o.qcc, &o.has_qcc);
        if (hmk != M_SOD) throw Err();
        tiles[isot].data.insert(tiles[isot].data.end(), buf + r.pos,
                                buf + tp_end);
        r.pos = tp_end;
        if (r.pos + 2 <= len) {
            uint16_t nxt = ((uint16_t)buf[r.pos] << 8) | buf[r.pos + 1];
            if (nxt == M_EOC) break;
            if (nxt != M_SOT) throw Err();
        } else {
            break;
        }
    }

    // Python-golden semantics: zero-fill regions whose tiles carry no
    // data and reject streams with no tile data at all — the caller's
    // output buffer is np.empty, so skipping a tile without this
    // would surface uninitialized heap bytes as pixels.
    bool any_tile = false;
    for (int64_t t = 0; t < ntx * nty; t++)
        if (!tiles[t].data.empty()) { any_tile = true; break; }
    if (!any_tile) throw Err();
    memset(out, 0, (size_t)(w * h * m.csiz) * sizeof(int32_t));

    for (int64_t t = 0; t < ntx * nty; t++) {
        if (tiles[t].data.empty()) continue;
        MainHdr mt = m;
        TileOverride& o = ovr[t];
        if (o.has_cod) {
            mt.scod = o.scod; mt.prog = o.prog;
            mt.layers = o.layers; mt.mct = o.mct;
            mt.cod = o.cod;
        }
        if (o.has_qcd) mt.qcd = o.qcd;
        for (int c = 0; c < m.csiz; c++) {
            if (!o.has_coc.empty() && o.has_coc[c]) {
                mt.coc[c] = o.coc[c];
                mt.has_coc[c] = 1;
            }
            if (!o.has_qcc.empty() && o.has_qcc[c]) {
                mt.qcc[c] = o.qcc[c];
                mt.has_qcc[c] = 1;
            }
        }
        decode_tile(mt, tiles[t], (int)t, ntx, out, w, h);
    }
    return 0;
}

}  // namespace j2k

extern "C" {

// JPEG 2000 Part-1 decode (DICOM .4.90/.91): raw codestream or JP2.
// Output int32 interleaved (h, w, ncomp), DC-shifted/clipped to the
// component precision (signed components carry their sign). Returns
// 0 ok, -6 capacity too small (retry with a larger buffer), -1 on any
// malformed/unsupported stream.
int mia_j2k_decode(const uint8_t* buf, uint64_t len, int32_t* out,
                   int64_t cap, int* w, int* h, int* nc, int* prec) {
    try {
        return j2k::decode_j2k_impl(buf, (size_t)len, out, cap,
                                    w, h, nc, prec);
    } catch (j2k::Err&) {
        return -1;
    } catch (std::bad_alloc&) {
        return -2;
    } catch (...) {
        return -3;
    }
}

}  // extern "C"
