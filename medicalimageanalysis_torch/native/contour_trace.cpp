// Outer-border tracing of 2-D binary masks: Suzuki & Abe's border
// following (CVGIP 30, 1985) with the semantics of OpenCV's
// findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE), so a mask gives the
// same contours, point for point and in the same list order, without
// OpenCV:
//
//   - the slice is framed by one row / column of zeros, so foreground on
//     the image's border is traced like any other;
//   - pixels are 8-connected foreground (any nonzero value);
//   - a raster scan starts an outer border at each 0 -> 1 step, unless
//     the last traced border pixel met on the row so far is a left-side
//     mark (an island inside a hole of a traced component: skipped);
//   - the border is followed clockwise in image coordinates (y down),
//     marking its pixels 2 on the left side and -126 on the right side;
//   - CHAIN_APPROX_SIMPLE keeps a point where the chain code changes;
//   - the contours come out in the reverse of the order they were found.
//
// A stack of slices is traced in one call: mia_trace_run returns a
// handle with the counts, mia_trace_fetch copies the results out and
// frees it.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

struct Contour {
    int64_t start;   // first (x, y) pair in the slice's point list
    int64_t count;
};

struct SliceResult {
    std::vector<int32_t> xy;        // (x, y) pairs, unframed coordinates
    std::vector<Contour> contours;  // in the order they were found
};

// Follow the outer border that starts at i0 (the framed pixel (x0, y0)),
// appending the compressed points. deltas: the 8 neighbour offsets of the
// chain codes, twice over.
void follow_border(int8_t* i0, const int* deltas, int x0, int y0,
                   SliceResult& out) {
    const int8_t kLeft = 2;
    const int8_t kRight = (int8_t)(2 | -128);
    int64_t start = (int64_t)out.xy.size() / 2;
    int x = x0 - 1;
    int y = y0 - 1;

    int s = 4;
    int s_end = 4;
    int8_t* i1;
    do {
        s = (s - 1) & 7;
        i1 = i0 + deltas[s];
    } while (*i1 == 0 && s != s_end);

    if (s == s_end) {   // a single pixel
        *i0 = kRight;
        out.xy.push_back(x);
        out.xy.push_back(y);
    } else {
        int8_t* i3 = i0;
        int8_t* i4 = nullptr;
        int prev_s = s ^ 4;
        for (;;) {
            s_end = s;
            while (s < 15) {
                i4 = i3 + deltas[++s];
                if (*i4 != 0) break;
            }
            s &= 7;
            if ((unsigned)(s - 1) < (unsigned)s_end)
                *i3 = kRight;
            else if (*i3 == 1)
                *i3 = kLeft;
            if (s != prev_s) {
                out.xy.push_back(x);
                out.xy.push_back(y);
                prev_s = s;
            }
            x += kDx[s];
            y += kDy[s];
            if (i4 == i0 && i3 == i1) break;
            i3 = i4;
            s = (s + 4) & 7;
        }
    }
    out.contours.push_back({start, (int64_t)out.xy.size() / 2 - start});
}

// Trace one (h, w) slice; frame: scratch of (h + 2) * (w + 2) bytes.
void trace_slice(const uint8_t* src, int h, int w, std::vector<int8_t>& frame,
                 SliceResult& out) {
    const int step = w + 2;
    std::memset(frame.data(), 0, frame.size());
    for (int y = 0; y < h; y++) {
        const uint8_t* row = src + (int64_t)y * w;
        int8_t* dst = frame.data() + (int64_t)(y + 1) * step + 1;
        for (int x = 0; x < w; x++) dst[x] = row[x] != 0;
    }
    int deltas[16] = {1, -step + 1, -step, -step - 1,
                      -1, step - 1, step, step + 1};
    std::memcpy(deltas + 8, deltas, 8 * sizeof(int));

    const int width = step - 1;     // the scan leaves out the last column
    const int height = h + 1;       // ... and the last row
    for (int y = 1; y < height; y++) {
        int8_t* img = frame.data() + (int64_t)y * step;
        int lnbd = 0;               // last border pixel met on this row
        int prev = 0;
        for (int x = 1; x < width; x++) {
            int p;
            for (; x < width && (p = img[x]) == prev; x++) {}
            if (x >= width) break;
            bool outer = prev == 0 && p == 1;
            // a hole's start (p == 0 after a foreground pixel) is never
            // traced under RETR_EXTERNAL, nor is an island inside one
            if (outer && img[lnbd] <= 0) {
                follow_border(img + x, deltas, x, y, out);
                lnbd = x;
                prev = img[x];
                continue;
            }
            if (!outer && p == 0 && prev >= 1 && (prev & -2)) lnbd = x - 1;
            prev = p;
            if (prev & -2) lnbd = x;
        }
    }
}

struct TraceState {
    std::vector<SliceResult> slices;
};

}  // namespace

extern "C" {

// Trace each of n_slices (h, w) uint8 slices (C order, contiguous).
// Returns a handle (nullptr on allocation failure) and the totals.
void* mia_trace_run(const uint8_t* stack, int64_t n_slices, int64_t h,
                    int64_t w, int64_t* n_contours, int64_t* n_points) {
    *n_contours = 0;
    *n_points = 0;
    TraceState* st = new (std::nothrow) TraceState();
    if (st == nullptr) return nullptr;
    try {
        st->slices.resize((size_t)n_slices);
        std::vector<int8_t> frame((size_t)(h + 2) * (size_t)(w + 2));
        for (int64_t k = 0; k < n_slices; k++) {
            trace_slice(stack + k * h * w, (int)h, (int)w, frame,
                        st->slices[(size_t)k]);
            *n_contours += (int64_t)st->slices[(size_t)k].contours.size();
            *n_points += (int64_t)st->slices[(size_t)k].xy.size() / 2;
        }
    } catch (const std::bad_alloc&) {
        delete st;
        return nullptr;
    }
    return st;
}

// Copy the results of mia_trace_run out and free the handle:
// per_slice[n_slices] contours a slice, lengths[n_contours] points a
// contour (each slice's in OpenCV's order, the reverse of discovery),
// xy[2 * n_points] the points in the same order.
void mia_trace_fetch(void* handle, int64_t* per_slice, int64_t* lengths,
                     int32_t* xy) {
    TraceState* st = static_cast<TraceState*>(handle);
    int64_t c = 0;
    int64_t p = 0;
    for (size_t k = 0; k < st->slices.size(); k++) {
        const SliceResult& r = st->slices[k];
        per_slice[k] = (int64_t)r.contours.size();
        for (size_t j = r.contours.size(); j-- > 0;) {
            const Contour& ct = r.contours[j];
            lengths[c++] = ct.count;
            std::memcpy(xy + 2 * p, r.xy.data() + 2 * ct.start,
                        (size_t)ct.count * 2 * sizeof(int32_t));
            p += ct.count;
        }
    }
    delete st;
}

}  // extern "C"
