// Exact trilinear warp for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces medicalimageanalysis_tpu/ops/pallas_warp.py::_warp_kernel in its
// `coords` and `disp` modes (each with and without the fused coordinate
// gradients) and its `affine` and `affine_shear` modes. It computes what
// the TPU kernel computes: an exact 8-tap trilinear sample of B volumes
// (Z, Y, X) per output voxel, taps clamped to the edge, samples outside
// [0, dim-1] set to `background`; with kGrad also d/d(cz, cy, cx) from the
// same taps, 0 outside. The modes differ in where a voxel's sample
// coordinate comes from:
//   kCoords  three (Zo, Yo, Xo) coordinate volumes (registration);
//   kAffine  12 coefficients over the output index (reslice);
//   kDisp    the output index plus a planar (3, Zo, Yo, Xo) voxel
//            displacement, rows (x, y, z), shared by the B volumes
//            (demons, DVF inversion and composition, B-spline, deformed
//            reslice). One f32 add per axis, so the twin stays bit-equal;
//   kAffineShear  kAffine's coordinates, taps and fractions over the
//            logical (Z, Y, X), but the taps are read from the staircase-
//            sheared copy V2 (Z2, Y2, X) of the volume,
//            V2[z + oz - stair(kz, x), y + oy - stair(ky, x), x] = V[z, y, x],
//            stair(k, x) = floor(k*x + 0.5) in float32 (ops/warp._stair):
//            each x tap reads its own rows. The 8 values combine in
//            kAffine's order, so on an exact V2 the result is bit-equal to
//            kAffine on V (the oblique entry, ops/warp.affine_warp_oblique).
//            The TPU needed the shear to keep a tile's rows inside its
//            VMEM slab; here the rows are read from global memory, and the
//            mode costs V2's build (PERF.md).
//
// What bounds it. coords and disp: a gather. Each output voxel reads 8
// scattered floats per volume and writes 1 (4 with gradients), so the
// kernel is bound by device memory latency and L2 traffic, not arithmetic.
// The TPU kernel's slab, window and DMA machinery existed because a TPU
// core cannot gather from HBM; on Hopper a thread reads global memory
// directly. The design, each step measured on the card (PERF.md §6):
//   - a block is a tile of 32 x 8 threads in (x, y) that walks up to 4
//     slices in z, so the output index comes from blockIdx / threadIdx
//     with no division, and the y and z neighbours of a tile reuse its
//     input rows from the SM's L1;
//   - B (1-4) is a template parameter, so a voxel issues all B x 8 tap
//     loads before its arithmetic; the wrapper splits a larger B into
//     launches of at most 4. Offsets inside a volume are int32 (the
//     wrapper refuses volumes of 2^31 voxels or more), with an int64
//     base per volume;
//   - in coords and disp a thread takes 2 neighbouring x voxels
//     (width()): the coordinate or displacement rows are read and every
//     output written as float2 where Xo is even and the rows are 8-byte
//     aligned, else one float at a time (the same bits).
// A box of each tile's taps copied to shared memory (cp.async) lost to
// L1 at every budget tried, and 4 voxels a thread (float4) lost to 2.
// NVIDIA H100 80GB HBM3 at 700 W, (128, 512, 512): disp B=4 0.605 ms, 73 %
// of its byte bound; coords B=1 with gradients 0.376 ms, 85 %.
//
// affine and affine_shear read no coordinates. What bounds them, read on
// the card (PERF.md §6, scripts/warp_steps.py):
//   - axis_kernel, for a map whose six off-diagonal coefficients are 0
//     (the wrapper's choice, ops/warp.affine_path: gamma's fine grid, a
//     dose onto the CT, an identity or shifted reslice). Then cx depends
//     on the column only, cy on the row, cz on the slice, and each axis's
//     taps, fractions and insideness are found once per column, row and
//     slice of a tile (axis_tap). Upsampling a 2.8 M-voxel dose 30x was
//     bound by its stores: rows of an odd Xo start off 16-byte boundaries,
//     and 32 scalar stores a warp took twice a fill of the same output.
//     So a tile is 128 columns x 8 rows x up to 16 slices, and each warp
//     writes its row segment through shared memory as aligned float4s
//     with a scalar head and tail (store_segment). Where the input rows a
//     tile reaches are few (upsampling), their x-lerps are staged in
//     shared memory, 4 consecutive columns a lane, and each voxel takes
//     the y and z lerps only, in the twin's order (x, then y, then z):
//     the same bits. Else lanes take columns 32 apart and lerp in z two
//     y-lerped planes, each read once for the slices that share it (4
//     loads a voxel at 1:1);
//   - affine_kernel, for every other map, one voxel a thread. At 32
//     registers (more cost a 1:1 map 8 %: the gather needs every resident
//     warp), and with kZsep, a rotation about z, the x and y taps found
//     once a thread for the slices it walks. affine_shear was bound by
//     conversions (about 24 a voxel at 16 a clock per SM): its rows of V2
//     are formed in integers, hoisted with the taps where kZsep.
// NVIDIA H100 80GB HBM3 at 700 W: gamma's fine grids (323 x 509 x 509 and
// 423 x 671 x 671 from 103 x 165 x 165) 0.152 / 0.362 ms, 68 / 64 % of
// their byte bound; the shear at 30 and 45 degrees about z 0.148 ms, 54 %;
// the near-identity map at (128, 512, 512) 0.148 ms, 54 %. Every map's
// share is in PERF.md §6.
//
// Exactness: the plain PyTorch twin (ops/warp.py) rounds every operation
// to float32 in this file's order. The file is compiled with
// --fmad=false so nvcc does not contract a*(1-f) + b*f or the affine
// coefficient sums into FMAs; kernel and twin are then bit-equal.
// Coordinates are clamped in float before the float->int cast (a cast of
// NaN or 1e30 is undefined), and no load goes through an unclamped index.
// With the off-diagonals exactly 0, ((c0*x + c1*y) + c2*z) + c3 equals
// c0*x + c3 but for the sign of a zero, which changes neither the taps
// nor the fractions.
//
// Plain C interface, loaded with ctypes (ops/_build.py); each entry point
// launches on the caller's stream and returns a cudaError_t.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

enum class Mode { kCoords, kAffine, kDisp, kAffineShear };

constexpr int kTx = 32;              // threads along x (one warp)
constexpr int kTy = 8;               // warps along y
constexpr int kThreads = kTx * kTy;  // 256

struct Coef {
  float c[12];  // row-major output (x, y, z, 1) -> input (x, y, z)
};

struct Shear {   // kAffineShear: the staircase of V2 (Z2, Y2, X)
  float ky, kz, oy, oz;
  int Z2, Y2;
};

// (int)v for a float holding an integer of magnitude below 2^22, in two
// full-rate instructions and not the conversion unit: the integer lands
// in the low mantissa bits of v + 1.5 * 2^23
__device__ __forceinline__ int small_int(float v) {
  return __float_as_int(v + 12582912.0f) - 0x4B400000;
}

// The shift of V2's rows at a column of float value x (an integer):
// o - stair(k, x), stair(k, x) = floor(k*x + 0.5) in float32. The row of
// V2 holding row r of V there is r + o - stair, clamped to [0, n-1]; every
// term is an integer below 2^22 (the entry checks o and k), so the float
// sum of the twin and this integer sum are the same.
__device__ __forceinline__ int stair_shift(float o, float k, float x) {
  return small_int(o - floorf(k * x + 0.5f));
}

__device__ __forceinline__ int clamp_row(int r, int n) {
  return min(max(r, 0), n - 1);
}

// kV (1 or 2) neighbouring floats of a row: one float2 access where the
// row is 8-byte aligned (`vec`) and whole, else one float at a time
template <int kV>
__device__ __forceinline__ void loadv(const float* __restrict__ p, bool vec,
                                      int nv, float (&v)[kV]) {
  if constexpr (kV == 2) {
    if (vec && nv == 2) {
      const float2 a = *reinterpret_cast<const float2*>(p);
      v[0] = a.x;
      v[1] = a.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) v[j] = j < nv ? p[j] : 0.f;
}

template <int kV>
__device__ __forceinline__ void storev(float* __restrict__ p, bool vec,
                                       int nv, const float (&v)[kV]) {
  if constexpr (kV == 2) {
    if (vec && nv == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kV; ++j)
    if (j < nv) p[j] = v[j];
}

// One axis of a sample at coordinate v on an axis of n voxels: inside
// [0, n-1] or not, its fraction and its clamped taps (clamped in float,
// then cast: fmaxf maps NaN to 0, and a cast of NaN or 1e30 is undefined).
struct AxisPos {
  bool inside;
  float f;
  float i0c;   // i0 as a float
  int i0, i1;
};

__device__ __forceinline__ AxisPos axis_pos(float v, int n) {
  const float vmax = (float)(n - 1);
  AxisPos a;
  a.inside = v >= 0.f && v <= vmax;
  const float v0 = floorf(v);
  a.f = v - v0;
  a.i0c = fminf(fmaxf(v0, 0.f), vmax);
  a.i0 = (int)a.i0c;
  a.i1 = min(a.i0 + 1, n - 1);
  return a;
}

// Where a sample lands on the three axes.
struct Tap {
  bool inside;
  float fx, fy, fz;
  int x0, x1, y0, y1, z0, z1;
};

__device__ __forceinline__ Tap locate(float x, float y, float z, int X,
                                      int Y, int Z) {
  const AxisPos px = axis_pos(x, X), py = axis_pos(y, Y),
                pz = axis_pos(z, Z);
  return Tap{px.inside && py.inside && pz.inside, px.f, py.f, pz.f,
             px.i0, px.i1, py.i0, py.i1, pz.i0, pz.i1};
}

// The 7 lerps of one volume's 8 taps (c000, c001, c010, c011, c100, c101,
// c110, c111: z, y, x bits), in the twin's order
__device__ __forceinline__ float trilerp(const float (&c)[8], float fx,
                                         float fy, float fz) {
  const float gfx = 1.f - fx, gfy = 1.f - fy, gfz = 1.f - fz;
  const float c00 = c[0] * gfx + c[1] * fx;
  const float c01 = c[2] * gfx + c[3] * fx;
  const float c10 = c[4] * gfx + c[5] * fx;
  const float c11 = c[6] * gfx + c[7] * fx;
  const float c0 = c00 * gfy + c01 * fy;
  const float c1 = c10 * gfy + c11 * fy;
  return c0 * gfz + c1 * fz;
}

// coords and disp. The grid: x tiles of kTx * kV, y tiles of kTy, and z
// walked zt slices at a time from blockIdx.z (grid-stride over z beyond
// 65535 z blocks).
template <Mode M, bool kGrad, int kB, int kV>
__global__ void __launch_bounds__(kThreads)
    warp_kernel(const float* __restrict__ vol, int64_t vstride, int Z,
                int Y, int X, const float* __restrict__ czp,
                const float* __restrict__ cyp,
                const float* __restrict__ cxp,
                const float* __restrict__ dsp, int Zo, int Yo, int Xo,
                int zt, float bg, bool vec, float* __restrict__ out,
                float* __restrict__ gzp, float* __restrict__ gyp,
                float* __restrict__ gxp) {
  const int64_t n = (int64_t)Zo * Yo * Xo;
  const int xs = (blockIdx.x * kTx + threadIdx.x) * kV;
  const int yo = blockIdx.y * kTy + threadIdx.y;
  const int nv = yo < Yo ? max(0, min(kV, Xo - xs)) : 0;
  if (nv == 0) return;
  const float gyf = (float)yo;
  const int zstep = gridDim.z * zt;
  for (int zb = blockIdx.z * zt; zb < Zo; zb += zstep) {
    const int zend = min(zb + zt, Zo);
    for (int zo = zb; zo < zend; ++zo) {
      const int o = (zo * Yo + yo) * Xo + xs;   // < n < 2^31
      const float gzf = (float)zo;
      float cx[kV], cy[kV], cz[kV];
      if constexpr (M == Mode::kCoords) {
        loadv(cxp + o, vec, nv, cx);
        loadv(cyp + o, vec, nv, cy);
        loadv(czp + o, vec, nv, cz);
      } else {
        float dx[kV], dy[kV], dz[kV];
        loadv(dsp + o, vec, nv, dx);
        loadv(dsp + n + o, vec, nv, dy);
        loadv(dsp + 2 * n + o, vec, nv, dz);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          cx[j] = (float)(xs + j) + dx[j];
          cy[j] = gyf + dy[j];
          cz[j] = gzf + dz[j];
        }
      }
      float res[kB][kV];
      float rz[kGrad ? kB : 1][kV], ry[kGrad ? kB : 1][kV],
          rx[kGrad ? kB : 1][kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const Tap tp = locate(cx[j], cy[j], cz[j], X, Y, Z);
        if (!(j < nv && tp.inside)) {
#pragma unroll
          for (int b = 0; b < kB; ++b) {
            res[b][j] = bg;
            if constexpr (kGrad) {
              rz[b][j] = 0.f;
              ry[b][j] = 0.f;
              rx[b][j] = 0.f;
            }
          }
          continue;
        }
        const float fx = tp.fx, fy = tp.fy, fz = tp.fz;
        const float gfx = 1.f - fx;
        const float gfy = 1.f - fy;
        const float gfz = 1.f - fz;
        const int x0 = tp.x0, x1 = tp.x1;
        // element offsets of the 8 taps, in the order c000, c001, c010,
        // c011, c100, c101, c110, c111 (z, y, x bits)
        const int r00 = (tp.z0 * Y + tp.y0) * X;
        const int r01 = (tp.z0 * Y + tp.y1) * X;
        const int r10 = (tp.z1 * Y + tp.y0) * X;
        const int r11 = (tp.z1 * Y + tp.y1) * X;
        const int t[8] = {r00 + x0, r00 + x1, r01 + x0, r01 + x1,
                          r10 + x0, r10 + x1, r11 + x0, r11 + x1};
        // all B x 8 loads in flight before the arithmetic
        float c[kB][8];
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          const float* v = vol + b * vstride;
#pragma unroll
          for (int k = 0; k < 8; ++k) c[b][k] = v[t[k]];
        }
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          const float c000 = c[b][0], c001 = c[b][1];
          const float c010 = c[b][2], c011 = c[b][3];
          const float c100 = c[b][4], c101 = c[b][5];
          const float c110 = c[b][6], c111 = c[b][7];
          const float c00 = c000 * gfx + c001 * fx;
          const float c01 = c010 * gfx + c011 * fx;
          const float c10 = c100 * gfx + c101 * fx;
          const float c11 = c110 * gfx + c111 * fx;
          const float c0 = c00 * gfy + c01 * fy;
          const float c1 = c10 * gfy + c11 * fy;
          res[b][j] = c0 * gfz + c1 * fz;
          if constexpr (kGrad) {
            rx[b][j] = ((c001 - c000) * gfy + (c011 - c010) * fy) * gfz +
                       ((c101 - c100) * gfy + (c111 - c110) * fy) * fz;
            ry[b][j] = (c01 - c00) * gfz + (c11 - c10) * fz;
            rz[b][j] = c1 - c0;
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int64_t ob = b * n + o;
        storev(out + ob, vec, nv, res[b]);
        if constexpr (kGrad) {
          storev(gzp + ob, vec, nv, rz[b]);
          storev(gyp + ob, vec, nv, ry[b]);
          storev(gxp + ob, vec, nv, rx[b]);
        }
      }
    }
  }
}

// The y and x part of a voxel's 8 tap offsets (rows y0 and y1 at columns
// x0 and x1, in c00.. order) and, sheared, each x tap's z shift: each x
// tap reads its own rows of V2, one stair per x tap and axis, the rest in
// integers.
template <Mode M>
__device__ __forceinline__ void row_taps(const AxisPos& px,
                                         const AxisPos& py, const Shear& sh,
                                         int X, int (&yx)[4], int& dza,
                                         int& dzb) {
  const int x0 = px.i0, x1 = px.i1;
  if constexpr (M == Mode::kAffineShear) {
    const float xa = px.i0c, xb = fminf(xa + 1.f, (float)(X - 1));
    dza = stair_shift(sh.oz, sh.kz, xa);
    dzb = stair_shift(sh.oz, sh.kz, xb);
    const int dya = stair_shift(sh.oy, sh.ky, xa);
    const int dyb = stair_shift(sh.oy, sh.ky, xb);
    yx[0] = clamp_row(py.i0 + dya, sh.Y2) * X + x0;
    yx[1] = clamp_row(py.i0 + dyb, sh.Y2) * X + x1;
    yx[2] = clamp_row(py.i1 + dya, sh.Y2) * X + x0;
    yx[3] = clamp_row(py.i1 + dyb, sh.Y2) * X + x1;
  } else {
    yx[0] = py.i0 * X + x0;
    yx[1] = py.i0 * X + x1;
    yx[2] = py.i1 * X + x0;
    yx[3] = py.i1 * X + x1;
  }
}

// affine and affine_shear at any map, one voxel a thread; the grid and
// the z walk are warp_kernel's. kZsep: c2 = c6 = 0 (a rotation about z:
// the display's, most reslices'), so cx and cy do not change along z and
// a thread finds its x and y taps, and affine_shear its rows of V2 in y
// and shifts in z, once for all the slices it walks. (c2*z is then +-0,
// and the sign of a zero coordinate changes neither taps nor fractions.)
template <Mode M, int kB, bool kZsep>
__global__ void __launch_bounds__(kThreads)
    affine_kernel(const float* __restrict__ vol, int64_t vstride, int Z,
                  int Y, int X, Coef coef, Shear sh, int Zo, int Yo,
                  int Xo, int zt, float bg, float* __restrict__ out) {
  const int64_t n = (int64_t)Zo * Yo * Xo;
  const int xo = blockIdx.x * kTx + threadIdx.x;
  const int yo = blockIdx.y * kTy + threadIdx.y;
  if (xo >= Xo || yo >= Yo) return;
  const float* c = coef.c;
  // ((c0*x + c1*y) + c2*z) + c3 per axis, the first sum once a thread
  const float gxf = (float)xo, gyf = (float)yo;
  const float sx = c[0] * gxf + c[1] * gyf;
  const float sy = c[4] * gxf + c[5] * gyf;
  const float sz = c[8] * gxf + c[9] * gyf;
  const int yxs = (M == Mode::kAffineShear ? sh.Y2 : Y) * X;   // a slice
  AxisPos px, py;
  int yx[4], dza = 0, dzb = 0;
  bool in_xy = false;
  if constexpr (kZsep) {
    px = axis_pos(sx + c[3], X);
    py = axis_pos(sy + c[7], Y);
    in_xy = px.inside && py.inside;
    if (in_xy) row_taps<M>(px, py, sh, X, yx, dza, dzb);
  }
  const int zstep = gridDim.z * zt;
  for (int zb = blockIdx.z * zt; zb < Zo; zb += zstep) {
    const int zend = min(zb + zt, Zo);
    for (int zo = zb; zo < zend; ++zo) {
      const float gzf = (float)zo;
      const int o = (zo * Yo + yo) * Xo + xo;   // < n < 2^31
      if constexpr (!kZsep) {
        px = axis_pos((sx + c[2] * gzf) + c[3], X);
        py = axis_pos((sy + c[6] * gzf) + c[7], Y);
        in_xy = px.inside && py.inside;
      }
      const AxisPos pz = axis_pos((sz + c[10] * gzf) + c[11], Z);
      if (!(in_xy && pz.inside)) {
#pragma unroll
        for (int b = 0; b < kB; ++b) out[b * n + o] = bg;
        continue;
      }
      if constexpr (!kZsep) row_taps<M>(px, py, sh, X, yx, dza, dzb);
      // element offsets of the 8 taps, in the order c000, c001, c010,
      // c011, c100, c101, c110, c111 (z, y, x bits)
      int za0, za1, zb0, zb1;
      if constexpr (M == Mode::kAffineShear) {
        za0 = clamp_row(pz.i0 + dza, sh.Z2) * yxs;
        za1 = clamp_row(pz.i1 + dza, sh.Z2) * yxs;
        zb0 = clamp_row(pz.i0 + dzb, sh.Z2) * yxs;
        zb1 = clamp_row(pz.i1 + dzb, sh.Z2) * yxs;
      } else {
        za0 = zb0 = pz.i0 * yxs;
        za1 = zb1 = pz.i1 * yxs;
      }
      const int t[8] = {za0 + yx[0], zb0 + yx[1], za0 + yx[2], zb0 + yx[3],
                        za1 + yx[0], zb1 + yx[1], za1 + yx[2], zb1 + yx[3]};
      // all B x 8 loads in flight before the arithmetic
      float v8[kB][8];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float* v = vol + b * vstride;
#pragma unroll
        for (int k = 0; k < 8; ++k) v8[b][k] = v[t[k]];
      }
#pragma unroll
      for (int b = 0; b < kB; ++b)
        out[b * n + o] = trilerp(v8[b], px.f, py.f, pz.f);
    }
  }
}

// ---------------------------------------------------------------------------
// axis_kernel: the affine mode at a map with zero off-diagonals
// ---------------------------------------------------------------------------
constexpr int kAxisV = 4;              // consecutive output columns a lane
constexpr int kAxisTx = kTx * kAxisV;  // output columns of a tile (128)
constexpr int kAxisTz = 16;            // output slices a tile walks at most
constexpr int kAxisRows = 80;          // input rows a tile can stage (40 KB)
constexpr int kAxisBlocks = 132 * 16;  // blocks a launch aims for
// stage a tile's input rows where they number at most this many times
// its output rows, else gather (measured on the card, PERF.md §6)
constexpr float kStageRatio = 1.0f;

struct AxisMap {   // the diagonal and the translation of each axis
  float cx, tx, cy, ty, cz, tz;
};

// One axis of a diagonal map at output index i: axis_pos of the
// coordinate c*i + t, packed for shared memory.
struct __align__(16) AxisTap {
  int i0, i1;
  float f;
  int inside;
};

__device__ __forceinline__ AxisTap axis_tap(float c, float t, int i, int n) {
  const AxisPos p = axis_pos(c * (float)i + t, n);
  return AxisTap{p.i0, p.i1, p.f, p.inside};
}

// A warp's segment of one output row, the first n values of its row of
// `buf` (which the warp has just filled), to `dst` at any alignment: whole
// float4 stores where `dst` is 16-byte aligned, the head and tail one
// float at a time, so a row that starts off a 16-byte boundary (an odd
// Xo) is written as a fill writes it.
__device__ __forceinline__ void store_segment(float* buf,
                                              float* __restrict__ dst,
                                              int n, int lane) {
  __syncwarp();
  const int head =
      min(n, (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4);
  const int nv = (n - head) / 4;
  const int tail = head + 4 * nv;
  if (lane < head) dst[lane] = buf[lane];
  if (lane < nv) {
    const float* q = buf + head + 4 * lane;
    *reinterpret_cast<float4*>(dst + head + 4 * lane) =
        make_float4(q[0], q[1], q[2], q[3]);
  }
  if (lane < n - tail) dst[tail + lane] = buf[tail + lane];
  __syncwarp();
}

// The y lerp at one output row of the x-lerped rows y0 and y1 (offsets)
// of input slice z, at a lane's kAxisV columns: the twin's c0 (z = z0)
// or c1 (z = z1), read from the volume.
__device__ __forceinline__ void axis_plane(const float* __restrict__ v,
                                           int z, int y0, int y1, float fy,
                                           const AxisTap (&ax)[kAxisV],
                                           float (&plane)[kAxisV]) {
  const float* p0 = v + z + y0;
  const float* p1 = v + z + y1;
#pragma unroll
  for (int j = 0; j < kAxisV; ++j) {
    const int x0 = ax[j].i0, x1 = ax[j].i1;
    const float fx = ax[j].f, gfx = 1.f - fx;
    const float c0 = p0[x0] * gfx + p0[x1] * fx;
    const float c1 = p1[x0] * gfx + p1[x1] * fx;
    plane[j] = c0 * (1.f - fy) + c1 * fy;
  }
}

// One block: volume b = blockIdx.z / nzt, a tile of kAxisTx output columns
// and kTy rows (warp w takes row w), zt <= kAxisTz slices walked. Staged,
// lane l takes columns kAxisV*l .. (a float4 of each staged row) and each
// voxel the y and z lerps of the x-lerped input rows in shared memory.
// Else lane l takes columns l, l + kTx, .. (a warp's loads coalesced) and
// lerps two planes (axis_plane) in z, each plane read from the volume
// once for the slices that share it (upsampling in z, 1:1, a flip).
__global__ void __launch_bounds__(kThreads)
    axis_kernel(const float* __restrict__ vol, int64_t vstride, int Z,
                int Y, int X, AxisMap m, int Zo, int Yo, int Xo, int zt,
                int nzt, float bg, float ratio, float* __restrict__ out) {
  __shared__ __align__(16) float rows[kAxisRows][kAxisTx];  // x-lerped
  __shared__ __align__(16) float obuf[kTy][kAxisTx];   // a row per warp
  __shared__ AxisTap zs[kAxisTz];                      // the tile's slices
  __shared__ int range[4];   // the input rows y and slices z it reaches
  const int lane = threadIdx.x, w = threadIdx.y;
  const int b = blockIdx.z / nzt;
  const int zb = (blockIdx.z - b * nzt) * zt;
  const int zn = min(zt, Zo - zb);
  const int yb = blockIdx.y * kTy;
  const int yn = min(kTy, Yo - yb);
  const int xb = blockIdx.x * kAxisTx;
  const int xn = min(kAxisTx, Xo - xb);
  const float* __restrict__ v = vol + b * vstride;
  if (w == 0) {   // warp 0: the slice table and the input rows reached
    int ylo = INT_MAX, yhi = -1, zlo = INT_MAX, zhi = -1;
    if (lane < yn) {
      const AxisTap a = axis_tap(m.cy, m.ty, yb + lane, Y);
      ylo = a.i0;
      yhi = a.i1;
    }
    if (lane < zn) {
      const AxisTap a = axis_tap(m.cz, m.tz, zb + lane, Z);
      zs[lane] = a;
      zlo = a.i0;
      zhi = a.i1;
    }
    ylo = __reduce_min_sync(0xffffffffu, ylo);
    yhi = __reduce_max_sync(0xffffffffu, yhi);
    zlo = __reduce_min_sync(0xffffffffu, zlo);
    zhi = __reduce_max_sync(0xffffffffu, zhi);
    if (lane == 0) {
      range[0] = ylo;
      range[1] = yhi;
      range[2] = zlo;
      range[3] = zhi;
    }
  }
  // this lane's columns (clamped taps even past Xo) and this warp's row
  AxisTap ax[kAxisV];
#pragma unroll
  for (int j = 0; j < kAxisV; ++j)
    ax[j] = axis_tap(m.cx, m.tx, xb + kAxisV * lane + j, X);
  const int yo = yb + w;
  const AxisTap ay = axis_tap(m.cy, m.ty, yo, Y);
  const float fy = ay.f, gfy = 1.f - fy;
  float* __restrict__ o = out + b * ((int64_t)Zo * Yo * Xo) +
                          ((int64_t)zb * Yo + yo) * Xo + xb;
  const int64_t slice = (int64_t)Yo * Xo;
  float* buf = obuf[w];
  __syncthreads();
  const int ylo = range[0], ny = range[1] - ylo + 1;
  const int zlo = range[2], nz = range[3] - zlo + 1;
  const int nrows = ny * nz;   // <= Y * Z < 2^31
  if (nrows <= kAxisRows && (float)nrows <= ratio * (float)(yn * zn)) {
    // stage: warp w x-lerps input rows ylo + w, + kTy, ... of each slice
    for (int zi = 0; zi < nz; ++zi)
      for (int yi = w; yi < ny; yi += kTy) {
        const float* p = v + ((zlo + zi) * Y + ylo + yi) * X;
        float q[kAxisV];
#pragma unroll
        for (int j = 0; j < kAxisV; ++j)
          q[j] = p[ax[j].i0] * (1.f - ax[j].f) + p[ax[j].i1] * ax[j].f;
        *reinterpret_cast<float4*>(&rows[zi * ny + yi][kAxisV * lane]) =
            make_float4(q[0], q[1], q[2], q[3]);
      }
    __syncthreads();
    if (yo >= Yo) return;
    const int r0 = ay.i0 - ylo, r1 = ay.i1 - ylo;
    for (int k = 0; k < zn; ++k, o += slice) {
      const AxisTap az = zs[k];
      float res[kAxisV] = {bg, bg, bg, bg};
      if (ay.inside && az.inside) {
        const int s0 = (az.i0 - zlo) * ny, s1 = (az.i1 - zlo) * ny;
        const float4 a00 = *reinterpret_cast<const float4*>(
            &rows[s0 + r0][kAxisV * lane]);
        const float4 a01 = *reinterpret_cast<const float4*>(
            &rows[s0 + r1][kAxisV * lane]);
        const float4 a10 = *reinterpret_cast<const float4*>(
            &rows[s1 + r0][kAxisV * lane]);
        const float4 a11 = *reinterpret_cast<const float4*>(
            &rows[s1 + r1][kAxisV * lane]);
        const float c00[4] = {a00.x, a00.y, a00.z, a00.w};
        const float c01[4] = {a01.x, a01.y, a01.z, a01.w};
        const float c10[4] = {a10.x, a10.y, a10.z, a10.w};
        const float c11[4] = {a11.x, a11.y, a11.z, a11.w};
        const float fz = az.f, gfz = 1.f - fz;
#pragma unroll
        for (int j = 0; j < kAxisV; ++j) {
          const float c0 = c00[j] * gfy + c01[j] * fy;
          const float c1 = c10[j] * gfy + c11[j] * fy;
          if (ax[j].inside) res[j] = c0 * gfz + c1 * fz;
        }
      }
      *reinterpret_cast<float4*>(buf + kAxisV * lane) =
          make_float4(res[0], res[1], res[2], res[3]);
      store_segment(buf, o, xn, lane);
    }
    return;
  }
  if (yo >= Yo) return;
#pragma unroll
  for (int j = 0; j < kAxisV; ++j)
    ax[j] = axis_tap(m.cx, m.tx, xb + lane + kTx * j, X);
  const int y0 = ay.i0 * X, y1 = ay.i1 * X, zs_ = Y * X;
  float pa[kAxisV], pb[kAxisV];
  int ta = -1, tb = -1;   // the input slices pa and pb hold
  for (int k = 0; k < zn; ++k, o += slice) {
    const AxisTap az = zs[k];
    float res[kAxisV] = {bg, bg, bg, bg};
    if (ay.inside && az.inside) {
      float na[kAxisV], nb[kAxisV];
      if (az.i0 == ta || az.i0 == tb) {
        const bool a = az.i0 == ta;
#pragma unroll
        for (int j = 0; j < kAxisV; ++j) na[j] = a ? pa[j] : pb[j];
      } else {
        axis_plane(v, az.i0 * zs_, y0, y1, fy, ax, na);
      }
      if (az.i1 == az.i0) {
#pragma unroll
        for (int j = 0; j < kAxisV; ++j) nb[j] = na[j];
      } else if (az.i1 == ta || az.i1 == tb) {
        const bool a = az.i1 == ta;
#pragma unroll
        for (int j = 0; j < kAxisV; ++j) nb[j] = a ? pa[j] : pb[j];
      } else {
        axis_plane(v, az.i1 * zs_, y0, y1, fy, ax, nb);
      }
      const float fz = az.f, gfz = 1.f - fz;
#pragma unroll
      for (int j = 0; j < kAxisV; ++j) {
        pa[j] = na[j];
        pb[j] = nb[j];
        if (ax[j].inside) res[j] = na[j] * gfz + nb[j] * fz;
      }
      ta = az.i0;
      tb = az.i1;
    }
#pragma unroll
    for (int j = 0; j < kAxisV; ++j) buf[lane + kTx * j] = res[j];
    store_segment(buf, o, xn, lane);
  }
}

// Output voxels a thread of warp_kernel takes along x. Measured on the
// card at 1, 2 and 4 (PERF.md §6): 4 lost to 2 in every full-size case.
constexpr int kWarpWidth = 2;

struct Launch {
  dim3 grid;
  int zt;
  bool ok;
};

// Slices a block walks: 4 where the grid still holds several waves of
// blocks on the card's 132 SMs, else 1 (the coarse pyramid levels).
Launch plan(int Zo, int Yo, int Xo, int tile_x, int tile_y) {
  const int gx = (Xo + tile_x - 1) / tile_x;
  const int gy = (Yo + tile_y - 1) / tile_y;
  const int64_t tiles = (int64_t)gx * gy * Zo;
  const int zt = tiles >= 4 * 8 * 132 * 4 ? 4 : 1;
  const int64_t gz = (Zo + zt - 1) / zt;
  Launch l;
  l.grid = dim3(gx, gy, (unsigned)(gz < 65535 ? gz : 65535));
  l.zt = zt;
  l.ok = gy <= 65535;
  return l;
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// One launch of kB volumes; the vector path only where every row the
// kernel reads or writes kV floats at a time is aligned to them.
template <Mode M, bool kGrad, int kB>
int launch_b(cudaStream_t s, const float* vol, int64_t vstride, int Z,
             int Y, int X, const float* cz, const float* cy, const float* cx,
             const float* disp, int Zo, int Yo, int Xo, float bg, float* out,
             float* gz, float* gy, float* gx) {
  constexpr int kV = kWarpWidth;
  const Launch l = plan(Zo, Yo, Xo, kTx * kV, kTy);
  if (!l.ok) return (int)cudaErrorInvalidValue;
  const int a = 4 * kV;
  const bool vec = Xo % kV == 0 && aligned(cz, a) && aligned(cy, a) &&
                   aligned(cx, a) && aligned(disp, a) && aligned(out, a) &&
                   aligned(gz, a) && aligned(gy, a) && aligned(gx, a);
  warp_kernel<M, kGrad, kB, kV><<<l.grid, dim3(kTx, kTy), 0, s>>>(
      vol, vstride, Z, Y, X, cz, cy, cx, disp, Zo, Yo, Xo, l.zt, bg, vec,
      out, gz, gy, gx);
  return (int)cudaGetLastError();
}

template <Mode M, int kB>
int launch_affine_b(cudaStream_t s, const float* vol, int64_t vstride,
                    int Z, int Y, int X, const Coef& coef, const Shear& sh,
                    int Zo, int Yo, int Xo, float bg, float* out) {
  const Launch l = plan(Zo, Yo, Xo, kTx, kTy);
  if (!l.ok) return (int)cudaErrorInvalidValue;
  if (coef.c[2] == 0.f && coef.c[6] == 0.f)
    affine_kernel<M, kB, true><<<l.grid, dim3(kTx, kTy), 0, s>>>(
        vol, vstride, Z, Y, X, coef, sh, Zo, Yo, Xo, l.zt, bg, out);
  else
    affine_kernel<M, kB, false><<<l.grid, dim3(kTx, kTy), 0, s>>>(
        vol, vstride, Z, Y, X, coef, sh, Zo, Yo, Xo, l.zt, bg, out);
  return (int)cudaGetLastError();
}

#define MIA_SWITCH_B(B, CALL)                                          \
  switch (B) {                                                         \
    case 1: return CALL(1);                                            \
    case 2: return CALL(2);                                            \
    case 3: return CALL(3);                                            \
    case 4: return CALL(4);                                            \
    default: return (int)cudaErrorInvalidValue; /* the wrapper splits B */ \
  }

template <Mode M, bool kGrad>
int launch(int B, const float* vol, int64_t vstride, int Z, int Y, int X,
           const float* cz, const float* cy, const float* cx,
           const float* disp, int Zo, int Yo, int Xo, float bg, float* out,
           float* gz, float* gy, float* gx, void* stream) {
  if ((int64_t)Zo * Yo * Xo == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MIA_LAUNCH(NB)                                                   \
  launch_b<M, kGrad, NB>(s, vol, vstride, Z, Y, X, cz, cy, cx, disp, Zo, \
                         Yo, Xo, bg, out, gz, gy, gx)
  MIA_SWITCH_B(B, MIA_LAUNCH)
#undef MIA_LAUNCH
}

template <Mode M>
int launch_affine(int B, const float* vol, int64_t vstride, int Z, int Y,
                  int X, const Coef& coef, const Shear& sh, int Zo, int Yo,
                  int Xo, float bg, float* out, void* stream) {
  if ((int64_t)Zo * Yo * Xo == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MIA_LAUNCH(NB)                                                     \
  launch_affine_b<M, NB>(s, vol, vstride, Z, Y, X, coef, sh, Zo, Yo, Xo, \
                         bg, out)
  MIA_SWITCH_B(B, MIA_LAUNCH)
#undef MIA_LAUNCH
}

// axis_kernel at a diagonal map; a tile stages its rows where they number
// at most `ratio` times its output rows.
int launch_axis(const float* vol, int B, int Z, int Y, int X,
                const float* coef12, int Zo, int Yo, int Xo, float bg,
                float* out, float ratio, void* stream) {
  const float* c = coef12;   // host array
  if (c[1] != 0.f || c[2] != 0.f || c[4] != 0.f || c[6] != 0.f ||
      c[8] != 0.f || c[9] != 0.f || B < 1)
    return (int)cudaErrorInvalidValue;   // not a diagonal map (or NaN)
  if ((int64_t)Zo * Yo * Xo == 0) return 0;
  const int gx = (Xo + kAxisTx - 1) / kAxisTx;
  const int gy = (Yo + kTy - 1) / kTy;
  // slices a tile walks: kAxisTz, halved while the grid is short of
  // kAxisBlocks blocks (a small output: the CT onto the dose grid)
  int zt = kAxisTz;
  while (zt > 1 && (int64_t)gx * gy * B * ((Zo + zt - 1) / zt) < kAxisBlocks)
    zt /= 2;
  const int nzt = (Zo + zt - 1) / zt;
  if (gy > 65535 || (int64_t)nzt * B > 65535)
    return (int)cudaErrorInvalidValue;
  const AxisMap m{c[0], c[3], c[5], c[7], c[10], c[11]};
  axis_kernel<<<dim3(gx, gy, nzt * B), dim3(kTx, kTy), 0,
                static_cast<cudaStream_t>(stream)>>>(
      vol, (int64_t)Z * Y * X, Z, Y, X, m, Zo, Yo, Xo, zt, nzt, bg, ratio,
      out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mia_warp_coords(const float* vol, int B, int Z, int Y, int X,
                               const float* cz, const float* cy,
                               const float* cx, int Zo, int Yo, int Xo,
                               float bg, float* out, float* gz, float* gy,
                               float* gx, int want_grad, void* stream) {
  const int64_t vs = (int64_t)Z * Y * X;
  if (want_grad)
    return launch<Mode::kCoords, true>(B, vol, vs, Z, Y, X, cz, cy, cx,
                                       nullptr, Zo, Yo, Xo, bg, out, gz, gy,
                                       gx, stream);
  return launch<Mode::kCoords, false>(B, vol, vs, Z, Y, X, cz, cy, cx,
                                      nullptr, Zo, Yo, Xo, bg, out, nullptr,
                                      nullptr, nullptr, stream);
}

// affine at any map: coef12 the row-major output (x, y, z, 1) -> input
// (x, y, z) coefficients (host array); output (B, Zo, Yo, Xo).
extern "C" int mia_warp_affine(const float* vol, int B, int Z, int Y, int X,
                               const float* coef12, int Zo, int Yo, int Xo,
                               float bg, float* out, void* stream) {
  Coef coef;
  for (int k = 0; k < 12; ++k) coef.c[k] = coef12[k];
  return launch_affine<Mode::kAffine>(B, vol, (int64_t)Z * Y * X, Z, Y, X,
                                      coef, Shear{}, Zo, Yo, Xo, bg, out,
                                      stream);
}

// affine at a map whose six off-diagonal coefficients are 0 (else
// cudaErrorInvalidValue): mia_warp_affine's arguments and result.
extern "C" int mia_warp_affine_axis(const float* vol, int B, int Z, int Y,
                                    int X, const float* coef12, int Zo,
                                    int Yo, int Xo, float bg, float* out,
                                    void* stream) {
  return launch_axis(vol, B, Z, Y, X, coef12, Zo, Yo, Xo, bg, out,
                     kStageRatio, stream);
}

// the same with the staging threshold given: a tile stages its rows where
// they number at most `ratio` times its output rows (0: every tile
// gathers; 1e30: every tile whose rows fit stages). Holds both branches
// to the twin and measures the threshold.
extern "C" int mia_warp_affine_axis_ratio(const float* vol, int B, int Z,
                                          int Y, int X, const float* coef12,
                                          int Zo, int Yo, int Xo, float bg,
                                          float* out, float ratio,
                                          void* stream) {
  return launch_axis(vol, B, Z, Y, X, coef12, Zo, Yo, Xo, bg, out, ratio,
                     stream);
}

// disp: the planar (3, Zo, Yo, Xo) field, rows (x, y, z); output
// (B, Zo, Yo, Xo), the volume (B, Z, Y, X) of any dims.
extern "C" int mia_warp_disp(const float* vol, int B, int Z, int Y, int X,
                             const float* disp, int Zo, int Yo, int Xo,
                             float bg, float* out, float* gz, float* gy,
                             float* gx, int want_grad, void* stream) {
  const int64_t vs = (int64_t)Z * Y * X;
  if (want_grad)
    return launch<Mode::kDisp, true>(B, vol, vs, Z, Y, X, nullptr, nullptr,
                                     nullptr, disp, Zo, Yo, Xo, bg, out, gz,
                                     gy, gx, stream);
  return launch<Mode::kDisp, false>(B, vol, vs, Z, Y, X, nullptr, nullptr,
                                    nullptr, disp, Zo, Yo, Xo, bg, out,
                                    nullptr, nullptr, nullptr, stream);
}

// affine_shear: v2 (B, Z2, Y2, X), the staircase-sheared copy of volumes
// of logical dims (Z, Y, X); coef16 = the 12 affine coefficients, then ky,
// kz, oy, oz (host array; ops/warp.oblique_plan's slopes |k| <= 2 and
// whole row offsets 0 <= o < 2^20, else cudaErrorInvalidValue); output
// (B, Zo, Yo, Xo).
extern "C" int mia_warp_affine_shear(const float* v2, int B, int Z2, int Y2,
                                     int X, int Z, int Y,
                                     const float* coef16, int Zo, int Yo,
                                     int Xo, float bg, float* out,
                                     void* stream) {
  const float ky = coef16[12], kz = coef16[13], oy = coef16[14],
              oz = coef16[15];
  // stair_shift's integers stay below 2^22
  const float lim = 1048576.f;   // 2^20
  if (!(fabsf(ky) <= 2.f && fabsf(kz) <= 2.f && oy >= 0.f && oy < lim &&
        oz >= 0.f && oz < lim && oy == floorf(oy) && oz == floorf(oz) &&
        X < (1 << 20)))
    return (int)cudaErrorInvalidValue;
  Coef coef;
  for (int k = 0; k < 12; ++k) coef.c[k] = coef16[k];
  const Shear sh{ky, kz, oy, oz, Z2, Y2};
  return launch_affine<Mode::kAffineShear>(B, v2, (int64_t)Z2 * Y2 * X, Z,
                                           Y, X, coef, sh, Zo, Yo, Xo, bg,
                                           out, stream);
}
