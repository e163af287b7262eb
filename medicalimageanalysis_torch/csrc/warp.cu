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
// What bounds it: a gather. Each output voxel reads 8 scattered floats per
// volume and writes 1 (4 with gradients), so the kernel is bound by device
// memory latency and L2 traffic, not arithmetic. The TPU kernel's slab,
// window and DMA machinery existed because a TPU core cannot gather from
// HBM; on Hopper a thread reads global memory directly. The design, each
// step measured on the card (PERF.md §6):
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
// Exactness: the plain PyTorch twin (ops/warp.py) rounds every operation
// to float32 in this file's order. The file is compiled with
// --fmad=false so nvcc does not contract a*(1-f) + b*f or the affine
// coefficient sums into FMAs; kernel and twin are then bit-equal.
// Coordinates are clamped in float before the float->int cast (a cast of
// NaN or 1e30 is undefined), and no load goes through an unclamped index.
//
// Plain C interface, loaded with ctypes (ops/_build.py); each entry point
// launches on the caller's stream and returns a cudaError_t.

#include <cuda_runtime.h>
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

// row of V2 that holds row `r` (z or y) of V at column x: r + o - stair(k, x),
// in float (exact for these integers), clamped to [0, n-1] before the cast
__device__ __forceinline__ int stair_row(int r, float o, float k, int x,
                                         int n) {
  const float stair = floorf(k * (float)x + 0.5f);
  const float row = ((float)r + o) - stair;
  return (int)fminf(fmaxf(row, 0.f), (float)(n - 1));
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

// Where a sample lands: inside [0, dim-1] or not, its fractions and its
// clamped taps (clamped in float, then cast: fmaxf maps NaN to 0).
struct Tap {
  bool inside;
  float fx, fy, fz;
  int x0, x1, y0, y1, z0, z1;
};

__device__ __forceinline__ Tap locate(float x, float y, float z, int X,
                                      int Y, int Z) {
  const float xmax = (float)(X - 1);
  const float ymax = (float)(Y - 1);
  const float zmax = (float)(Z - 1);
  Tap t;
  t.inside = (x >= 0.f) && (x <= xmax) && (y >= 0.f) && (y <= ymax) &&
             (z >= 0.f) && (z <= zmax);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float z0f = floorf(z);
  t.fx = x - x0f;
  t.fy = y - y0f;
  t.fz = z - z0f;
  t.x0 = (int)fminf(fmaxf(x0f, 0.f), xmax);
  t.y0 = (int)fminf(fmaxf(y0f, 0.f), ymax);
  t.z0 = (int)fminf(fmaxf(z0f, 0.f), zmax);
  t.x1 = min(t.x0 + 1, X - 1);
  t.y1 = min(t.y0 + 1, Y - 1);
  t.z1 = min(t.z0 + 1, Z - 1);
  return t;
}

// The grid: x tiles of kTx * kV, y tiles of kTy, and z walked zt slices at
// a time from blockIdx.z (grid-stride over z beyond 65535 z blocks).
template <Mode M, bool kGrad, int kB, int kV>
__global__ void __launch_bounds__(kThreads)
    warp_kernel(const float* __restrict__ vol, int64_t vstride, int Z,
                int Y, int X, const float* __restrict__ czp,
                const float* __restrict__ cyp,
                const float* __restrict__ cxp,
                const float* __restrict__ dsp, Coef coef, Shear sh, int Zo,
                int Yo, int Xo, int zt, float bg, bool vec,
                float* __restrict__ out, float* __restrict__ gzp,
                float* __restrict__ gyp, float* __restrict__ gxp) {
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
      } else if constexpr (M == Mode::kDisp) {
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
      } else {
        const float* c = coef.c;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const float gxf = (float)(xs + j);
          cx[j] = c[0] * gxf + c[1] * gyf + c[2] * gzf + c[3];
          cy[j] = c[4] * gxf + c[5] * gyf + c[6] * gzf + c[7];
          cz[j] = c[8] * gxf + c[9] * gyf + c[10] * gzf + c[11];
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
        const int x0 = tp.x0, x1 = tp.x1, y0 = tp.y0, y1 = tp.y1;
        const int z0 = tp.z0, z1 = tp.z1;
        // element offsets of the 8 taps, in the order c000, c001, c010,
        // c011, c100, c101, c110, c111 (z, y, x bits); one set of rows
        // unless the volume is sheared
        int t[8];
        if constexpr (M == Mode::kAffineShear) {
          const int za0 = stair_row(z0, sh.oz, sh.kz, x0, sh.Z2);
          const int za1 = stair_row(z1, sh.oz, sh.kz, x0, sh.Z2);
          const int zb0 = stair_row(z0, sh.oz, sh.kz, x1, sh.Z2);
          const int zb1 = stair_row(z1, sh.oz, sh.kz, x1, sh.Z2);
          const int ya0 = stair_row(y0, sh.oy, sh.ky, x0, sh.Y2);
          const int ya1 = stair_row(y1, sh.oy, sh.ky, x0, sh.Y2);
          const int yb0 = stair_row(y0, sh.oy, sh.ky, x1, sh.Y2);
          const int yb1 = stair_row(y1, sh.oy, sh.ky, x1, sh.Y2);
          t[0] = (za0 * sh.Y2 + ya0) * X + x0;
          t[1] = (zb0 * sh.Y2 + yb0) * X + x1;
          t[2] = (za0 * sh.Y2 + ya1) * X + x0;
          t[3] = (zb0 * sh.Y2 + yb1) * X + x1;
          t[4] = (za1 * sh.Y2 + ya0) * X + x0;
          t[5] = (zb1 * sh.Y2 + yb0) * X + x1;
          t[6] = (za1 * sh.Y2 + ya1) * X + x0;
          t[7] = (zb1 * sh.Y2 + yb1) * X + x1;
        } else {
          const int r00 = (z0 * Y + y0) * X;
          const int r01 = (z0 * Y + y1) * X;
          const int r10 = (z1 * Y + y0) * X;
          const int r11 = (z1 * Y + y1) * X;
          t[0] = r00 + x0; t[1] = r00 + x1; t[2] = r01 + x0; t[3] = r01 + x1;
          t[4] = r10 + x0; t[5] = r10 + x1; t[6] = r11 + x0; t[7] = r11 + x1;
        }
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

// Output voxels a thread takes along x: 2 where the coordinates come from
// memory (coords, disp), 1 for the affine maps. Measured on the card at
// 1, 2 and 4 (PERF.md §6): 4 lost to 2 in every full-size case,
// and 2 lost to 1 on the rotated affine maps, whose neighbouring x
// voxels read rows far apart.
template <Mode M>
constexpr int width() {
  return M == Mode::kCoords || M == Mode::kDisp ? 2 : 1;
}

struct Launch {
  dim3 grid;
  int zt;
  bool ok;
};

// Slices a block walks: 4 where the grid still holds several waves of
// blocks on the card's 132 SMs, else 1 (the coarse pyramid levels).
Launch plan(int Zo, int Yo, int Xo, int kv) {
  const int gx = (Xo + kTx * kv - 1) / (kTx * kv);
  const int gy = (Yo + kTy - 1) / kTy;
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
             const float* disp, const Coef& coef, const Shear& sh, int Zo,
             int Yo, int Xo, float bg, float* out, float* gz, float* gy,
             float* gx) {
  constexpr int kV = width<M>();
  const Launch l = plan(Zo, Yo, Xo, kV);
  if (!l.ok) return (int)cudaErrorInvalidValue;
  const int a = 4 * kV;
  const bool vec = Xo % kV == 0 && aligned(cz, a) && aligned(cy, a) &&
                   aligned(cx, a) && aligned(disp, a) && aligned(out, a) &&
                   aligned(gz, a) && aligned(gy, a) && aligned(gx, a);
  warp_kernel<M, kGrad, kB, kV><<<l.grid, dim3(kTx, kTy), 0, s>>>(
      vol, vstride, Z, Y, X, cz, cy, cx, disp, coef, sh, Zo, Yo, Xo, l.zt,
      bg, vec, out, gz, gy, gx);
  return (int)cudaGetLastError();
}

template <Mode M, bool kGrad>
int launch(int B, const float* vol, int64_t vstride, int Z, int Y, int X,
           const float* cz, const float* cy, const float* cx,
           const float* disp, const Coef& coef, const Shear& sh, int Zo,
           int Yo, int Xo, float bg, float* out, float* gz, float* gy,
           float* gx, void* stream) {
  if ((int64_t)Zo * Yo * Xo == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MIA_LAUNCH(NB)                                                   \
  launch_b<M, kGrad, NB>(s, vol, vstride, Z, Y, X, cz, cy, cx, disp,     \
                         coef, sh, Zo, Yo, Xo, bg, out, gz, gy, gx)
  switch (B) {
    case 1: return MIA_LAUNCH(1);
    case 2: return MIA_LAUNCH(2);
    case 3: return MIA_LAUNCH(3);
    case 4: return MIA_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;   // the wrapper splits B
  }
#undef MIA_LAUNCH
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
                                       nullptr, Coef{}, Shear{}, Zo, Yo, Xo,
                                       bg, out, gz, gy, gx, stream);
  return launch<Mode::kCoords, false>(B, vol, vs, Z, Y, X, cz, cy, cx,
                                      nullptr, Coef{}, Shear{}, Zo, Yo, Xo,
                                      bg, out, nullptr, nullptr,
                                      nullptr, stream);
}

extern "C" int mia_warp_affine(const float* vol, int B, int Z, int Y, int X,
                               const float* coef12, int Zo, int Yo, int Xo,
                               float bg, float* out, void* stream) {
  Coef coef;
  for (int k = 0; k < 12; ++k) coef.c[k] = coef12[k];  // host array
  return launch<Mode::kAffine, false>(
      B, vol, (int64_t)Z * Y * X, Z, Y, X, nullptr, nullptr, nullptr,
      nullptr, coef, Shear{}, Zo, Yo, Xo, bg, out, nullptr, nullptr,
      nullptr, stream);
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
                                     nullptr, disp, Coef{}, Shear{}, Zo, Yo,
                                     Xo, bg, out, gz, gy, gx,
                                     stream);
  return launch<Mode::kDisp, false>(B, vol, vs, Z, Y, X, nullptr, nullptr,
                                    nullptr, disp, Coef{}, Shear{}, Zo, Yo,
                                    Xo, bg, out, nullptr, nullptr,
                                    nullptr, stream);
}

// affine_shear: v2 (B, Z2, Y2, X), the staircase-sheared copy of volumes
// of logical dims (Z, Y, X); coef16 = the 12 affine coefficients, then ky,
// kz, oy, oz (host array); output (B, Zo, Yo, Xo).
extern "C" int mia_warp_affine_shear(const float* v2, int B, int Z2, int Y2,
                                     int X, int Z, int Y,
                                     const float* coef16, int Zo, int Yo,
                                     int Xo, float bg, float* out,
                                     void* stream) {
  Coef coef;
  for (int k = 0; k < 12; ++k) coef.c[k] = coef16[k];
  const Shear sh{coef16[12], coef16[13], coef16[14], coef16[15], Z2, Y2};
  return launch<Mode::kAffineShear, false>(
      B, v2, (int64_t)Z2 * Y2 * X, Z, Y, X, nullptr, nullptr, nullptr,
      nullptr, coef, sh, Zo, Yo, Xo, bg, out, nullptr, nullptr, nullptr,
      stream);
}
