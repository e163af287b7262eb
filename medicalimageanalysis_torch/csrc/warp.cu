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
// HBM; on Hopper a thread reads global memory directly, so one thread per
// output voxel (grid-stride loop, B looped inside the thread so the tap
// addresses are computed once) serves every coordinate map, and
// neighbouring threads read neighbouring taps through L1/L2. In kDisp the
// displacement is read coalesced (three planar rows), and the output dims
// are the field's, which may differ from the volume's.
//
// Exactness: the plain PyTorch twin (ops/warp.py) rounds every operation
// to float32 in this file's order. The file is compiled with
// --fmad=false so nvcc does not contract a*(1-f) + b*f or the affine
// coefficient sums into FMAs; kernel and twin are then bit-equal.
// Coordinates are clamped in float before the float->int cast (a cast of
// NaN or 1e30 is undefined), and no load goes through an unclamped index.
//
// Plain C interface, loaded with ctypes (ops/_build.py); each entry point
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum class Mode { kCoords, kAffine, kDisp, kAffineShear };

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

template <Mode M, bool kGrad>
__global__ void warp_kernel(const float* __restrict__ vol, int B, int Z,
                            int Y, int X, const float* __restrict__ czp,
                            const float* __restrict__ cyp,
                            const float* __restrict__ cxp,
                            const float* __restrict__ dsp, Coef coef,
                            Shear sh, int Yo, int Xo, int64_t n, float bg,
                            float* __restrict__ out, float* __restrict__ gz,
                            float* __restrict__ gy, float* __restrict__ gx) {
  // (Z, Y, X) are the logical dims; kAffineShear's volumes are V2
  const int64_t vstride = M == Mode::kAffineShear
                              ? (int64_t)sh.Z2 * sh.Y2 * X
                              : (int64_t)Z * Y * X;
  const float zmax = (float)(Z - 1);
  const float ymax = (float)(Y - 1);
  const float xmax = (float)(X - 1);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    float z, y, x;
    if constexpr (M == Mode::kCoords) {
      z = czp[i];
      y = cyp[i];
      x = cxp[i];
    } else {
      const int64_t t = i / Xo;
      const float gxf = (float)(i - t * Xo);
      const float gyf = (float)(t % Yo);
      const float gzf = (float)(t / Yo);
      if constexpr (M == Mode::kDisp) {
        x = gxf + dsp[i];
        y = gyf + dsp[n + i];
        z = gzf + dsp[2 * n + i];
      } else {
        const float* c = coef.c;
        x = c[0] * gxf + c[1] * gyf + c[2] * gzf + c[3];
        y = c[4] * gxf + c[5] * gyf + c[6] * gzf + c[7];
        z = c[8] * gxf + c[9] * gyf + c[10] * gzf + c[11];
      }
    }
    const bool inside = (x >= 0.f) && (x <= xmax) && (y >= 0.f) &&
                        (y <= ymax) && (z >= 0.f) && (z <= zmax);
    if (!inside) {
      for (int b = 0; b < B; ++b) {
        const int64_t o = (int64_t)b * n + i;
        out[o] = bg;
        if constexpr (kGrad) {
          gz[o] = 0.f;
          gy[o] = 0.f;
          gx[o] = 0.f;
        }
      }
      continue;
    }
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float z0f = floorf(z);
    const float fx = x - x0f;
    const float fy = y - y0f;
    const float fz = z - z0f;
    const float gfx = 1.f - fx;
    const float gfy = 1.f - fy;
    const float gfz = 1.f - fz;
    // clamp in float, then cast (fmaxf maps NaN to 0)
    const int x0 = (int)fminf(fmaxf(x0f, 0.f), xmax);
    const int y0 = (int)fminf(fmaxf(y0f, 0.f), ymax);
    const int z0 = (int)fminf(fmaxf(z0f, 0.f), zmax);
    const int x1 = min(x0 + 1, X - 1);
    const int y1 = min(y0 + 1, Y - 1);
    const int z1 = min(z0 + 1, Z - 1);
    // element offsets of the 8 taps: (z, y) rows of the x0 taps (a) and
    // of the x1 taps (b); one set of rows unless the volume is sheared
    int64_t a00, a01, a10, a11, b00, b01, b10, b11;
    if constexpr (M == Mode::kAffineShear) {
      const int za0 = stair_row(z0, sh.oz, sh.kz, x0, sh.Z2);
      const int za1 = stair_row(z1, sh.oz, sh.kz, x0, sh.Z2);
      const int zb0 = stair_row(z0, sh.oz, sh.kz, x1, sh.Z2);
      const int zb1 = stair_row(z1, sh.oz, sh.kz, x1, sh.Z2);
      const int ya0 = stair_row(y0, sh.oy, sh.ky, x0, sh.Y2);
      const int ya1 = stair_row(y1, sh.oy, sh.ky, x0, sh.Y2);
      const int yb0 = stair_row(y0, sh.oy, sh.ky, x1, sh.Y2);
      const int yb1 = stair_row(y1, sh.oy, sh.ky, x1, sh.Y2);
      a00 = ((int64_t)za0 * sh.Y2 + ya0) * X + x0;
      a01 = ((int64_t)za0 * sh.Y2 + ya1) * X + x0;
      a10 = ((int64_t)za1 * sh.Y2 + ya0) * X + x0;
      a11 = ((int64_t)za1 * sh.Y2 + ya1) * X + x0;
      b00 = ((int64_t)zb0 * sh.Y2 + yb0) * X + x1;
      b01 = ((int64_t)zb0 * sh.Y2 + yb1) * X + x1;
      b10 = ((int64_t)zb1 * sh.Y2 + yb0) * X + x1;
      b11 = ((int64_t)zb1 * sh.Y2 + yb1) * X + x1;
    } else {
      const int64_t r00 = ((int64_t)z0 * Y + y0) * X;
      const int64_t r01 = ((int64_t)z0 * Y + y1) * X;
      const int64_t r10 = ((int64_t)z1 * Y + y0) * X;
      const int64_t r11 = ((int64_t)z1 * Y + y1) * X;
      a00 = r00 + x0; a01 = r01 + x0; a10 = r10 + x0; a11 = r11 + x0;
      b00 = r00 + x1; b01 = r01 + x1; b10 = r10 + x1; b11 = r11 + x1;
    }
    for (int b = 0; b < B; ++b) {
      const float* v = vol + (int64_t)b * vstride;
      const float c000 = v[a00], c001 = v[b00];
      const float c010 = v[a01], c011 = v[b01];
      const float c100 = v[a10], c101 = v[b10];
      const float c110 = v[a11], c111 = v[b11];
      const float c00 = c000 * gfx + c001 * fx;
      const float c01 = c010 * gfx + c011 * fx;
      const float c10 = c100 * gfx + c101 * fx;
      const float c11 = c110 * gfx + c111 * fx;
      const float c0 = c00 * gfy + c01 * fy;
      const float c1 = c10 * gfy + c11 * fy;
      const int64_t o = (int64_t)b * n + i;
      out[o] = c0 * gfz + c1 * fz;
      if constexpr (kGrad) {
        gx[o] = ((c001 - c000) * gfy + (c011 - c010) * fy) * gfz +
                ((c101 - c100) * gfy + (c111 - c110) * fy) * fz;
        gy[o] = (c01 - c00) * gfz + (c11 - c10) * fz;
        gz[o] = c1 - c0;
      }
    }
  }
}

constexpr int kThreads = 256;

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b > (1 << 20)) b = 1 << 20;  // grid-stride loop covers the rest
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int mia_warp_coords(const float* vol, int B, int Z, int Y, int X,
                               const float* cz, const float* cy,
                               const float* cx, int Zo, int Yo, int Xo,
                               float bg, float* out, float* gz, float* gy,
                               float* gx, int want_grad, void* stream) {
  const int64_t n = (int64_t)Zo * Yo * Xo;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Coef none{};
  if (want_grad) {
    warp_kernel<Mode::kCoords, true><<<blocks_for(n), kThreads, 0, s>>>(
        vol, B, Z, Y, X, cz, cy, cx, nullptr, none, Shear{}, Yo, Xo, n, bg,
        out, gz, gy, gx);
  } else {
    warp_kernel<Mode::kCoords, false><<<blocks_for(n), kThreads, 0, s>>>(
        vol, B, Z, Y, X, cz, cy, cx, nullptr, none, Shear{}, Yo, Xo, n, bg,
        out, nullptr, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int mia_warp_affine(const float* vol, int B, int Z, int Y, int X,
                               const float* coef12, int Zo, int Yo, int Xo,
                               float bg, float* out, void* stream) {
  const int64_t n = (int64_t)Zo * Yo * Xo;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Coef coef;
  for (int k = 0; k < 12; ++k) coef.c[k] = coef12[k];  // host array
  warp_kernel<Mode::kAffine, false><<<blocks_for(n), kThreads, 0, s>>>(
      vol, B, Z, Y, X, nullptr, nullptr, nullptr, nullptr, coef, Shear{}, Yo,
      Xo, n, bg, out, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// disp: the planar (3, Zo, Yo, Xo) field, rows (x, y, z); output
// (B, Zo, Yo, Xo), the volume (B, Z, Y, X) of any dims.
extern "C" int mia_warp_disp(const float* vol, int B, int Z, int Y, int X,
                             const float* disp, int Zo, int Yo, int Xo,
                             float bg, float* out, float* gz, float* gy,
                             float* gx, int want_grad, void* stream) {
  const int64_t n = (int64_t)Zo * Yo * Xo;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Coef none{};
  if (want_grad) {
    warp_kernel<Mode::kDisp, true><<<blocks_for(n), kThreads, 0, s>>>(
        vol, B, Z, Y, X, nullptr, nullptr, nullptr, disp, none, Shear{}, Yo,
        Xo, n, bg, out, gz, gy, gx);
  } else {
    warp_kernel<Mode::kDisp, false><<<blocks_for(n), kThreads, 0, s>>>(
        vol, B, Z, Y, X, nullptr, nullptr, nullptr, disp, none, Shear{}, Yo,
        Xo, n, bg, out, nullptr, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

// affine_shear: v2 (B, Z2, Y2, X), the staircase-sheared copy of volumes
// of logical dims (Z, Y, X); coef16 = the 12 affine coefficients, then ky,
// kz, oy, oz (host array); output (B, Zo, Yo, Xo).
extern "C" int mia_warp_affine_shear(const float* v2, int B, int Z2, int Y2,
                                     int X, int Z, int Y,
                                     const float* coef16, int Zo, int Yo,
                                     int Xo, float bg, float* out,
                                     void* stream) {
  const int64_t n = (int64_t)Zo * Yo * Xo;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Coef coef;
  for (int k = 0; k < 12; ++k) coef.c[k] = coef16[k];
  const Shear sh{coef16[12], coef16[13], coef16[14], coef16[15], Z2, Y2};
  warp_kernel<Mode::kAffineShear, false><<<blocks_for(n), kThreads, 0, s>>>(
      v2, B, Z, Y, X, nullptr, nullptr, nullptr, nullptr, coef, sh, Yo, Xo,
      n, bg, out, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}
