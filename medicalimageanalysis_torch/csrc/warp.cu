// Exact trilinear warp for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces medicalimageanalysis_tpu/ops/pallas_warp.py::_warp_kernel in its
// `coords` and `disp` modes (each with and without the fused coordinate
// gradients) and its `affine` mode. It computes what the TPU kernel
// computes: an exact 8-tap trilinear sample of B volumes (Z, Y, X) per
// output voxel, taps clamped to the edge, samples outside [0, dim-1] set to
// `background`; with kGrad also d/d(cz, cy, cx) from the same taps, 0
// outside. The modes differ only in
// where a voxel's sample coordinate comes from:
//   kCoords  three (Zo, Yo, Xo) coordinate volumes (registration);
//   kAffine  12 coefficients over the output index (reslice);
//   kDisp    the output index plus a planar (3, Zo, Yo, Xo) voxel
//            displacement, rows (x, y, z), shared by the B volumes
//            (demons, DVF inversion and composition, B-spline, deformed
//            reslice). One f32 add per axis, so the twin stays bit-equal.
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

enum class Mode { kCoords, kAffine, kDisp };

struct Coef {
  float c[12];  // row-major output (x, y, z, 1) -> input (x, y, z)
};

template <Mode M, bool kGrad>
__global__ void warp_kernel(const float* __restrict__ vol, int B, int Z,
                            int Y, int X, const float* __restrict__ czp,
                            const float* __restrict__ cyp,
                            const float* __restrict__ cxp,
                            const float* __restrict__ dsp, Coef coef,
                            int Yo, int Xo, int64_t n, float bg,
                            float* __restrict__ out, float* __restrict__ gz,
                            float* __restrict__ gy, float* __restrict__ gx) {
  const int64_t vstride = (int64_t)Z * Y * X;
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
    const int64_t r00 = ((int64_t)z0 * Y + y0) * X;
    const int64_t r01 = ((int64_t)z0 * Y + y1) * X;
    const int64_t r10 = ((int64_t)z1 * Y + y0) * X;
    const int64_t r11 = ((int64_t)z1 * Y + y1) * X;
    for (int b = 0; b < B; ++b) {
      const float* v = vol + (int64_t)b * vstride;
      const float c000 = v[r00 + x0], c001 = v[r00 + x1];
      const float c010 = v[r01 + x0], c011 = v[r01 + x1];
      const float c100 = v[r10 + x0], c101 = v[r10 + x1];
      const float c110 = v[r11 + x0], c111 = v[r11 + x1];
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
        vol, B, Z, Y, X, cz, cy, cx, nullptr, none, Yo, Xo, n, bg, out, gz,
        gy, gx);
  } else {
    warp_kernel<Mode::kCoords, false><<<blocks_for(n), kThreads, 0, s>>>(
        vol, B, Z, Y, X, cz, cy, cx, nullptr, none, Yo, Xo, n, bg, out,
        nullptr, nullptr, nullptr);
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
      vol, B, Z, Y, X, nullptr, nullptr, nullptr, nullptr, coef, Yo, Xo, n,
      bg, out, nullptr, nullptr, nullptr);
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
        vol, B, Z, Y, X, nullptr, nullptr, nullptr, disp, none, Yo, Xo, n,
        bg, out, gz, gy, gx);
  } else {
    warp_kernel<Mode::kDisp, false><<<blocks_for(n), kThreads, 0, s>>>(
        vol, B, Z, Y, X, nullptr, nullptr, nullptr, disp, none, Yo, Xo, n,
        bg, out, nullptr, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
