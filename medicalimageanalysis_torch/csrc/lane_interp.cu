// Per-row 1-D linear interpolation for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces medicalimageanalysis_tpu/ops/pallas_kernels.py::_lane_interp_kernel
// (reached through lane_interp / shear_x), the building block of the
// three-pass shear-warp reslice. For data (R, Xs) and positions (R, Xd),
// both float32 and row-major:
//
//   x0f = clamp(floor(pos), 0, Xs - 2)      (0 when Xs == 1)
//   f   = pos - x0f
//   out = data[r, x0] * (1 - f) + data[r, x1] * f,   x1 = min(x0 + 1, Xs - 1)
//   out = 0 unless -0.5 < pos < Xs - 0.5    (NaN and +-inf give 0)
//
// in the operation order of the JAX package's XLA twin (_lane_interp_xla).
// For Xs >= 2, x1 is x0 + 1 as there; Xs == 1 reads the one column twice
// (the JAX package's two routes disagree there: ROADMAP.md queue 3).
//
// What bounds it: bytes. Each output reads one position and two data
// values and writes one float; the data rows are read about once each
// when Xd ~ Xs. At the reslice lane's shapes (R up to ~3e5, X ~ 128-530)
// the least time is (R*Xs + 2*R*Xd)*4 bytes over the memory rate. The TPU
// kernel's 128-lane padding, row tiles and segmented vreg gather existed
// because a TPU core cannot gather along lanes across vregs; here one
// thread per output element (grid-stride loop, int64 offsets) reads its
// two taps from global memory, and neighbouring threads read neighbouring
// columns of one row, so the taps of a warp fall in one or two cache lines
// of the row. Staging a row in shared memory is a later design.
//
// Exactness: compiled with --fmad=false (ops/_build.py), so
// a*(1-f) + b*f is not contracted into an FMA and the plain PyTorch twin
// (ops/lane_interp.py) is bit-equal. The position is clamped in float
// before the float->int cast (a cast of NaN or inf is undefined), and no
// load goes through an unclamped index.
//
// Plain C interface, loaded with ctypes; the entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lane_interp_kernel(const float* __restrict__ data,
                                   const float* __restrict__ pos, int Xs,
                                   int Xd, int64_t n,
                                   float* __restrict__ out) {
  const float hi = (float)(Xs > 1 ? Xs - 2 : 0);
  const float lim = (float)Xs - 0.5f;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const float p = pos[i];
    float v = 0.f;
    if (p > -0.5f && p < lim) {
      const float x0f = fminf(fmaxf(floorf(p), 0.f), hi);
      const int x0 = (int)x0f;
      const int x1 = min(x0 + 1, Xs - 1);
      const float f = p - x0f;
      const float* row = data + (i / Xd) * (int64_t)Xs;
      v = row[x0] * (1.f - f) + row[x1] * f;
    }
    out[i] = v;
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int mia_lane_interp(const float* data, const float* pos,
                               int64_t R, int Xs, int Xd, float* out,
                               void* stream) {
  const int64_t n = R * (int64_t)Xd;
  if (n == 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride loop covers the rest
  lane_interp_kernel<<<(int)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(data, pos, Xs,
                                                            Xd, n, out);
  return (int)cudaGetLastError();
}
