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
// when Xd ~ Xs. At the reslice lane's shapes (R up to ~3.3e5, X 128-571)
// the least time is (R*Xs + 2*R*Xd)*4 bytes over the memory rate. The TPU
// kernel's 128-lane padding, row tiles and segmented vreg gather existed
// because a TPU core cannot gather along lanes across vregs.
//
// Design: one warp a row, a block of kWarps rows, no division by the row
// width. A lane takes 4 outputs at a time: the row's positions are read
// and its outputs written 16 bytes a lane over the aligned body of the
// row, with a scalar head and tail around it (Xd of 538 or 571 leaves most
// rows unaligned; the head and tail compute the same bits). Offsets are
// int32 inside the tensors: the wrapper refuses R * max(Xs, Xd) >= 2^31.
// The two taps of an output come from the row staged in shared memory by
// a coalesced 16-byte copy where the row holds kStageMin to kStageMax
// floats, and from the row's data through L1 otherwise (PERF.md: staging
// wins on rows of 512, L1 on rows of 128).
//
// Exactness: compiled with --fmad=false (ops/_build.py), so
// a*(1-f) + b*f is not contracted into an FMA and the plain PyTorch twin
// (ops/lane_interp.py) is bit-equal. The position is clamped in float
// before the float->int cast (a cast of NaN or inf is undefined), so every
// tap index is inside the row, and the mask is applied after.
//
// Plain C interface, loaded with ctypes; the entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStageMin = 256;    // floats of a staged row: at least,
constexpr int kStageMax = 1536;   // and at most (6 KB a warp)

// floats before the first 16-byte boundary at or after p (at most n)
__device__ __forceinline__ int head_of(const float* p, int n) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
  return min((4 - mis) & 3, n);
}

template <bool kStage>
__device__ __forceinline__ float sample(const float* __restrict__ row,
                                        float p, int Xs, float hi,
                                        float lim) {
  const float x0f = fminf(fmaxf(floorf(p), 0.f), hi);   // NaN -> 0
  const int x0 = (int)x0f;
  const int x1 = min(x0 + 1, Xs - 1);
  const float f = p - x0f;
  float a, b;
  if (kStage) {
    a = row[x0];
    b = row[x1];
  } else {
    a = __ldg(row + x0);
    b = __ldg(row + x1);
  }
  const float v = a * (1.f - f) + b * f;
  return (p > -0.5f && p < lim) ? v : 0.f;
}

// a warp copies n floats from global src to shared dst: 16 bytes a lane
// over the aligned body
__device__ __forceinline__ void stage_row(const float* __restrict__ src,
                                          float* __restrict__ dst, int n,
                                          int lane) {
  const int head = head_of(src, n);
  if (lane < head) dst[lane] = __ldg(src + lane);
  const int nq = (n - head) / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int q = lane; q < nq; q += 32) {
    const float4 v = __ldg(s4 + q);
    float* d = dst + head + 4 * q;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int j = head + 4 * nq + lane; j < n; j += 32) dst[j] = __ldg(src + j);
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
    lane_interp_kernel(const float* __restrict__ data,
                       const float* __restrict__ pos, int R, int Xs, int Xd,
                       bool vec, float* __restrict__ out) {
  extern __shared__ float stage[];   // kWarps rows of Xs floats
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;                // the whole warp: only __syncwarp below
  const float hi = (float)(Xs > 1 ? Xs - 2 : 0);
  const float lim = (float)Xs - 0.5f;
  const float* row = data + r * Xs;
  if (kStage) {
    float* sm = stage + warp * Xs;
    stage_row(row, sm, Xs, lane);
    __syncwarp();
    row = sm;
  }
  const float* prow = pos + r * Xd;
  float* orow = out + r * Xd;
  // pos and out share their alignment (vec), so one head serves both
  const int head = vec ? head_of(prow, Xd) : 0;
  if (lane < head) orow[lane] = sample<kStage>(row, __ldg(prow + lane), Xs,
                                               hi, lim);
  const int nq = vec ? (Xd - head) / 4 : 0;
  const float4* p4 = reinterpret_cast<const float4*>(prow + head);
  float4* o4 = reinterpret_cast<float4*>(orow + head);
  for (int q = lane; q < nq; q += 32) {
    const float4 p = __ldg(p4 + q);
    float4 o;
    o.x = sample<kStage>(row, p.x, Xs, hi, lim);
    o.y = sample<kStage>(row, p.y, Xs, hi, lim);
    o.z = sample<kStage>(row, p.z, Xs, hi, lim);
    o.w = sample<kStage>(row, p.w, Xs, hi, lim);
    o4[q] = o;
  }
  for (int j = head + 4 * nq + lane; j < Xd; j += 32)
    orow[j] = sample<kStage>(row, __ldg(prow + j), Xs, hi, lim);
}

}  // namespace

// R * max(Xs, Xd) < 2^31 (the wrapper checks), Xs >= 1.
extern "C" int mia_lane_interp(const float* data, const float* pos,
                               int64_t R, int Xs, int Xd, float* out,
                               void* stream) {
  if (R == 0 || Xd == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(pos) ^
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const unsigned blocks = (unsigned)((R + kWarps - 1) / kWarps);
  if (Xs >= kStageMin && Xs <= kStageMax) {
    const size_t smem = (size_t)kWarps * Xs * sizeof(float);
    lane_interp_kernel<true><<<blocks, kThreads, smem, st>>>(
        data, pos, (int)R, Xs, Xd, vec, out);
  } else {
    lane_interp_kernel<false><<<blocks, kThreads, 0, st>>>(
        data, pos, (int)R, Xs, Xd, vec, out);
  }
  return (int)cudaGetLastError();
}
