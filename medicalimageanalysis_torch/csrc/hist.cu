// Cumulative dose histogram for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces medicalimageanalysis_tpu/ops/pallas_kernels.py::_hist_kernel
// (reached through _pallas_hist and dose_below_histogram). It computes
// what the TPU kernel computes,
//     counts[i] = sum_j (valid[j] > 0) && (dose[j] < thr[i]),
// for n_bins thresholds over N voxels; the DVH curve and the VS-bin counts
// of the DVH statistics are this function.
//
// Design. The TPU kernel walks the dose in 2048-voxel tiles on one core
// and keeps an f32 (n_bins,) accumulator in VMEM. Here:
//   - `valid` is folded into the dose while a tile is staged: a voxel
//     whose `valid > 0` is false (0, negative or NaN) becomes NaN, and
//     `NaN < t` is false for every t, so this is exact for +-inf and NaN
//     thresholds too;
//   - each block stages a tile of doses in shared memory; thread j holds
//     thresholds j and j + blockDim of its slice of bins (kPer = 2 of
//     them) and their counts in registers and compares every dose of the
//     tile with them. All threads of a warp read the same shared dose, a
//     broadcast with no bank conflict;
//   - blocks walk the tiles grid-stride, the last tile ragged: no padding
//     to 2048;
//   - each block adds its counts to the output with one 64-bit atomicAdd
//     per bin, so the counts are exact integers. (The TPU kernel's f32
//     accumulator is exact only up to 2^24 voxels per bin.)
//   - more than blockDim * kPer thresholds (512) take further slices of
//     bins on the grid's y axis, each walking the dose again, all in one
//     launch (the DVH paths use 32 or 300).
//
// What bounds it: the function needs the bytes (8 per voxel) and about
// log2(n_bins) compares per voxel against sorted thresholds, so it is
// bound by bytes. This design issues N * n_bins compares instead (37 per
// byte at 300 bins): it is bound by issue rate (one shared-memory
// broadcast, kPer compares and kPer adds per dose), not by memory.

// Plain C interface, loaded with ctypes (ops/_build.py); the entry point
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;
constexpr int kPer = 2;
constexpr int kMaxThreads = 256;

__global__ void hist_kernel(const float* __restrict__ dose,
                            const float* __restrict__ valid, int64_t n,
                            const float* __restrict__ thr, int n_bins,
                            unsigned long long* __restrict__ counts) {
  __shared__ float tile[kTile];  // doses, invalid ones as NaN
  const int nt = blockDim.x;
  const int bin_base = blockIdx.y * nt * kPer;
  float t[kPer];
  unsigned long long c[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int b = bin_base + threadIdx.x + r * nt;
    // a slot past the last bin compares against NaN: never counts
    t[r] = b < n_bins ? thr[b] : __int_as_float(0x7fc00000);
    c[r] = 0ull;
  }
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  for (int64_t tix = blockIdx.x; tix < n_tiles; tix += gridDim.x) {
    const int64_t start = tix * kTile;
    const int m = n - start < kTile ? (int)(n - start) : kTile;
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < m; i += nt) {
      const float d = dose[start + i];
      tile[i] = valid[start + i] > 0.0f ? d : __int_as_float(0x7fc00000);
    }
    __syncthreads();
    unsigned int ct[kPer];  // this tile's counts: at most kTile each
#pragma unroll
    for (int r = 0; r < kPer; ++r) ct[r] = 0u;
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const float d = tile[i];
#pragma unroll
      for (int r = 0; r < kPer; ++r) ct[r] += (d < t[r]) ? 1u : 0u;
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) c[r] += ct[r];
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int b = bin_base + threadIdx.x + r * nt;
    if (b < n_bins && c[r] != 0ull) atomicAdd(&counts[b], c[r]);
  }
}

}  // namespace

extern "C" {

// counts (n_bins,) uint64 must be zeroed by the caller; n >= 1. One launch.
int mia_dose_hist(const float* dose, const float* valid, int64_t n,
                  const float* thr, int n_bins, unsigned long long* counts,
                  void* stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // threads: enough for the bins at kPer per thread, a whole number of
  // warps, at most kMaxThreads; further bins go to the grid's y axis
  int threads = ((n_bins + kPer - 1) / kPer + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const int slices = (n_bins + threads * kPer - 1) / (threads * kPer);
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int64_t cap = (int64_t)sms * 8;
  const dim3 grid((unsigned)(n_tiles < cap ? n_tiles : cap), slices);
  hist_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      dose, valid, n, thr, n_bins, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
