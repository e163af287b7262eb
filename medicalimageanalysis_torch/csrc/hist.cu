// Cumulative dose histogram for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces medicalimageanalysis_tpu/ops/pallas_kernels.py::_hist_kernel
// (reached through _pallas_hist and dose_below_histogram). It computes
// what the TPU kernel computes,
//     counts[i] = sum_j (valid[j] > 0) && (dose[j] < thr[i]),
// for n_bins thresholds over N voxels; the DVH curve and the VS-bin counts
// of the DVH statistics are this function.
//
// What bounds it: bytes. The function reads 8 bytes a voxel, and against
// sorted thresholds it needs about log2(n_bins + 1) compares a voxel. The
// TPU kernel compares every voxel with every threshold (N * n_bins), which
// at 300 bins is bound by issue rate, not bytes.
//
// Design: a binary search of sorted thresholds, with exact int64 counts.
//   - The wrapper (ops/hist.py) sorts the thresholds once on the device,
//     with their permutation; NaN thresholds sort last.
//   - Main pass (dose_hist_count): persistent blocks walk the voxels
//     grid-stride, 16 bytes of dose and of valid a thread where both are
//     aligned, one voxel a thread otherwise and for the ragged tail. A
//     voxel whose `valid > 0` is false, or whose dose is NaN or +inf, is
//     skipped (no threshold t has +inf < t). Otherwise the thread finds
//     p = #{k : s_k <= d} over the sorted thresholds s in ceil(log2(n+1))
//     branch-free steps, unrolled (the depth is a template parameter, one
//     instantiation for each power of two up to kSharedBins); NaN
//     thresholds compare as +inf there. Then
//         d < s_j  <=>  p <= j,
//     so the voxel falls in interval p of a histogram over [0, n); p == n
//     (d at or above every threshold) counts for none and is dropped.
//   - The add is warp-aggregated (__match_any_sync, then one add of the
//     popcount by the lowest lane): the path's doses are strongly peaked
//     (the PTV at its prescription), and a whole warp would otherwise hit
//     one slot.
//   - Up to kSharedBins thresholds, the sorted thresholds (padded with +inf
//     to a power of two) and the block's interval counts (int32) sit in
//     shared memory; the block adds its non-zero slots to a uint64 scratch
//     array with one atomicAdd each. A block takes at most kBlockVoxels
//     voxels (the launch sizes the grid for it), so its int32 slots cannot
//     overflow. Above kSharedBins the same kernel searches the thresholds
//     in global memory (through L1) and adds to the uint64 scratch there.
//   - Finish (dose_hist_finish, one block): the inclusive prefix of the
//     scratch array, counts_sorted[j] = sum_{p <= j} scratch[p], scattered
//     through the permutation, counts[perm[j]], with 0 for NaN thresholds
//     (d < NaN is false). Ties (equal thresholds, -0.0 and 0.0) and +-inf
//     doses or thresholds are exact: every count is the strict `<` of the
//     TPU kernel. The counts are exact integers; the TPU kernel's f32
//     accumulator is exact only up to 2^24 voxels a bin.
// At 300 bins on spread doses the search's random shared-memory reads
// bound the main pass, not its bytes (PERF.md, the histogram's design
// steps).
//
// Plain C interface, loaded with ctypes (ops/_build.py); the entry point
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kFinishThreads = 1024;
// shared-memory histogram up to this many thresholds: 16 KB of sorted
// thresholds and 16 KB of counts, several blocks an SM
constexpr int kSharedBins = 4095;
constexpr int kMaxLog = 12;         // log2 of the padded count at kSharedBins
constexpr int64_t kBlockVoxels = int64_t(1) << 30;   // int32 slots stay exact
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// p = #{k : s_k <= d} over P = 2^kLog thresholds in shared memory, P > n
// (so p <= n), in kLog unrolled steps; or, with kLog == 0, over the n
// thresholds in global memory in a loop of log2(P) steps. NaN thresholds
// and the padding compare as +inf (NaN <= d is false).
template <bool kShared, int kLog>
__device__ __forceinline__ int interval_of(const float* __restrict__ s,
                                           int n, int P, float d) {
  int p = 0;
  if (kLog > 0) {
#pragma unroll
    for (int lv = kLog - 1; lv >= 0; --lv) {
      const int step = 1 << lv;
      p += s[p + step - 1] <= d ? step : 0;
    }
  } else {
    for (int step = P >> 1; step > 0; step >>= 1) {
      const int k = p + step - 1;
      const float t = kShared ? s[k] : (k < n ? __ldg(s + k) : inf());
      p += t <= d ? step : 0;
    }
  }
  return p;
}

template <bool kShared, int kLog>
__device__ __forceinline__ void count_voxel(
    float d, float v, bool in, const float* __restrict__ s, int n, int P,
    int* __restrict__ h, unsigned long long* __restrict__ interval) {
  // called by all 32 lanes of a warp together
  bool take = in && v > 0.0f && d < inf();   // false for NaN dose or valid
  const int p = take ? interval_of<kShared, kLog>(s, n, P, d) : n;
  take = take && p < n;
  const unsigned peers = __match_any_sync(kFull, take ? p : -1);
  if (take && (__ffs(peers) - 1) == (int)(threadIdx.x & 31)) {
    const int c = __popc(peers);
    if (kShared) {
      atomicAdd(h + p, c);
    } else {
      atomicAdd(interval + p, (unsigned long long)c);
    }
  }
}

template <bool kShared, int kLog>
__global__ void __launch_bounds__(kThreads)
    dose_hist_count(const float* __restrict__ dose,
                    const float* __restrict__ valid, int64_t n_vox,
                    const float* __restrict__ sorted, int n, int P,
                    unsigned long long* __restrict__ interval) {
  extern __shared__ float smem[];
  float* s = smem;                              // P sorted thresholds
  int* h = reinterpret_cast<int*>(smem + P);    // n interval counts
  if (kShared) {
    for (int k = threadIdx.x; k < P; k += blockDim.x) {
      s[k] = k < n ? sorted[k] : inf();
      if (k < n) h[k] = 0;
    }
    __syncthreads();
  }
  const float* st = kShared ? s : sorted;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;

  // 16 bytes a thread where dose and valid are both aligned
  const bool vec = ((reinterpret_cast<uintptr_t>(dose) |
                     reinterpret_cast<uintptr_t>(valid)) & 15) == 0;
  const int64_t n4 = vec ? n_vox / 4 : 0;
  const float4* d4 = reinterpret_cast<const float4*>(dose);
  const float4* v4 = reinterpret_cast<const float4*>(valid);
  // loop bounds uniform across the warp (its first lane's index), so
  // every lane reaches __match_any_sync together
  for (int64_t i = gid; i - lane < n4; i += stride) {
    const bool in = i < n4;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v = d;
    if (in) {
      d = __ldg(d4 + i);
      v = __ldg(v4 + i);
    }
    count_voxel<kShared, kLog>(d.x, v.x, in, st, n, P, h, interval);
    count_voxel<kShared, kLog>(d.y, v.y, in, st, n, P, h, interval);
    count_voxel<kShared, kLog>(d.z, v.z, in, st, n, P, h, interval);
    count_voxel<kShared, kLog>(d.w, v.w, in, st, n, P, h, interval);
  }
  // the ragged tail (or every voxel, unaligned), one voxel a thread
  const int64_t rest = n_vox - 4 * n4;
  for (int64_t i = gid; i - lane < rest; i += stride) {
    const bool in = i < rest;
    const float d = in ? __ldg(dose + 4 * n4 + i) : 0.f;
    const float v = in ? __ldg(valid + 4 * n4 + i) : 0.f;
    count_voxel<kShared, kLog>(d, v, in, st, n, P, h, interval);
  }
  if (kShared) {
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int c = h[k];
      if (c != 0) atomicAdd(interval + k, (unsigned long long)c);
    }
  }
}

// One block: the inclusive prefix of the interval counts, scattered
// through the permutation; 0 for NaN thresholds.
__global__ void __launch_bounds__(kFinishThreads)
    dose_hist_finish(const unsigned long long* __restrict__ interval,
                     const float* __restrict__ sorted,
                     const int64_t* __restrict__ perm, int n,
                     long long* __restrict__ counts) {
  __shared__ unsigned long long part[kFinishThreads];
  const int t = threadIdx.x;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(t * per, n);
  const int hi = min(lo + per, n);
  unsigned long long sum = 0;
  for (int j = lo; j < hi; ++j) sum += interval[j];
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {   // Hillis-Steele
    const unsigned long long add = t >= off ? part[t - off] : 0ull;
    __syncthreads();
    part[t] += add;
    __syncthreads();
  }
  unsigned long long run = t > 0 ? part[t - 1] : 0ull;
  for (int j = lo; j < hi; ++j) {
    run += interval[j];
    const float s = sorted[j];
    counts[perm[j]] = s != s ? 0ll : (long long)run;
  }
}

int log2_above(int n) {   // the least L with 2^L > n
  int L = 0;
  while ((1 << L) <= n) ++L;
  return L;
}

// The main pass: enough blocks to fill the card, no more than the voxels
// need, and enough that no block takes more than kBlockVoxels.
template <bool kShared, int kLog>
cudaError_t count(const float* dose, const float* valid, int64_t n_vox,
                  const float* sorted, int n, int P, size_t smem,
                  unsigned long long* interval, cudaStream_t st) {
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dose_hist_count<kShared, kLog>, kThreads, smem);
  per_sm = per_sm < 1 ? 1 : per_sm;
  const int64_t need = (n_vox + 4 * kThreads - 1) / (4 * kThreads);
  int64_t blocks = (int64_t)sms * per_sm;
  blocks = blocks < need ? blocks : need;
  const int64_t floor_blocks = (n_vox + kBlockVoxels - 1) / kBlockVoxels;
  blocks = blocks > floor_blocks ? blocks : floor_blocks;
  dose_hist_count<kShared, kLog><<<(unsigned)blocks, kThreads, smem, st>>>(
      dose, valid, n_vox, sorted, n, P, interval);
  return cudaGetLastError();
}

// the shared-memory pass with the search depth log2(P) as kLog
template <int kLog>
cudaError_t count_shared(int log2P, const float* dose, const float* valid,
                         int64_t n_vox, const float* sorted, int n,
                         size_t smem, unsigned long long* interval,
                         cudaStream_t st) {
  if constexpr (kLog > kMaxLog) {
    return cudaErrorInvalidValue;
  } else {
    if (log2P != kLog) {
      return count_shared<kLog + 1>(log2P, dose, valid, n_vox, sorted, n,
                                    smem, interval, st);
    }
    return count<true, kLog>(dose, valid, n_vox, sorted, n, 1 << kLog, smem,
                             interval, st);
  }
}

}  // namespace

extern "C" {

// sorted (n,) float32: the thresholds in ascending order, NaN last; perm
// (n,) int64: sorted[j] == thr[perm[j]]; interval (n,) uint64 scratch,
// zeroed by the caller; counts (n,) int64, every entry written. n_vox >= 1,
// n >= 1. Two launches: the main pass and the finish.
int mia_dose_hist(const float* dose, const float* valid, int64_t n_vox,
                  const float* sorted, const int64_t* perm, int n,
                  unsigned long long* interval, long long* counts,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int log2P = log2_above(n);
  const cudaError_t err =
      n <= kSharedBins
          ? count_shared<1>(log2P, dose, valid, n_vox, sorted, n,
                            ((1 << log2P) + n) * sizeof(float), interval, st)
          : count<false, 0>(dose, valid, n_vox, sorted, n, 1 << log2P, 0,
                            interval, st);
  if (err != cudaSuccess) return (int)err;
  int threads = (n + 31) / 32 * 32;
  threads = threads > kFinishThreads ? kFinishThreads : threads;
  dose_hist_finish<<<1, threads, 0, st>>>(interval, sorted, perm, n, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
