// Device code shared by the tracking kernels (count_batch.cu,
// track_batch.cu, track_level.cu): the dense tracking recurrence of the
// reference's src/repro/kernels/episode_track.py, one window at a time.
//
// For a next event t of symbol l+1 the latest start reaching it is the max
// of the previous level's latest starts over prev events s with
//     t - hi <= s < t - lo        (f32; both edges one subtract each)
// exactly as the reference compares (episode_track.py:79-80, :189-190),
// -inf when the window is empty or t is not finite. Rows are sorted
// ascending with +inf padding (the type index guarantees it), so the window
// is a contiguous run: its first index is found by binary search and the
// run is walked until s >= t - lo. No fast-math anywhere: every compare and
// subtract is IEEE f32, so the result equals the reference bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Resident blocks a SM every kernel is compiled for (launch bounds: at most
// 32 registers a thread at 256 threads a block); the wrappers size their
// grids for it (episode_track.py, _BLOCKS_PER_SM).
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// First index i in row[0, n) with row[i] >= x (searchsorted side='left').
__device__ __forceinline__ int lower_bound(const float* __restrict__ row, int n,
                                           float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Latest start reaching next event t through prev row tp[0, cap).
// vp == nullptr seeds level 0: each finite prev time is its own start.
__device__ __forceinline__ float window_max(const float* __restrict__ tp,
                                           const float* vp, int cap, float t,
                                           float lo, float hi) {
  float acc = neg_inf();
  if (isfinite(t)) {
    const float w_lo = t - hi;   // s >= t - hi
    const float w_hi = t - lo;   // s <  t - lo
    for (int j = lower_bound(tp, cap, w_lo); j < cap; ++j) {
      const float s = tp[j];
      if (!(s < w_hi)) break;
      acc = fmaxf(acc, vp == nullptr ? (isfinite(s) ? s : neg_inf()) : vp[j]);
    }
  }
  return acc;
}

// One level of one row, strided over the kThreads threads of a block (a
// compile-time stride keeps the loop out of a register): vnext[i] for
// every next event i. Returns this thread's count of reachable events
// (vnext > -inf). The caller synchronises before vnext is read.
template <int kThreads>
__device__ __forceinline__ int track_level_block(const float* __restrict__ tp,
                                                 const float* vp,
                                                 const float* __restrict__ tn,
                                                 float* vnext, int cap, float lo,
                                                 float hi) {
  int reached = 0;
  for (int i = threadIdx.x; i < cap; i += kThreads) {
    const float v = window_max(tp, vp, cap, tn[i], lo, hi);
    vnext[i] = v;
    reached += v > neg_inf();
  }
  return reached;
}

// Finite entries of row[0, cap), strided over the kThreads threads of a
// block (this thread's share).
template <int kThreads>
__device__ __forceinline__ int count_finite_block(const float* __restrict__ row,
                                                  int cap) {
  int n = 0;
  for (int i = threadIdx.x; i < cap; i += kThreads) n += isfinite(row[i]);
  return n;
}

// Block-wide sum of x into *total (shared, zeroed by the caller before a
// barrier). Every thread of the block must call it; *total is ready after
// the barrier at its end.
__device__ __forceinline__ void block_sum(int x, int* total) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(total, x);
  __syncthreads();
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
