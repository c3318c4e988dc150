// One tracking level for a whole batch of rows, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/episode_track.py::
// track_level_pallas (_track_level_kernel), which handles one episode's
// level and is vmapped over episodes in JAX. Here one launch takes every
// row of a candidate batch: t_prev, v_prev, t_next f32[R, cap] with per-row
// windows t_low, t_high f32[R], and writes
//     v_next[r, i] = max{v_prev[r, j] : t_next[r, i] - hi <= t_prev[r, j]
//                                        < t_next[r, i] - lo}
// (-inf where the window is empty or t_next is not finite).
//
// What bounds it on an H100: device-memory bytes. Three [R, cap] f32 rows in
// and one out (2.15 GB at the level-2 shape [4096, 32768]) for a handful of
// compares per next event. The TPU kernel tiles the time axis into VMEM
// blocks and does a (BN, BP) broadcast compare per tile pair; on Hopper that
// would spend BN x BP compares to find a window of a few events. Instead
// each thread owns one next event: a binary search in its sorted prev row
// finds t - hi, then a forward walk reads the window while s < t - lo
// (track_common.cuh). Threads of a warp take neighbouring next events, so
// t_next and v_next are read and written coalesced and their windows sit in
// the same few prev cache lines.
//
// Every window is scanned exactly, so the result does not depend on the
// reference's tiles or its window_tiles cap (which the Python side flags).

#include "track_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, repro::kBlocksPerSm)
track_level_kernel(
    const float* __restrict__ t_prev,   // [R, cap] sorted, +inf padded
    const float* __restrict__ v_prev,   // [R, cap] latest starts, -inf padded
    const float* __restrict__ t_next,   // [R, cap] sorted, +inf padded
    const float* __restrict__ t_low,    // [R]
    const float* __restrict__ t_high,   // [R]
    float* __restrict__ v_next,         // [R, cap]
    int rows, int cap) {
  const size_t total = (size_t)rows * cap;
  for (size_t k = (size_t)blockIdx.x * kThreads + threadIdx.x; k < total;
       k += (size_t)gridDim.x * kThreads) {
    const size_t r = k / cap;
    const size_t base = r * cap;
    v_next[k] = repro::window_max(t_prev + base, v_prev + base, cap, t_next[k],
                                  t_low[r], t_high[r]);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int repro_track_level(const float* t_prev, const float* v_prev,
                      const float* t_next, const float* t_low,
                      const float* t_high, float* v_next, int rows, int cap,
                      int grid, void* stream) {
  if (rows > 0) {
    track_level_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        t_prev, v_prev, t_next, t_low, t_high, v_next, rows, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
