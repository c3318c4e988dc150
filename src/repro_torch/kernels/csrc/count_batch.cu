// Single-launch episode count pipeline for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/episode_track.py::
// count_batch_pallas (_count_batch_kernel). Per candidate row it runs
//   1. dense tracking: for every event t of symbol l+1, the max of the
//      previous level's latest-start values over prev events s with
//      t - hi <= s < t - lo (f32, exactly as the reference computes the
//      window edges: t - hi and t - lo, never rearranged);
//   2. the paper's §IV-D count_scan_write compaction of the valid
//      (start, end) intervals: a block-wide prefix scan of keep flags;
//   3. the strict greedy non-overlap fold (take iff start > prev_end),
//      seeded with the carried (prev_end, prev_count) state.
// Only counts, end_out and n_superset leave the kernel.
//
// What bounds it on an H100: device-memory bytes. The input is the gathered
// [B, N, cap] f32 symbol-time table (1 GiB at the level-2 shape of a
// 64-neuron, 1000 s spike train); the work per byte is a handful of
// compares. The TPU kernel held a whole [R, N, cap] row chunk in VMEM (10.4
// MiB in its worst bucket), which a 227 KB Hopper block cannot hold, so the
// design here is one thread block per row (grid-stride over rows), the
// latest-start ping-pong in global scratch [grid, 2, cap] that the wrapper
// allocates (it stays L2-resident while a block works on its row), window
// edges found by binary search in the sorted prev row and the window walked
// linearly (spike data holds a handful of events per window, so each next
// event reads O(log cap + w) prev entries, and next events are read
// coalesced). The greedy fold runs on one thread over the compacted prefix
// only; binary lifting is the faster later version.
//
// Every window is scanned exactly, so the results do not depend on the
// reference's tile geometry. Rows must be sorted ascending with +inf
// padding (the type index guarantees it). No fast-math: every compare and
// subtract is IEEE f32, so counts, end_out and n_superset equal the
// reference bit for bit.

#include "track_common.cuh"

namespace {

using repro::neg_inf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Inclusive block-wide prefix sum of x; *total gets the block's sum. Every
// thread of the block must call it.
__device__ __forceinline__ int block_inclusive_scan(int x, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warp_sums[warp - 1];
  *total = warp_sums[kWarps - 1];
  return x;
}

__global__ void __launch_bounds__(kThreads, repro::kBlocksPerSm)
count_batch_kernel(
    const float* __restrict__ times,      // [B, N, cap] sorted, +inf padded
    const float* __restrict__ t_low,      // [B, N-1]
    const float* __restrict__ t_high,     // [B, N-1]
    const float* __restrict__ prev_end,   // [B]
    const int* __restrict__ prev_count,   // [B]
    int* __restrict__ counts,             // [B]
    float* __restrict__ end_out,          // [B]
    int* __restrict__ n_superset,         // [B]
    float* __restrict__ scratch,          // [gridDim.x, 2, cap]
    int batch, int n, int cap) {
  __shared__ int warp_sums[kWarps];
  __shared__ int nsup_total;
  const int levels = n - 1;
  float* const buf0 = scratch + (size_t)blockIdx.x * 2 * cap;
  float* const buf1 = buf0 + cap;

  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    const float* rows = times + (size_t)b * n * cap;
    if (threadIdx.x == 0) nsup_total = 0;
    // level 0: every finite first-symbol event seeds its own latest start
    int nsup = repro::count_finite_block<kThreads>(rows, cap);

    // --- tracking: v_{l+1}[i] = max{v_l[j] : t_{l+1}[i] - hi <= t_l[j] <
    // t_{l+1}[i] - lo}, -inf where the window is empty or t is not finite
    float* vcur = nullptr;   // level 0 seeds from the prev times themselves
    float* vnext = buf0;
    for (int l = 0; l < levels; ++l) {
      nsup += repro::track_level_block<kThreads>(
          rows + (size_t)l * cap, vcur, rows + (size_t)(l + 1) * cap, vnext,
          cap, t_low[(size_t)b * levels + l], t_high[(size_t)b * levels + l]);
      __syncthreads();
      vcur = vnext;
      vnext = vcur == buf0 ? buf1 : buf0;
    }

    // --- compaction (§IV-D count_scan_write): the k-th valid (start, end)
    // pair lands at slot k, starts in place over vcur, ends in vnext. A
    // write never passes the slot it came from, and the scan's barriers
    // order every read of a chunk before its writes.
    const float* ends = rows + (size_t)levels * cap;
    int m = 0;
    for (int i0 = 0; i0 < cap; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      float s = neg_inf(), e = 0.0f;
      int keep = 0;
      if (i < cap) {
        s = vcur[i];
        e = ends[i];
        keep = (s > neg_inf()) && isfinite(e);
      }
      int chunk_total;
      const int pos = block_inclusive_scan(keep, warp_sums, &chunk_total);
      if (keep) {
        vcur[m + pos - 1] = s;
        vnext[m + pos - 1] = e;
      }
      m += chunk_total;
      __syncthreads();   // warp_sums is reused by the next chunk's scan
    }

    // --- n_superset: block sum of the per-thread partial counts
    repro::block_sum(nsup, &nsup_total);

    // --- greedy fold over the compacted prefix, in end order
    if (threadIdx.x == 0) {
      float pe = prev_end[b];
      int taken = 0;
#pragma unroll 4
      for (int k = 0; k < m; ++k) {
        if (vcur[k] > pe) {
          pe = vnext[k];
          ++taken;
        }
      }
      counts[b] = prev_count[b] + taken;
      end_out[b] = pe;
      n_superset[b] = nsup_total;
    }
    __syncthreads();   // the scratch rows and nsup_total are reused next row
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int repro_count_batch(const float* times, const float* t_low, const float* t_high,
                      const float* prev_end, const int* prev_count, int* counts,
                      float* end_out, int* n_superset, float* scratch, int batch,
                      int n, int cap, int grid, void* stream) {
  if (batch > 0) {
    count_batch_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        times, t_low, t_high, prev_end, prev_count, counts, end_out, n_superset,
        scratch, batch, n, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
