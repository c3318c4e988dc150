// Multi-level tracking of a whole candidate batch in one launch, on Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/episode_track.py::
// track_batch_pallas (_track_batch_kernel). Per row of a [B, N, cap]
// symbol-time table it runs every level of the dense tracking recurrence
// (track_common.cuh), seeding level 0 from the first symbol's own finite
// times, and emits
//   starts f32[B, cap]  the final level's latest starts: -inf where no
//                       occurrence reaches that event, not yet masked for
//                       end validity (the engine does that);
//   n_superset i32[B]   the level-0 finite count plus, at every level, the
//                       count of reachable events.
// It is count_batch.cu's tracking half without compaction and greedy.
//
// What bounds it on an H100: device-memory bytes (the [B, N, cap] table in,
// the [B, cap] starts out). Layout: one thread block per row, grid-stride
// over rows, as in count_batch.cu. The latest-start vector of the levels
// between the first and the last ping-pongs between the row's own starts
// output and one scratch row per block ([grid, cap], allocated by the
// wrapper, L2-resident while the block works on it), arranged so that the
// last level lands in the output. Every window is scanned exactly, so the
// result does not depend on the reference's tiles.

#include "track_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, repro::kBlocksPerSm)
track_batch_kernel(
    const float* __restrict__ times,    // [B, N, cap] sorted, +inf padded
    const float* __restrict__ t_low,    // [B, N-1]
    const float* __restrict__ t_high,   // [B, N-1]
    float* __restrict__ starts,         // [B, cap]
    int* __restrict__ n_superset,       // [B]
    float* __restrict__ scratch,        // [gridDim.x, cap]
    int batch, int n, int cap) {
  __shared__ int nsup_total;
  const int levels = n - 1;
  float* const spare = scratch + (size_t)blockIdx.x * cap;

  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    const float* rows = times + (size_t)b * n * cap;
    float* const out = starts + (size_t)b * cap;
    if (threadIdx.x == 0) nsup_total = 0;
    int nsup = repro::count_finite_block<kThreads>(rows, cap);

    const float* vcur = nullptr;   // level 0 seeds from the prev times
    for (int l = 0; l < levels; ++l) {
      // the buffers alternate and the last level (levels - 1) writes `out`
      float* const vnext = ((levels - 1 - l) & 1) ? spare : out;
      nsup += repro::track_level_block<kThreads>(
          rows + (size_t)l * cap, vcur, rows + (size_t)(l + 1) * cap, vnext,
          cap, t_low[(size_t)b * levels + l], t_high[(size_t)b * levels + l]);
      __syncthreads();
      vcur = vnext;
    }

    repro::block_sum(nsup, &nsup_total);
    if (threadIdx.x == 0) n_superset[b] = nsup_total;
    __syncthreads();   // the scratch row and nsup_total are reused next row
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int repro_track_batch(const float* times, const float* t_low,
                      const float* t_high, float* starts, int* n_superset,
                      float* scratch, int batch, int n, int cap, int grid,
                      void* stream) {
  if (batch > 0) {
    track_batch_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        times, t_low, t_high, starts, n_superset, scratch, batch, n, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
