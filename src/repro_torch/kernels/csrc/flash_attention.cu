// Forward flash attention on Hopper (sm_90a), f32 FMA dots.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_fwd_kernel). For q [b, s, h, hd] and k, v
// [b, s, hk, hd] (hk divides h; q head j reads kv head j / (h / hk), the
// grouped-query layout, so no repeated copy of k and v is made) it writes
//     o = softmax(q k^T * hd^-0.5, causal by index) v      in q's dtype
// with the reference's arithmetic: q, k, v widened to f32, f32 dots, an
// online softmax with f32 running max m, denominator l and accumulator,
// masked logits -1e30 (never -inf) and masked probabilities 0, and
// o = acc / max(l, 1e-30).
//
// The TPU kernel walks a (batch, head, q block, kv block) grid in order and
// carries m, l and acc in VMEM scratch from one kv step to the next. Blocks
// of a Hopper grid run in no order and share nothing, so here one block
// owns (batch, head, 64-query tile) and loops over the 64-key tiles
// itself, with m, l in shared memory and acc in registers. Causal tiles
// above the diagonal are never visited (the loop stops at the query tile's
// last row), which is the TPU kernel's pl.when skip; the ragged edge (s not
// a multiple of 64) is masked, so s need not divide the tile.
//
// What bounds it on an H100: operations. At [4, 4096, 16 q / 8 kv heads,
// 128] it does 2.2e12 causal multiply-adds' worth of FLOPs on 0.27 GB of
// bf16 input and output. This first kernel keeps every dot in f32 FMAs on
// the CUDA cores (67 TFLOP/s peak, no TF32), as the reference's f32
// accumulation of P V asks; bf16 tensor-core tiles (wgmma) are later work.
// Each thread owns a 4 x 4 block of the 64 x 64 score tile and a 4 x hd/16
// block of the output; tiles are staged in shared memory as f32 with rows
// padded by one word, so the column reads of K hit 16 different banks.
// K and V of a tile share one buffer (V is loaded while the softmax runs),
// 83 KB a block at hd = 128, so two blocks fit on a SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // query rows a block, key rows a tile
constexpr float kNeg = -1e30f;  // the reference's NEG

template <int HD>
constexpr size_t smem_bytes() {
  // q and k/v tiles [64][HD + 1], scores [64][65], m, l, corr [64] each
  return sizeof(float) *
         (2 * kTile * (HD + 1) + kTile * (kTile + 1) + 3 * kTile);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s,
                 int n_heads, int n_kv_heads, float scale, int causal) {
  constexpr int QS = HD + 1;     // padded row stride of the q and k/v tiles
  constexpr int SS = kTile + 1;  // padded row stride of the score tile
  constexpr int CW = HD / 16;    // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;               // [64][QS]
  float* kvs = qs + kTile * QS;   // [64][QS] k of a tile, then its v
  float* ss = kvs + kTile * QS;   // [64][SS] scores, then probabilities
  float* m_s = ss + kTile * SS;   // [64] running max
  float* l_s = m_s + kTile;       // [64] running denominator
  float* c_s = l_s + kTile;       // [64] this tile's correction exp(m - m')

  const int nq = (s + kTile - 1) / kTile;
  // causal: the longest rows first, so the last wave is short
  const int qt = causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t q_stride = (size_t)n_heads * HD;     // between positions
  const size_t kv_stride = (size_t)n_kv_heads * HD;
  const T* qb = q + (size_t)b * s * q_stride + (size_t)h * HD;
  T* ob = o + (size_t)b * s * q_stride + (size_t)h * HD;
  const T* kb = k + (size_t)b * s * kv_stride + (size_t)hk * HD;
  const T* vb = v + (size_t)b * s * kv_stride + (size_t)hk * HD;

  for (int i = tid; i < kTile * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, row = q0 + r;
    qs[r * QS + c] = row < s ? repro::to_f32(qb[row * q_stride + c]) : 0.f;
  }
  if (tid < kTile) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(s, q0 + kTile) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the last tile's reads of kvs and ss are done
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int r = i / HD, c = i % HD, row = k0 + r;
      kvs[r * QS + c] = row < s ? repro::to_f32(kb[row * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4 + i, columns tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kvs[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const bool live = k0 + c < s && (!causal || k0 + c <= q0 + r);
        ss[r * SS + c] = live ? sc[i][j] * scale : kNeg;
      }
    }
    __syncthreads();

    // v of the tile into the k buffer, while four threads a row run the
    // online softmax over its 64 scores
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int r = i / HD, c = i % HD, row = k0 + r;
      kvs[r * QS + c] = row < s ? repro::to_f32(vb[row * kv_stride + c]) : 0.f;
    }
    {
      const int r = tid / 4, part = tid % 4;
      float* srow = ss + r * SS;
      float mx = kNeg;
      for (int c = part; c < kTile; c += 4) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kTile; c += 4) {
        const bool live = k0 + c < s && (!causal || k0 + c <= q0 + r);
        const float p = live ? expf(srow[c] - m_new) : 0.f;
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[4], vv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty * 4 + i) * SS + c];
#pragma unroll
      for (int j = 0; j < CW; ++j) vv[j] = kvs[c * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, row = q0 + r;
    if (row >= s) continue;
    const float l_safe = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      ob[row * q_stride + tx + 16 * j] = repro::from_f32<T>(acc[i][j] / l_safe);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int s, int n_heads, int n_kv_heads, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kTile - 1) / kTile, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, n_heads, n_kv_heads,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch,
             int s, int n_heads, int n_kv_heads, int head_dim, float scale,
             int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, s, n_heads, n_kv_heads, scale,
                           causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, s, n_heads, n_kv_heads, scale,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, s, n_heads, n_kv_heads, scale,
                            causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for q [batch, s, n_heads, head_dim] and
// k, v [batch, s, n_kv_heads, head_dim], all f32 (bf16 = 0) or all bf16,
// with the logits' scale (the reference's f32 hd ** -0.5); returns
// cudaGetLastError() (0 = launched).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int batch, int s, int n_heads,
                          int n_kv_heads, int head_dim, int bf16, int causal,
                          float scale, void* stream) {
  if (batch == 0 || s == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, batch, s, n_heads,
                                        n_kv_heads, head_dim, scale, causal,
                                        st)
              : dispatch<float>(q, k, v, o, batch, s, n_heads, n_kv_heads,
                                head_dim, scale, causal, st);
}

}  // extern "C"
