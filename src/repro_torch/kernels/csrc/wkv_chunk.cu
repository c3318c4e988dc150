// Chunked RWKV6 WKV recurrence on Hopper (sm_90a), all in f32.
//
// Replaces the TPU kernel src/repro/kernels/wkv_chunk.py::wkv_chunked
// (_wkv_kernel). Per (batch, head) the recurrence over T tokens
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,  o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
// runs chunk by chunk with the reference's algebra: for a chunk of L
// tokens with log decays lw (<= 0), bcum = cumsum(lw), bex = bcum - lw,
// btot = bcum[L-1];
//     qp = r e^(bex - btot),  kp = k e^(btot - bcum)
//     o  = tril(qp kp^T, -1) v + (sum_i r u k) v + (r e^bex) S
//     S <- e^btot S + kp^T v
// The [hd, hd] state S is carried from chunk to chunk.
//
// The TPU kernel walks a (batch, head, chunk) grid in order and carries S in
// VMEM scratch from one grid step to the next. Blocks of a Hopper grid run
// in no order, so here the chunk axis is a loop inside the block. Columns
// of S and of o are independent (column j depends on v[:, j] only), so the
// grid is (hd / 16 column blocks, heads, batch) and each block keeps its
// 16 columns of S in shared memory for the whole sequence: 640 blocks at
// [4, 4096, 40, 64], enough for the 132 SMs. The chunk's per-channel
// cumulative decays and its L x L score tile do not depend on the columns
// and are recomputed by each of a head's column blocks.
//
// What bounds it on an H100: device-memory bytes at the model's shapes (one
// read of r, k, v, lw and one write of o, 0.84 GB in f32 at the shape
// above, against about 0.04 TFLOP). The chunk's r, k and lw rows are read
// by each of the hd / 16 column blocks of the head, close together in time,
// so the repeats come from L2.
//
// Exponents: e^(bex - btot) reaches (L - 1) * 1.5 with the model's decay
// clamp, 46.5 at L = 32; expf overflows above 88.7, so callers keep L small
// (the model passes cfg.rwkv_chunk), as the reference must.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 16;      // state columns a block owns
constexpr int kMaxChunk = 64;  // the wrapper's limit on L

template <int HD>
size_t smem_floats(int L) {
  // r, k, lw -> bex, bcum tiles [L][HD + 1]; v [L][16]; scores [L][L + 1];
  // beta [L]; u, btot, e^btot [HD]; S [HD][16]
  return 4 * (size_t)L * (HD + 1) + (size_t)L * kCols + (size_t)L * (L + 1) +
         L + 3 * HD + HD * kCols;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, T* __restrict__ o, int n_tok,
           int n_heads, int L) {
  constexpr int RS = HD + 1;  // padded row stride of the channel tiles
  extern __shared__ float smem[];
  float* rs = smem;                 // r, then r e^bex
  float* ks = rs + L * RS;          // k
  float* ws = ks + L * RS;          // lw, then bex, then qp
  float* cs = ws + L * RS;          // bcum, then kp
  float* vs = cs + L * RS;          // [L][16] this block's columns of v
  float* sc = vs + L * kCols;       // [L][L + 1] strictly causal scores
  float* beta = sc + L * (L + 1);   // [L] sum_i r u k
  float* us = beta + L;             // [HD] u of the head
  float* btot = us + HD;            // [HD] the chunk's total log decay
  float* dec = btot + HD;           // [HD] e^btot
  float* st = dec + HD;             // [HD][16] this block's columns of S

  const int jb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t tok_stride = (size_t)n_heads * HD;
  const size_t base = (size_t)b * n_tok * tok_stride + (size_t)h * HD;
  for (int i = tid; i < HD * kCols; i += kThreads) st[i] = 0.f;
  for (int i = tid; i < HD; i += kThreads) us[i] = u[h * HD + i];

  for (int t0 = 0; t0 < n_tok; t0 += L) {
    __syncthreads();  // the last chunk's reads of every tile are done
    for (int i = tid; i < L * HD; i += kThreads) {
      const int t = i / HD, c = i % HD;
      const size_t g = base + (t0 + t) * tok_stride + c;
      rs[t * RS + c] = repro::to_f32(r[g]);
      ks[t * RS + c] = repro::to_f32(k[g]);
      ws[t * RS + c] = logw[g];
    }
    for (int i = tid; i < L * kCols; i += kThreads) {
      const int t = i / kCols, j = i % kCols;
      vs[i] = repro::to_f32(v[base + (t0 + t) * tok_stride + jb * kCols + j]);
    }
    __syncthreads();

    // the current-token bonus coefficient, one thread a token
    for (int t = tid; t < L; t += kThreads) {
      float acc = 0.f;
      for (int c = 0; c < HD; ++c) {
        acc = fmaf(rs[t * RS + c] * us[c], ks[t * RS + c], acc);
      }
      beta[t] = acc;
    }
    // cumulative decays, one thread a channel
    for (int c = tid; c < HD; c += kThreads) {
      float cum = 0.f;
      for (int t = 0; t < L; ++t) {
        const float lw = ws[t * RS + c];
        cum += lw;
        cs[t * RS + c] = cum;
        ws[t * RS + c] = cum - lw;
      }
      btot[c] = cum;
      dec[c] = expf(cum);
    }
    __syncthreads();
    for (int i = tid; i < L * HD; i += kThreads) {
      const int t = i / HD, c = i % HD;
      const float bex = ws[t * RS + c], rv = rs[t * RS + c];
      ws[t * RS + c] = rv * expf(bex - btot[c]);                   // qp
      rs[t * RS + c] = rv * expf(bex);                             // r e^bex
      cs[t * RS + c] = ks[t * RS + c] * expf(btot[c] - cs[t * RS + c]);  // kp
    }
    __syncthreads();
    // scores[t][s] = qp_t . kp_s for s < t
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, s = i % L;
      if (s >= t) continue;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < HD; ++c) {
        acc = fmaf(ws[t * RS + c], cs[s * RS + c], acc);
      }
      sc[t * (L + 1) + s] = acc;
    }
    __syncthreads();

    // o = (intra + bonus) + carry, for this block's columns
    for (int i = tid; i < L * kCols; i += kThreads) {
      const int t = i / kCols, j = i % kCols;
      float intra = 0.f;
      for (int s = 0; s < t; ++s) {
        intra = fmaf(sc[t * (L + 1) + s], vs[s * kCols + j], intra);
      }
      float carry = 0.f;
#pragma unroll 8
      for (int c = 0; c < HD; ++c) {
        carry = fmaf(rs[t * RS + c], st[c * kCols + j], carry);
      }
      const float out = (intra + beta[t] * vs[t * kCols + j]) + carry;
      o[base + (t0 + t) * tok_stride + jb * kCols + j] =
          repro::from_f32<T>(out);
    }
    __syncthreads();
    // S <- e^btot S + kp^T v
    for (int i = tid; i < HD * kCols; i += kThreads) {
      const int c = i / kCols, j = i % kCols;
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        acc = fmaf(cs[t * RS + c], vs[t * kCols + j], acc);
      }
      st[i] = dec[c] * st[i] + acc;
    }
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, void* o, int batch, int n_tok, int n_heads, int L,
           cudaStream_t stream) {
  const size_t smem = smem_floats<HD>(L) * sizeof(float);
  auto kernel = wkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(HD / kCols, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, static_cast<T*>(o), n_tok, n_heads,
      L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* logw,
             const float* u, void* o, int batch, int n_tok, int n_heads,
             int head_dim, int L, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(r, k, v, logw, u, o, batch, n_tok, n_heads, L,
                           stream);
    case 32:
      return launch<T, 32>(r, k, v, logw, u, o, batch, n_tok, n_heads, L,
                           stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, o, batch, n_tok, n_heads, L,
                           stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for r, k, v [batch, n_tok, n_heads,
// head_dim] (all f32, bf16 = 0, or all bf16), logw f32 of the same shape,
// u f32 [n_heads, head_dim] and chunks of `chunk` tokens (chunk divides
// n_tok, 1 <= chunk <= 64); o has r's shape and type. Returns
// cudaGetLastError() (0 = launched).
int repro_wkv_chunk(const void* r, const void* k, const void* v,
                    const float* logw, const float* u, void* o, int batch,
                    int n_tok, int n_heads, int head_dim, int chunk, int bf16,
                    void* stream) {
  if (batch == 0 || n_tok == 0) return 0;
  if (chunk < 1 || chunk > kMaxChunk || n_tok % chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, logw, u, o, batch, n_tok,
                                        n_heads, head_dim, chunk, st)
              : dispatch<float>(r, k, v, logw, u, o, batch, n_tok, n_heads,
                                head_dim, chunk, st);
}

}  // extern "C"
