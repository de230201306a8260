// Weight and bias gradients of a stride-1 conv1d, with or without a fused
// snake-beta on its input, bf16 in, f32 out, for Hopper (sm_90a).
//
// Replaces the TPU kernels stable_audio_tools_tpu/ops/kernels/conv1d_snake.py
// `_bwd_dw_kernel_snake` (kSnake = true; reached from `_snake_conv1d_bwd`
// through `_run_bwd_dw`) and `_bwd_dw_kernel_plain` (kSnake = false; reached
// from `conv1d_wgrad`, which ops/conv.py `_conv1d_s1_bwd` calls):
//
//   dW[co, ci, j] = sum_b sum_t dy[b, co, t] * s(x)pad[b, ci, t + j*d]
//   db[co]        = sum_b sum_t dy[b, co, t]
//
// with s = snake(x; alpha, beta) (exact sinf in f32, rounded to bf16 as the
// forward kernel rounds it) or the identity, and xpad[t'] = x[t' - pad_lo],
// exactly 0 outside [0, L) (JAX `_snake_window`). Products of bf16 values
// accumulate in f32.
//
// Layout: dy [B, Co, Lout] and x [B, Ci, L] (channels before time); dW
// [Co, Ci, k] (torch's weight layout) and db [Co], both f32.
//
// On the TPU the [k, Ci, CoB] accumulator stays resident across a sequential
// grid over B*L. On Hopper blocks run in parallel and in no order, so the
// reduction over B*L is split: block (ci tile + tap j, co tile, split s)
// computes a 64 x 64 tile of one tap's product over its contiguous share of
// the (batch, 64-sample step) sequence and writes it to a workspace
// [S, k, Co, Ci] (db partials [S, Co] from the blocks of ci tile 0, tap 0);
// `conv1d_wgrad_reduce` then sums the S partials in a fixed order and writes
// dW and db. No atomics: the result does not depend on the schedule.
//
// Each step loads the [64 co x 64 t] dy tile and the [64 ci x 64 t] window of
// x shifted by j*d (the snake applied in f32 on the way, tails and padding
// zero-filled) into shared memory, time-contiguous, and 8 warps accumulate
// the 4 x 4 16x16 fragments with WMMA bf16 (A row-major from dy, B
// column-major from x, f32 accumulators).
//
// Bound on the H100: 2*B*Lout*Ci*Co*k operations; at the Oobleck path's
// widths that is tensor-core bound except for the narrow convs (Ci = 2 of the
// encoder's conv_in, 128 -> 2 of the decoder's conv_out), which are bound by
// reading dy and x. What the design does about it: tensor cores, the snake
// recomputed in the load (s(x) never reaches device memory), and a split of
// B*L sized to put ~4 blocks per SM in flight. Loads are synchronous and
// scalar, and each tap re-reads its tiles (from L2), so it stays well below
// the peak: a cp.async ring and one block per tile over all taps are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TC = 64;        // co per block
constexpr int TI = 64;        // ci per block
constexpr int NK = 64;        // time samples per step (the reduction)
constexpr int LDA = NK + 8;   // bf16 row stride of both tiles (144 B)
constexpr int LDC = TI + 4;   // f32 row stride of the output stage
constexpr int THREADS = 256;
constexpr int SMEM = 2 * 64 * LDA * 2;  // 18,432 B; the stage (17,408 B) aliases it

template <bool kSnake>
__global__ void __launch_bounds__(THREADS)
conv1d_wgrad_kernel(const __nv_bfloat16* __restrict__ dy,  // [B, Co, Lout]
                    const __nv_bfloat16* __restrict__ x,   // [B, Ci, L]
                    const float* __restrict__ alpha,
                    const float* __restrict__ beta,
                    float* __restrict__ ws,                // [S, k, Co, Ci]
                    float* __restrict__ dbws,              // [S, Co]
                    int B, int Co, int Ci, int L, int Lout, int k, int d,
                    int pad_lo, int steps_per_split) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [TC][LDA] dy
  __nv_bfloat16* Bs = As + TC * LDA;                            // [TI][LDA] s(x)
  float* stage = reinterpret_cast<float*>(smem);                // [TC][LDC]

  const int n_ci = (Ci + TI - 1) / TI;
  const int ci0 = (blockIdx.x % n_ci) * TI;
  const int j = blockIdx.x / n_ci;
  const int co0 = blockIdx.y * TC;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const bool do_db = dbws != nullptr && blockIdx.x == 0;

  const int tsteps = (Lout + NK - 1) / NK;
  const int first = split * steps_per_split;
  const int last = min(first + steps_per_split, B * tsteps);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const int fr = warp / 2;          // co fragment row of this warp
  const int fc = (warp % 2) * 2;    // first of its two ci fragment columns
  float db = 0.f;

  for (int step = first; step < last; ++step) {
    const int b = step / tsteps;
    const int t0 = (step % tsteps) * NK;
    __syncthreads();  // the previous step's fragments are loaded
    for (int i = threadIdx.x; i < TC * NK; i += THREADS) {
      const int n = i % NK, c = i / NK;
      const int co = co0 + c, t = t0 + n;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (co < Co && t < Lout) v = dy[((size_t)b * Co + co) * Lout + t];
      As[c * LDA + n] = v;
    }
    for (int i = threadIdx.x; i < TI * NK; i += THREADS) {
      const int n = i % NK, c = i / NK;
      const int ci = ci0 + c, t = t0 + n;
      const int pos = t + j * d - pad_lo;
      float v = 0.f;
      if (ci < Ci && t < Lout && pos >= 0 && pos < L) {
        v = __bfloat162float(x[((size_t)b * Ci + ci) * L + pos]);
        if (kSnake) {
          const float s = sinf(alpha[ci] * v);
          v = v + s * s * (1.f / (beta[ci] + 1e-9f));
        }
      }
      Bs[c * LDA + n] = __float2bfloat16(v);
    }
    __syncthreads();
    if (do_db && threadIdx.x < TC) {
      for (int n = 0; n < NK; ++n) db += __bfloat162float(As[threadIdx.x * LDA + n]);
    }
#pragma unroll
    for (int kk = 0; kk < NK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::load_matrix_sync(af, As + fr * 16 * LDA + kk, LDA);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, Bs + (fc + q) * 16 * LDA + kk, LDA);
        wmma::mma_sync(acc[q], af, bf, acc[q]);
      }
    }
  }
  __syncthreads();  // the stage aliases the tiles
#pragma unroll
  for (int q = 0; q < 2; ++q)
    wmma::store_matrix_sync(stage + fr * 16 * LDC + (fc + q) * 16, acc[q], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  float* out = ws + ((size_t)split * k + j) * Co * Ci;
  for (int i = threadIdx.x; i < TC * TI; i += THREADS) {
    const int o = i % TI, c = i / TI;
    const int co = co0 + c, ci = ci0 + o;
    if (co < Co && ci < Ci) out[(size_t)co * Ci + ci] = stage[c * LDC + o];
  }
  if (do_db && threadIdx.x < TC && co0 + threadIdx.x < Co)
    dbws[(size_t)split * Co + co0 + threadIdx.x] = db;
}

// dW[co, ci, j] = sum_s ws[s, j, co, ci]; db[co] = sum_s dbws[s, co]
__global__ void conv1d_wgrad_reduce(const float* __restrict__ ws,
                                    const float* __restrict__ dbws,
                                    float* __restrict__ dW, float* __restrict__ db,
                                    int S, int k, int Co, int Ci) {
  const size_t n_w = (size_t)Co * Ci * k;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_w) {
    const int j = i % k;
    const size_t coci = i / k;  // co * Ci + ci
    float s = 0.f;
    for (int p = 0; p < S; ++p) s += ws[((size_t)p * k + j) * Co * Ci + coci];
    dW[i] = s;
  } else if (db != nullptr && i < n_w + Co) {
    const int co = i - n_w;
    float s = 0.f;
    for (int p = 0; p < S; ++p) s += dbws[(size_t)p * Co + co];
    db[co] = s;
  }
}

}  // namespace

// Blocks of one split: the wrapper picks S from it and allocates the
// workspace [S, k, Co, Ci] and [S, Co].
extern "C" int conv1d_wgrad_tiles(int Co, int Ci, int k) {
  return ((Ci + TI - 1) / TI) * k * ((Co + TC - 1) / TC);
}

extern "C" int conv1d_wgrad(const void* dy, const void* x, const void* alpha,
                            const void* beta, void* ws, void* dbws, void* dW, void* db,
                            int B, int Co, int Ci, int L, int Lout, int k, int d,
                            int pad_lo, int S, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int total = B * ((Lout + NK - 1) / NK);
  const int per = (total + S - 1) / S;
  dim3 grid(((Ci + TI - 1) / TI) * k, (Co + TC - 1) / TC, S);
  if (alpha != nullptr)
    conv1d_wgrad_kernel<true><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)dy, (const __nv_bfloat16*)x, (const float*)alpha,
        (const float*)beta, (float*)ws, (float*)dbws, B, Co, Ci, L, Lout, k, d, pad_lo, per);
  else
    conv1d_wgrad_kernel<false><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)dy, (const __nv_bfloat16*)x, nullptr, nullptr, (float*)ws,
        (float*)dbws, B, Co, Ci, L, Lout, k, d, pad_lo, per);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t n = (size_t)Co * Ci * k + (db != nullptr ? Co : 0);
  conv1d_wgrad_reduce<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)ws, (const float*)dbws, (float*)dW, (float*)db, S, k, Co, Ci);
  return (int)cudaGetLastError();
}
