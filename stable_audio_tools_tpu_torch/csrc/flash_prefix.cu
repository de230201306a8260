// Non-causal flash-attention forward with a short key/query prefix, bf16 in,
// f32 accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel stable_audio_tools_tpu/ops/kernels/flash_attention.py
// `_flash_prefix_kernel` (reached from `flash_attention_prefix` through
// `_prefix_forward` / `_flash_forward_pk`). Same function: softmax(QK^T/sqrt(d))V
// over a sequence whose first P <= 64 tokens are a prepended prefix (SA-Open's
// DiT: P = 1 global-cond token + 1024 latent tokens), plus the f32 logsumexp.
//
// Layout: q, k, v, out are [B, H, N, 64] (the JAX package's public layout at
// attention_core), contiguous; lse is [B, H, N] f32. Rows [0, P) are the
// prefix, rows [P, N) the main sequence.
//
// Grid: one 128-thread block (4 warps) per (64-row query tile, b*h). Query
// tiles 0..ceil(Nm/64)-1 cover the main rows; one more tile covers the P
// prefix rows (the JAX package computes those rows with dense einsums outside
// its kernel; here the same kernel covers them). Each block streams the main
// K/V in 64-key tiles through shared memory and then folds the prefix keys in
// as one extra masked tile, with the online softmax (running max m, sum l,
// and an f32 accumulator in registers). The ragged tail of the last main tile
// and the pad rows of the prefix tile are zero-filled and masked to -inf.
//
// Bound on the H100: at SA-Open's shape ([2,24,1025,64]) the work is
// 4*B*H*N^2*D ~ 12.9 GFLOP against ~25 MB of q/k/v/out, ~500 FLOP/byte, so the
// tensor cores bound it. The design uses them through WMMA (bf16 16x16x16
// mma.sync fragments, f32 accumulate) for both QK^T and PV; softmax runs in
// f32 registers, two lanes per query row. No wgmma, TMA or pipelining yet:
// K/V loads are synchronous 16-byte copies, so the kernel is latency bound
// well below the tensor-core roofline. That is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;        // head dim (the only one supported)
constexpr int TILE = 64;     // query rows and keys per tile
constexpr int WARPS = 4;     // each warp owns 16 query rows
constexpr int LDH = 80;      // bf16 row stride in shared memory (160 B)
constexpr int LDS = 68;      // f32 row stride of the score buffer

struct Smem {
  __nv_bfloat16 q[TILE * LDH];
  __nv_bfloat16 k[TILE * LDH];
  __nv_bfloat16 v[TILE * LDH];
  float s[WARPS][16 * LDS];
  __nv_bfloat16 p[WARPS][16 * LDH];
};

// Copy `rows` valid rows of a [*, 64] bf16 matrix into shared memory with
// 16-byte vectors; rows past `rows` are zero.
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < TILE * (D / 8); i += blockDim.x) {
    int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = zero;
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

__global__ void __launch_bounds__(128)
flash_prefix_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int N, int P, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int Nm = N - P;
  const int n_main = (Nm + TILE - 1) / TILE;
  const int tile = blockIdx.x;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qb = q + bh * N * D;
  const __nv_bfloat16* kb = k + bh * N * D;
  const __nv_bfloat16* vb = v + bh * N * D;

  int row0, nrows;
  if (tile < n_main) {
    row0 = P + tile * TILE;
    nrows = min(TILE, Nm - tile * TILE);
  } else {
    row0 = 0;
    nrows = P;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1;          // query row within the warp's 16
  const int half = lane & 1;        // which 32 columns this lane owns

  load_tile(sm.q, qb + (size_t)row0 * D, nrows);
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[D / 16];
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sm.q + warp * 16 * LDH + kk * 16, LDH);

  float m = -INFINITY, l = 0.f;
  float acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;

  const int n_key_tiles = n_main + (P > 0 ? 1 : 0);
  for (int kt = 0; kt < n_key_tiles; ++kt) {
    int key0, nkeys;
    if (kt < n_main) {
      key0 = P + kt * TILE;
      nkeys = min(TILE, Nm - kt * TILE);
    } else {
      key0 = 0;
      nkeys = P;
    }
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sm.k, kb + (size_t)key0 * D, nkeys);
    load_tile(sm.v, vb + (size_t)key0 * D, nkeys);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float* s = sm.s[warp];
    for (int n = 0; n < TILE / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sm.k + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(sc, qa[kk], kf, sc);
      }
      wmma::store_matrix_sync(s + n * 16, sc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: two lanes per row, 32 keys each
    float sv[32];
    float mloc = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int key = half * 32 + c;
      float x = s[r * LDS + key] * scale;
      x = key < nkeys ? x : -INFINITY;
      sv[c] = x;
      mloc = fmaxf(mloc, x);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    const float m_new = fmaxf(m, mloc);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    float psum = 0.f;
    __nv_bfloat16* p = sm.p[warp];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float e = expf(sv[c] - m_use);
      psum += e;
      p[r * LDH + half * 32 + c] = __float2bfloat16(e);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] *= alpha;
    __syncwarp();

    // O += P V for this warp's 16 rows x 64 dims (through the score buffer)
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc;
      wmma::fill_fragment(oc, 0.f);
      for (int kk = 0; kk < TILE / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, p + kk * 16, LDH);
        wmma::load_matrix_sync(vf, sm.v + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(oc, pf, vf, oc);
      }
      wmma::store_matrix_sync(s + n * 16, oc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] += s[r * LDS + half * 32 + c];
    __syncwarp();
  }

  const int row = warp * 16 + r;
  if (row < nrows) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* o = out + (bh * N + row0 + row) * D + half * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(o + c) =
          __floats2bfloat162_rn(acc[c] * inv, acc[c + 1] * inv);
    }
    if (half == 0) lse[bh * N + row0 + row] = m + logf(fmaxf(l, 1e-30f));
  }
}

}  // namespace

extern "C" int flash_prefix_fwd(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int H, int N, int P,
                                float scale, void* stream) {
  const int smem = (int)sizeof(Smem);
  cudaFuncSetAttribute(flash_prefix_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int Nm = N - P;
  dim3 grid((Nm + TILE - 1) / TILE + (P > 0 ? 1 : 0), B * H);
  flash_prefix_kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)lse, N, P, scale);
  return (int)cudaGetLastError();
}
