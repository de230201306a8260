// Flash-attention backward from the saved logsumexp, bf16 in, f32
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernels of stable_audio_tools_tpu/ops/kernels/
// flash_attention.py reached from `flash_attention_prefix`'s VJP
// (`_prefix_bwd` -> `_flash_backward`):
//   - `_bwd_fused_kernel` (single pass: dK/dV per key block, dQ revisited
//     across a sequential grid)  -> flash_bwd_dkv_kernel<true>: the same
//     single pass, with dQ added into an f32 buffer by atomicAdd, because a
//     GPU runs the key blocks in parallel and in no order;
//   - `_bwd_dkv_kernel` -> flash_bwd_dkv_kernel<false>;
//   - `_bwd_dq_kernel`  -> flash_bwd_dq_kernel (with the dK/dV kernel, the
//     two-pass route: no atomics, two more N^2 D products).
// The prefix needs no special case: the forward's lse is the full-row
// logsumexp, so the plain full-length backward applies (as in the JAX
// package).
//
// Function (per batch*head; s = 1/sqrt(64)):
//   dsum = rowsum(dO * O)                         (flash_bwd_dsum_kernel)
//   P    = exp(Q K^T s - lse)                     (f32; rounded to bf16 for dV)
//   dV   = P^T dO
//   dS   = P * (dO V^T - dsum) * s                (f32; rounded to bf16)
//   dK   = dS^T Q,  dQ = dS K
//
// Layout: q, k, v, dO, dK, dV, dQ are [B*H, N, 64] contiguous bf16; lse and
// dsum [B*H, N] f32. N need not be a multiple of 64: the tail key tile is
// zero-filled and masked (P = 0 for key >= N), tail query rows are
// zero-filled (dO = 0, P = 0) and never stored.
//
// Tiling: 64-row tiles, one 128-thread block (4 warps, 16 rows each).
//   dK/dV kernel: one block per (64-key tile, b*h); K and V stay in shared
//   memory and in registers as WMMA fragments; the block loops over the
//   query tiles. Each warp computes S^T and dP^T for its 16 keys against all
//   64 queries of the tile, so P^T and dS^T come out in the row order the
//   dV and dK products want, with dK/dV accumulated in registers.
//   dQ kernel: one block per (64-query tile, b*h); Q and dO stay resident;
//   the block loops over the key tiles and accumulates dQ in registers.
//
// Bound on the H100: at the training path's shape ([4,24,1025,64]) the
// single pass does 5 products of 2*N^2*64 per b*h (~0.7 GFLOP each b*h,
// ~65 GFLOP in all) over ~40 MB of operands, so the tensor cores bound it.
// The design uses them through WMMA (bf16 16x16x16 mma.sync fragments, f32
// accumulate) with the accumulator layout bridged through a per-warp f32
// shared-memory buffer, as the forward kernel does. No wgmma, TMA or
// pipelining yet, and dQ's atomics are scalar: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;        // head dim (the only one supported)
constexpr int TILE = 64;     // rows per tile (queries or keys)
constexpr int WARPS = 4;     // each warp owns 16 rows of the tile
constexpr int LDH = 80;      // bf16 row stride in shared memory (160 B)
constexpr int LDS = 68;      // f32 row stride of the per-warp buffer

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct SmemKV {
  __nv_bfloat16 k[TILE * LDH];
  __nv_bfloat16 v[TILE * LDH];
  __nv_bfloat16 q[TILE * LDH];
  __nv_bfloat16 d[TILE * LDH];    // dO tile
  __nv_bfloat16 pt[TILE * LDH];   // P^T  [key][query], rows owned by warps
  __nv_bfloat16 dst[TILE * LDH];  // dS^T [key][query]
  float s[WARPS][16 * LDS];
  float lse[TILE];
  float dsum[TILE];
};

struct SmemQ {
  __nv_bfloat16 q[TILE * LDH];
  __nv_bfloat16 d[TILE * LDH];    // dO tile
  __nv_bfloat16 k[TILE * LDH];
  __nv_bfloat16 v[TILE * LDH];
  __nv_bfloat16 ds[TILE * LDH];   // dS [query][key], rows owned by warps
  float s[WARPS][16 * LDS];
  float lse[TILE];
  float dsum[TILE];
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

// lse and dsum of `rows` valid rows into shared memory; the rest are zero.
__device__ void load_rows(float* lse_s, float* dsum_s, const float* lse,
                          const float* dsum, int rows) {
  for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
    lse_s[i] = i < rows ? lse[i] : 0.f;
    dsum_s[i] = i < rows ? dsum[i] : 0.f;
  }
}

// Write a warp's 16 x 64 f32 tile (staged in its buffer `s`) as bf16 rows
// row0 .. row0+15 of `out` ([*, 64]), skipping rows >= `rows`.
__device__ void store_rows_bf16(__nv_bfloat16* out, const float* s, int row0,
                                int rows, int r, int half) {
  if (row0 + r < rows) {
    __nv_bfloat16* o = out + (size_t)(row0 + r) * D + half * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(o + c) =
          __floats2bfloat162_rn(s[r * LDS + half * 32 + c], s[r * LDS + half * 32 + c + 1]);
    }
  }
}

// dsum[row] = sum_d dO[row, d] * O[row, d] in f32; one warp per row.
__global__ void __launch_bounds__(256)
flash_bwd_dsum_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      float* __restrict__ dsum, int rows) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // row is uniform across the warp
  const float2 a = __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(o + (size_t)row * D)[lane]);
  const float2 b = __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(dout + (size_t)row * D)[lane]);
  float acc = a.x * b.x + a.y * b.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

template <bool ATOMIC_DQ>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ dq_acc, int N, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemKV& sm = *reinterpret_cast<SmemKV*>(smem_raw);

  const int n_tiles = (N + TILE - 1) / TILE;
  const int key0 = blockIdx.x * TILE;
  const int nkeys = min(TILE, N - key0);
  const size_t bh = blockIdx.y;
  const size_t off = bh * (size_t)N * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1;           // row within the warp's 16
  const int half = lane & 1;         // which 32 columns this lane owns
  const int krow = warp * 16 + r;    // this lane's key row within the tile
  const bool key_ok = krow < nkeys;

  load_tile(sm.k, k + off + (size_t)key0 * D, nkeys);
  load_tile(sm.v, v + off + (size_t)key0 * D, nkeys);
  __syncthreads();

  FragA ka[D / 16], va[D / 16];
  #pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(ka[kk], sm.k + warp * 16 * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(va[kk], sm.v + warp * 16 * LDH + kk * 16, LDH);
  }
  FragC dk_acc[D / 16], dv_acc[D / 16];
  #pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }
  float* s = sm.s[warp];

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * TILE;
    const int nq = min(TILE, N - q0);
    __syncthreads();  // every warp is done with the previous q / dO / dS^T
    load_tile(sm.q, q + off + (size_t)q0 * D, nq);
    load_tile(sm.d, dout + off + (size_t)q0 * D, nq);
    load_rows(sm.lse, sm.dsum, lse + bh * N + q0, dsum + bh * N + q0, nq);
    __syncthreads();

    // S^T = K_w Q^T: this warp's 16 keys x the tile's 64 queries
    #pragma unroll
    for (int n = 0; n < TILE / 16; ++n) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      #pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBT qb;
        wmma::load_matrix_sync(qb, sm.q + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, ka[kk], qb, acc);
      }
      wmma::store_matrix_sync(s + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // P^T = exp(S^T s - lse[query]), masked; f32 in registers, bf16 in smem
    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const float x = s[r * LDS + col] * scale - sm.lse[col];
      p[c] = (key_ok && col < nq) ? expf(x) : 0.f;
      sm.pt[krow * LDH + col] = __float2bfloat16(p[c]);
    }
    __syncwarp();

    // dP^T = V_w dO^T
    #pragma unroll
    for (int n = 0; n < TILE / 16; ++n) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      #pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBT db;
        wmma::load_matrix_sync(db, sm.d + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, va[kk], db, acc);
      }
      wmma::store_matrix_sync(s + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // dS^T = P^T * (dP^T - dsum[query]) * s, rounded to bf16
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const float ds = p[c] * (s[r * LDS + col] - sm.dsum[col]) * scale;
      sm.dst[krow * LDH + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dV_w += P^T_w dO ; dK_w += dS^T_w Q
    #pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      #pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, sm.pt + warp * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(b, sm.d + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(dv_acc[n], a, b, dv_acc[n]);
        wmma::load_matrix_sync(a, sm.dst + warp * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(b, sm.q + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(dk_acc[n], a, b, dk_acc[n]);
      }
    }

    if (ATOMIC_DQ) {
      __syncthreads();  // every warp's dS^T rows are written
      // dQ rows of this warp (queries warp*16..) += dS K = (dS^T)^T K
      #pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
        #pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          FragAT a;
          FragB b;
          wmma::load_matrix_sync(a, sm.dst + kk * 16 * LDH + warp * 16, LDH);
          wmma::load_matrix_sync(b, sm.k + kk * 16 * LDH + n * 16, LDH);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(s + n * 16, acc, LDS, wmma::mem_row_major);
      }
      __syncwarp();
      const int qrow = warp * 16 + r;
      if (qrow < nq) {
        float* dst = dq_acc + (bh * N + q0 + qrow) * D + half * 32;
#pragma unroll
        for (int c = 0; c < 32; ++c) atomicAdd(dst + c, s[r * LDS + half * 32 + c]);
      }
      __syncwarp();
    }
  }

  #pragma unroll

  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s + n * 16, dk_acc[n], LDS, wmma::mem_row_major);
  __syncwarp();
  store_rows_bf16(dk + off + (size_t)key0 * D, s, warp * 16, nkeys, r, half);
  __syncwarp();
  #pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s + n * 16, dv_acc[n], LDS, wmma::mem_row_major);
  __syncwarp();
  store_rows_bf16(dv + off + (size_t)key0 * D, s, warp * 16, nkeys, r, half);
}

__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, int N, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemQ& sm = *reinterpret_cast<SmemQ*>(smem_raw);

  const int n_tiles = (N + TILE - 1) / TILE;
  const int q0 = blockIdx.x * TILE;
  const int nq = min(TILE, N - q0);
  const size_t bh = blockIdx.y;
  const size_t off = bh * (size_t)N * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int qrow = warp * 16 + r;    // this lane's query row within the tile
  const bool q_ok = qrow < nq;

  load_tile(sm.q, q + off + (size_t)q0 * D, nq);
  load_tile(sm.d, dout + off + (size_t)q0 * D, nq);
  load_rows(sm.lse, sm.dsum, lse + bh * N + q0, dsum + bh * N + q0, nq);
  __syncthreads();

  FragA qa[D / 16], da[D / 16];
  #pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], sm.q + warp * 16 * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(da[kk], sm.d + warp * 16 * LDH + kk * 16, LDH);
  }
  FragC dq_acc[D / 16];
  #pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);
  const float row_lse = sm.lse[qrow];
  const float row_dsum = sm.dsum[qrow];
  float* s = sm.s[warp];

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int key0 = kt * TILE;
    const int nk = min(TILE, N - key0);
    __syncthreads();  // every warp is done with the previous K / V tile
    load_tile(sm.k, k + off + (size_t)key0 * D, nk);
    load_tile(sm.v, v + off + (size_t)key0 * D, nk);
    __syncthreads();

    // S = Q_w K^T: this warp's 16 queries x 64 keys
    #pragma unroll
    for (int n = 0; n < TILE / 16; ++n) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      #pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBT kb;
        wmma::load_matrix_sync(kb, sm.k + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(s + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = half * 32 + c;
      p[c] = (q_ok && key < nk) ? expf(s[r * LDS + key] * scale - row_lse) : 0.f;
    }
    __syncwarp();

    // dP = dO_w V^T
    #pragma unroll
    for (int n = 0; n < TILE / 16; ++n) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      #pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBT vb;
        wmma::load_matrix_sync(vb, sm.v + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, da[kk], vb, acc);
      }
      wmma::store_matrix_sync(s + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = half * 32 + c;
      const float ds = p[c] * (s[r * LDS + key] - row_dsum) * scale;
      sm.ds[qrow * LDH + key] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dQ_w += dS_w K
    #pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      #pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, sm.ds + warp * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(b, sm.k + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(dq_acc[n], a, b, dq_acc[n]);
      }
    }
  }

  __syncwarp();
  #pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s + n * 16, dq_acc[n], LDS, wmma::mem_row_major);
  __syncwarp();
  store_rows_bf16(dq + off + (size_t)q0 * D, s, warp * 16, nq, r, half);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// dsum [rows] = rowsum(dO * O) over [rows, 64] bf16.
extern "C" int flash_bwd_dsum(const void* o, const void* dout, void* dsum, int rows,
                              void* stream) {
  const int rows_per_block = 8;  // 256 threads, one warp per row
  dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  flash_bwd_dsum_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)dsum, rows);
  return (int)cudaGetLastError();
}

// dK, dV (and, with atomic_dq, dQ added into the zeroed f32 buffer dq_acc).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* dsum, void* dk, void* dv,
                             void* dq_acc, int BH, int N, float scale, int atomic_dq,
                             void* stream) {
  const int smem = (int)sizeof(SmemKV);
  dim3 grid((N + TILE - 1) / TILE, BH);
  int err;
  if (atomic_dq) {
    err = set_smem(flash_bwd_dkv_kernel<true>, smem);
    if (err) return err;
    flash_bwd_dkv_kernel<true><<<grid, 128, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, (const float*)lse, (const float*)dsum,
        (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (float*)dq_acc, N, scale);
  } else {
    err = set_smem(flash_bwd_dkv_kernel<false>, smem);
    if (err) return err;
    flash_bwd_dkv_kernel<false><<<grid, 128, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, (const float*)lse, (const float*)dsum,
        (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (float*)dq_acc, N, scale);
  }
  return (int)cudaGetLastError();
}

// dQ (bf16) by the second pass over the key tiles.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dsum, void* dq, int BH, int N,
                            float scale, void* stream) {
  const int smem = (int)sizeof(SmemQ);
  const int err = set_smem(flash_bwd_dq_kernel, smem);
  if (err) return err;
  dim3 grid((N + TILE - 1) / TILE, BH);
  flash_bwd_dq_kernel<<<grid, 128, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)dsum,
      (__nv_bfloat16*)dq, N, scale);
  return (int)cudaGetLastError();
}
