// Flash-attention backward from the saved logsumexp, bf16 in, f32
// accumulation, for Hopper (sm_90a); head dim 64 or 128, unmasked or under a
// causal / sliding-window band.
//
// Replaces the TPU kernels of stable_audio_tools_tpu/ops/kernels/
// flash_attention.py reached from the VJPs of `flash_attention`,
// `flash_attention_prefix` and `flash_attention_nhd` (`_bwd`, `_prefix_bwd`,
// `_nhd_bwd` -> `_flash_backward`):
//   - `_bwd_fused_kernel` (single pass: dK/dV per key block, dQ revisited
//     across a sequential grid)  -> flash_bwd_dkv_kernel<D, true>: the same
//     single pass, with dQ added into an f32 buffer by atomicAdd, because a
//     GPU runs the key blocks in parallel and in no order;
//   - `_bwd_dkv_kernel` -> flash_bwd_dkv_kernel<D, false>;
//   - `_bwd_dq_kernel`  -> flash_bwd_dq_kernel<D> (with the dK/dV kernel, the
//     two-pass route: no atomics, two more N^2 D products).
// The prefix needs no special case: the forward's lse is the full-row
// logsumexp, so the plain full-length backward applies (as in the JAX
// package).
//
// Function (per batch*head; s = 1/sqrt(D)):
//   dsum = rowsum(dO * O)                         (flash_bwd_dsum_kernel)
//   P    = exp(Q K^T s - lse) on the band, else 0 (f32; rounded to bf16 for dV)
//   dV   = P^T dO
//   dS   = P * (dO V^T - dsum) * s                (f32; rounded to bf16)
//   dK   = dS^T Q,  dQ = dS K
// The band: key j is visible from query i iff j >= i - left (left >= 0) and
// j <= i + right (right >= 0); -1 leaves a side open, causal is right = 0
// (the wrapper folds it in), both -1 is the unmasked function.
//
// Band skipping, as the TPU kernels' `_k_visible_range` (dK/dV: the query
// tiles that see a key tile, [key0 - right, key0 + 63 + left]) and
// `_q_visible_range` (dQ: the key tiles a query tile sees,
// [q0 - left, q0 + 63 + right]); tile pairs wholly inside the band skip the
// per-element mask.
//
// Layout: q, k, v, dO, dK, dV, dQ are [B*H, N, D] contiguous bf16; lse and
// dsum [B*H, N] f32. N need not be a multiple of 64: the tail key tile is
// zero-filled and masked (P = 0 for key >= N), tail query rows are
// zero-filled (dO = 0, P = 0) and never stored.
//
// Tiling: 64-row tiles, one 128-thread block (4 warps, 16 rows each).
//   dK/dV kernel: one block per (64-key tile, b*h); K and V stay in shared
//   memory (at D = 64 also in registers as WMMA fragments; at D = 128 the
//   fragments are read from shared memory at each use, which keeps the dK
//   and dV accumulators, 128 f32 a thread, in registers); the block loops
//   over the query tiles of its band. Each warp computes S^T and dP^T for
//   its 16 keys against all 64 queries of the tile, so P^T and dS^T come out
//   in the row order the dV and dK products want.
//   dQ kernel: one block per (64-query tile, b*h); Q and dO stay resident;
//   the block loops over the key tiles of its band and accumulates dQ in
//   registers.
//
// Bound on the H100: at SA-Open's training shape ([4,24,1025,64]) the
// single pass does 5 products of 2*N^2*64 per b*h (~65 GFLOP in all) over
// ~40 MB of operands, so the tensor cores bound it; a window cuts the
// products to the band, and the long windowed shapes become memory-bound.
// The design uses the tensor cores through WMMA (bf16 16x16x16 mma.sync
// fragments, f32 accumulate) with the accumulator layout bridged through a
// per-warp f32 shared-memory buffer. No wgmma, TMA or pipelining yet, and
// dQ's atomics are scalar: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE = 64;     // rows per tile (queries or keys)
constexpr int WARPS = 4;     // each warp owns 16 rows of the tile
constexpr int LDT = 80;      // bf16 row stride of the [64][64] P^T / dS^T tiles

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

template <int D>
struct Dims {
  static constexpr int LDD = D + 16;             // bf16 row stride of [64][D] tiles
  static constexpr int LDS = (D > TILE ? D : TILE) + 4;  // f32 row stride, per-warp buffer
  static constexpr bool CACHE = D <= 64;         // K/V (Q/dO) fragments kept in registers
};

template <int D>
struct SmemKV {
  __nv_bfloat16 k[TILE * Dims<D>::LDD];
  __nv_bfloat16 v[TILE * Dims<D>::LDD];
  __nv_bfloat16 q[TILE * Dims<D>::LDD];
  __nv_bfloat16 d[TILE * Dims<D>::LDD];  // dO tile
  __nv_bfloat16 pt[TILE * LDT];          // P^T  [key][query], rows owned by warps
  __nv_bfloat16 dst[TILE * LDT];         // dS^T [key][query]
  float s[WARPS][16 * Dims<D>::LDS];
  float lse[TILE];
  float dsum[TILE];
};

template <int D>
struct SmemQ {
  __nv_bfloat16 q[TILE * Dims<D>::LDD];
  __nv_bfloat16 d[TILE * Dims<D>::LDD];  // dO tile
  __nv_bfloat16 k[TILE * Dims<D>::LDD];
  __nv_bfloat16 v[TILE * Dims<D>::LDD];
  __nv_bfloat16 ds[TILE * LDT];          // dS [query][key], rows owned by warps
  float s[WARPS][16 * Dims<D>::LDS];
  float lse[TILE];
  float dsum[TILE];
};

// key j visible from query i under the band (left / right -1: open side)
__device__ __forceinline__ bool visible(int i, int j, int left, int right) {
  return (left < 0 || j >= i - left) && (right < 0 || j <= i + right);
}

// whether some (query, key) of the tile pair [q0, q0+63] x [k0, k0+63] lies
// outside the band (ragged edges are masked apart)
__device__ __forceinline__ bool pair_masked(int q0, int k0, int left, int right) {
  return (left >= 0 && k0 < q0 + TILE - 1 - left) || (right >= 0 && k0 + TILE - 1 > q0 + right);
}

// Copy `rows` valid rows of a [*, D] bf16 matrix into shared memory with
// 16-byte vectors; rows past `rows` are zero.
template <int D>
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows) {
  constexpr int LDD = Dims<D>::LDD;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < TILE * (D / 8); i += blockDim.x) {
    int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = zero;
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDD + c) = val;
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

// Write a warp's 16 x D f32 tile (staged in its buffer `s`) as bf16 rows
// row0 .. row0+15 of `out` ([*, D]), skipping rows >= `rows`; lane (r, half)
// writes half `half` of row r.
template <int D>
__device__ void store_rows_bf16(__nv_bfloat16* out, const float* s, int row0,
                                int rows, int r, int half) {
  constexpr int LDS = Dims<D>::LDS, W = D / 2;
  if (row0 + r < rows) {
    __nv_bfloat16* o = out + (size_t)(row0 + r) * D + half * W;
#pragma unroll
    for (int c = 0; c < W; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(o + c) =
          __floats2bfloat162_rn(s[r * LDS + half * W + c], s[r * LDS + half * W + c + 1]);
    }
  }
}

// dsum[row] = sum_d dO[row, d] * O[row, d] in f32; one warp per row.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dsum_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      float* __restrict__ dsum, int rows) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // row is uniform across the warp
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    const float2 a = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(o + (size_t)row * D)[c * 32 + lane]);
    const float2 b = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(dout + (size_t)row * D)[c * 32 + lane]);
    acc += a.x * b.x + a.y * b.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

template <int D, bool ATOMIC_DQ>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ dq_acc, int N, float scale, int left, int right) {
  constexpr int LDD = Dims<D>::LDD, LDS = Dims<D>::LDS;
  constexpr bool CACHE = Dims<D>::CACHE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemKV<D>& sm = *reinterpret_cast<SmemKV<D>*>(smem_raw);

  const int n_tiles = (N + TILE - 1) / TILE;
  const int key0 = blockIdx.x * TILE;
  const int nkeys = min(TILE, N - key0);
  const size_t bh = blockIdx.y;
  const size_t off = bh * (size_t)N * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1;           // row within the warp's 16
  const int half = lane & 1;         // which 32 columns of a 64-wide tile this lane owns
  const int krow = warp * 16 + r;    // this lane's key row within the tile
  const bool key_ok = krow < nkeys;
  // the query tiles that see a key of this tile
  const int qt_lo = right >= 0 ? max(key0 - right, 0) / TILE : 0;
  const int qt_hi = left >= 0 ? min(key0 + TILE - 1 + left, N - 1) / TILE : n_tiles - 1;

  load_tile<D>(sm.k, k + off + (size_t)key0 * D, nkeys);
  load_tile<D>(sm.v, v + off + (size_t)key0 * D, nkeys);
  __syncthreads();

  FragA ka[CACHE ? D / 16 : 1], va[CACHE ? D / 16 : 1];
  if constexpr (CACHE) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(ka[kk], sm.k + warp * 16 * LDD + kk * 16, LDD);
      wmma::load_matrix_sync(va[kk], sm.v + warp * 16 * LDD + kk * 16, LDD);
    }
  }
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }
  float* s = sm.s[warp];

  for (int qt = qt_lo; qt <= qt_hi; ++qt) {
    const int q0 = qt * TILE;
    const int nq = min(TILE, N - q0);
    const bool masked = pair_masked(q0, key0, left, right);
    __syncthreads();  // every warp is done with the previous q / dO / dS^T
    load_tile<D>(sm.q, q + off + (size_t)q0 * D, nq);
    load_tile<D>(sm.d, dout + off + (size_t)q0 * D, nq);
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
        wmma::load_matrix_sync(qb, sm.q + n * 16 * LDD + kk * 16, LDD);
        if constexpr (CACHE) {
          wmma::mma_sync(acc, ka[kk], qb, acc);
        } else {
          FragA a;
          wmma::load_matrix_sync(a, sm.k + warp * 16 * LDD + kk * 16, LDD);
          wmma::mma_sync(acc, a, qb, acc);
        }
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
      bool keep = key_ok && col < nq;
      if (masked) keep = keep && visible(q0 + col, key0 + krow, left, right);
      p[c] = keep ? expf(x) : 0.f;
      sm.pt[krow * LDT + col] = __float2bfloat16(p[c]);
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
        wmma::load_matrix_sync(db, sm.d + n * 16 * LDD + kk * 16, LDD);
        if constexpr (CACHE) {
          wmma::mma_sync(acc, va[kk], db, acc);
        } else {
          FragA a;
          wmma::load_matrix_sync(a, sm.v + warp * 16 * LDD + kk * 16, LDD);
          wmma::mma_sync(acc, a, db, acc);
        }
      }
      wmma::store_matrix_sync(s + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // dS^T = P^T * (dP^T - dsum[query]) * s, rounded to bf16
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const float ds = p[c] * (s[r * LDS + col] - sm.dsum[col]) * scale;
      sm.dst[krow * LDT + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dV_w += P^T_w dO ; dK_w += dS^T_w Q
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, sm.pt + warp * 16 * LDT + kk * 16, LDT);
        wmma::load_matrix_sync(b, sm.d + kk * 16 * LDD + n * 16, LDD);
        wmma::mma_sync(dv_acc[n], a, b, dv_acc[n]);
        wmma::load_matrix_sync(a, sm.dst + warp * 16 * LDT + kk * 16, LDT);
        wmma::load_matrix_sync(b, sm.q + kk * 16 * LDD + n * 16, LDD);
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
          wmma::load_matrix_sync(a, sm.dst + kk * 16 * LDT + warp * 16, LDT);
          wmma::load_matrix_sync(b, sm.k + kk * 16 * LDD + n * 16, LDD);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(s + n * 16, acc, LDS, wmma::mem_row_major);
      }
      __syncwarp();
      const int qrow = warp * 16 + r;
      if (qrow < nq) {
        float* dst = dq_acc + (bh * N + q0 + qrow) * D + half * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 2; ++c) atomicAdd(dst + c, s[r * LDS + half * (D / 2) + c]);
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s + n * 16, dk_acc[n], LDS, wmma::mem_row_major);
  __syncwarp();
  store_rows_bf16<D>(dk + off + (size_t)key0 * D, s, warp * 16, nkeys, r, half);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s + n * 16, dv_acc[n], LDS, wmma::mem_row_major);
  __syncwarp();
  store_rows_bf16<D>(dv + off + (size_t)key0 * D, s, warp * 16, nkeys, r, half);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, int N, float scale, int left, int right) {
  constexpr int LDD = Dims<D>::LDD, LDS = Dims<D>::LDS;
  constexpr bool CACHE = Dims<D>::CACHE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemQ<D>& sm = *reinterpret_cast<SmemQ<D>*>(smem_raw);

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
  // the key tiles this query tile sees
  const int kt_lo = left >= 0 ? max(q0 - left, 0) / TILE : 0;
  const int kt_hi = right >= 0 ? min(q0 + TILE - 1 + right, N - 1) / TILE : n_tiles - 1;

  load_tile<D>(sm.q, q + off + (size_t)q0 * D, nq);
  load_tile<D>(sm.d, dout + off + (size_t)q0 * D, nq);
  load_rows(sm.lse, sm.dsum, lse + bh * N + q0, dsum + bh * N + q0, nq);
  __syncthreads();

  FragA qa[CACHE ? D / 16 : 1], da[CACHE ? D / 16 : 1];
  if constexpr (CACHE) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(qa[kk], sm.q + warp * 16 * LDD + kk * 16, LDD);
      wmma::load_matrix_sync(da[kk], sm.d + warp * 16 * LDD + kk * 16, LDD);
    }
  }
  FragC dq_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);
  const float row_lse = sm.lse[qrow];
  const float row_dsum = sm.dsum[qrow];
  float* s = sm.s[warp];

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int key0 = kt * TILE;
    const int nk = min(TILE, N - key0);
    const bool masked = pair_masked(q0, key0, left, right);
    __syncthreads();  // every warp is done with the previous K / V tile
    load_tile<D>(sm.k, k + off + (size_t)key0 * D, nk);
    load_tile<D>(sm.v, v + off + (size_t)key0 * D, nk);
    __syncthreads();

    // S = Q_w K^T: this warp's 16 queries x 64 keys
#pragma unroll
    for (int n = 0; n < TILE / 16; ++n) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBT kb;
        wmma::load_matrix_sync(kb, sm.k + n * 16 * LDD + kk * 16, LDD);
        if constexpr (CACHE) {
          wmma::mma_sync(acc, qa[kk], kb, acc);
        } else {
          FragA a;
          wmma::load_matrix_sync(a, sm.q + warp * 16 * LDD + kk * 16, LDD);
          wmma::mma_sync(acc, a, kb, acc);
        }
      }
      wmma::store_matrix_sync(s + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = half * 32 + c;
      bool keep = q_ok && key < nk;
      if (masked) keep = keep && visible(q0 + qrow, key0 + key, left, right);
      p[c] = keep ? expf(s[r * LDS + key] * scale - row_lse) : 0.f;
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
        wmma::load_matrix_sync(vb, sm.v + n * 16 * LDD + kk * 16, LDD);
        if constexpr (CACHE) {
          wmma::mma_sync(acc, da[kk], vb, acc);
        } else {
          FragA a;
          wmma::load_matrix_sync(a, sm.d + warp * 16 * LDD + kk * 16, LDD);
          wmma::mma_sync(acc, a, vb, acc);
        }
      }
      wmma::store_matrix_sync(s + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = half * 32 + c;
      const float ds = p[c] * (s[r * LDS + key] - row_dsum) * scale;
      sm.ds[qrow * LDT + key] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dQ_w += dS_w K
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, sm.ds + warp * 16 * LDT + kk * 16, LDT);
        wmma::load_matrix_sync(b, sm.k + kk * 16 * LDD + n * 16, LDD);
        wmma::mma_sync(dq_acc[n], a, b, dq_acc[n]);
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(s + n * 16, dq_acc[n], LDS, wmma::mem_row_major);
  __syncwarp();
  store_rows_bf16<D>(dq + off + (size_t)q0 * D, s, warp * 16, nq, r, half);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int dsum_launch(const void* o, const void* dout, void* dsum, int rows, cudaStream_t stream) {
  const int rows_per_block = 8;  // 256 threads, one warp per row
  dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  flash_bwd_dsum_kernel<D><<<grid, 256, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)dsum, rows);
  return (int)cudaGetLastError();
}

template <int D, bool ATOMIC>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* dsum, void* dk, void* dv, void* dq_acc, int BH, int N, float scale,
               int left, int right, cudaStream_t stream) {
  const int smem = (int)sizeof(SmemKV<D>);
  const int err = set_smem(flash_bwd_dkv_kernel<D, ATOMIC>, smem);
  if (err) return err;
  dim3 grid((N + TILE - 1) / TILE, BH);
  flash_bwd_dkv_kernel<D, ATOMIC><<<grid, 128, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)dsum,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (float*)dq_acc, N, scale, left, right);
  return (int)cudaGetLastError();
}

template <int D>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* dsum, void* dq, int BH, int N, float scale, int left, int right,
              cudaStream_t stream) {
  const int smem = (int)sizeof(SmemQ<D>);
  const int err = set_smem(flash_bwd_dq_kernel<D>, smem);
  if (err) return err;
  dim3 grid((N + TILE - 1) / TILE, BH);
  flash_bwd_dq_kernel<D><<<grid, 128, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)dsum,
      (__nv_bfloat16*)dq, N, scale, left, right);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry takes the head dim D (64 or 128; anything else returns
// cudaErrorInvalidValue) and, where masked, the band (left, right; -1 = open).

// dsum [rows] = rowsum(dO * O) over [rows, D] bf16.
extern "C" int flash_bwd_dsum(const void* o, const void* dout, void* dsum, int rows, int D,
                              void* stream) {
  if (D == 64) return dsum_launch<64>(o, dout, dsum, rows, (cudaStream_t)stream);
  if (D == 128) return dsum_launch<128>(o, dout, dsum, rows, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// dK, dV (and, with atomic_dq, dQ added into the zeroed f32 buffer dq_acc).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* dsum, void* dk, void* dv,
                             void* dq_acc, int BH, int N, int D, float scale, int left,
                             int right, int atomic_dq, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return atomic_dq ? dkv_launch<64, true>(q, k, v, dout, lse, dsum, dk, dv, dq_acc, BH, N,
                                            scale, left, right, st)
                     : dkv_launch<64, false>(q, k, v, dout, lse, dsum, dk, dv, dq_acc, BH, N,
                                             scale, left, right, st);
  if (D == 128)
    return atomic_dq ? dkv_launch<128, true>(q, k, v, dout, lse, dsum, dk, dv, dq_acc, BH, N,
                                             scale, left, right, st)
                     : dkv_launch<128, false>(q, k, v, dout, lse, dsum, dk, dv, dq_acc, BH, N,
                                              scale, left, right, st);
  return (int)cudaErrorInvalidValue;
}

// dQ (bf16) by the second pass over the key tiles.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dsum, void* dq, int BH, int N, int D,
                            float scale, int left, int right, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return dq_launch<64>(q, k, v, dout, lse, dsum, dq, BH, N, scale, left, right, st);
  if (D == 128)
    return dq_launch<128>(q, k, v, dout, lse, dsum, dq, BH, N, scale, left, right, st);
  return (int)cudaErrorInvalidValue;
}
