// Flash-attention forward over [B, H, N, D] with D in {64, 128}, unmasked,
// causal or sliding-window, bf16 in, f32 accumulation, for Hopper (sm_90a).
//
// Replaces three TPU kernels of stable_audio_tools_tpu/ops/kernels/flash_attention.py,
// one function at three call sites:
// - `_flash_kernel` (reached from `flash_attention` through `_flash_forward`):
//   causal / sliding-window attention, D 64 or 128;
// - `_flash_prefix_kernel` (`flash_attention_prefix`): unmasked attention
//   over a sequence whose first rows are a short prepended prefix (the
//   prefix changes how the TPU kernel tiles, not the function);
// - `_flash_nhd_pair_kernel` (`flash_attention_nhd`): the same attention in
//   the [B, N, H, 64] activation layout, which this kernel reads as
//   [B, H, N, 64] views through the operands' strides;
// - `_flash_fused_kernel` (`flash_attention_fused_qkv`): the same attention
//   read straight off the fused [B, N, 3*H*D] QKV projection, with the
//   partial rotary embedding applied to q and k inside the kernel (the
//   `ROPE` template flag, below).
// Same function: out = softmax(QK^T/sqrt(D) + mask) V per (batch, head), plus
// the f32 logsumexp, where key j is visible from query i iff
//   j < N, j >= i - left (left >= 0), j <= i + right (right >= 0);
// left = right = -1 is unmasked, causal attention is right = 0 (the wrapper
// folds `causal` into right, as min(right, 0) when a window is given too). P
// (the probabilities) is rounded to bf16 before PV, as in the TPU kernels.
//
// Band skipping (the TPU kernel's `_q_visible_range`): a 64-row query tile
// [q0, q0 + 63] visits only the key tiles that hold a key of
// [q0 - left, q0 + 63 + right]: the tiles up to the diagonal one when causal,
// (left + right + 63) / 64 + 2 at most for a two-sided window, so windowed
// attention costs O(N w), not O(N^2). Tiles wholly inside the band skip the
// per-element mask.
//
// Each operand is read through its own (batch, head, row) strides, so the
// wrapper hands over [B, H, N, D] views of [B, N, H, D] projections (q, k, v
// may be views of one fused [B, N, 3*H*D] output) and of the [B, N, H*D]
// output, without copies; the wrapper checks that rows start on 16-byte
// boundaries. The design:
// - the products run as mma.sync m16n8k16 (bf16 in, f32 out) on fragments
//   that ldmatrix reads from shared memory: each warp owns 16 query rows and
//   keeps their Q fragments, the 16 x 64 scores and the 16 x D output in
//   registers for the whole key loop; the scores' accumulator layout is the A
//   operand layout of the PV product, so the probabilities never touch shared
//   memory;
// - the softmax works on those registers in the exp2 domain (the scale is
//   folded with log2 e), a row's 64 scores spread over the 4 lanes of a quad;
// - strided rows cost more to fetch than a contiguous tile, so the next K/V
//   tile is fetched with cp.async into a second shared-memory stage while the
//   current one is computed on; rows are padded by 16 bytes so that
//   ldmatrix's eight row reads fall on distinct banks. D = 128 needs 87 KB of
//   shared memory (dynamic, opted in per launch) and about 64 more registers
//   a thread for its output and Q fragments;
// - the ragged tail is zero-filled and masked to -inf on the key side and
//   never stored on the query side;
// - blocks take the query tiles from the last to the first, so under a causal
//   mask the longest rows start first.
//
// Rotary (`ROPE`, rot_dim > 0): cp.async lands the raw bf16 Q tile and each
// raw K tile in shared memory, together with the rows of the f32 cos / sin
// tables [N, rot_dim] at the tile's positions; after the wait and a barrier
// the block rotates the first rot_dim columns of the tile's valid rows in
// place (half-split: y1 = x1 cos - x2 sin, y2 = x2 cos + x1 sin, each
// product and sum rounded as torch's elementwise ops round them, the result
// rounded to bf16, as the TPU kernel rounds before its products), then a
// second barrier, then ldmatrix reads the rotated tile. Rows past N are
// neither fetched nor rotated, so the tables are never read past row N (the
// TPU entry pads its tables with zeros instead). The table rows take one
// shared-memory stage, so with the rotary the next K/V tile is fetched
// after the current one is rotated (still ahead of its products). A K tile
// is rotated again by every query tile that visits it (~N / 64 times
// without a mask): 3 rot_dim f32 operations a row against the 4 x 64 x D of
// the tile's two tensor-core products, ALU and shared-memory work beside
// them (chip_smoke.py times the kernel against the rotary pass + the kernel
// without it).
//
// Bound on the H100: the work is 4 D per visible (query, key) pair. At
// SA-2.0's unmasked shape ([2, 24, 6145, 64]) that is ~464 GFLOP against
// ~151 MB: the tensor cores bound it (0.47 ms). Under the causal mask at the
// LM's training shape ([4, 16, 500, 64]) it is ~2.1 GFLOP against ~16.5 MB,
// ~125 FLOP/byte, so memory bounds it (4.9 us); at 1503 rows the operations
// do. At TAAE's windowed shapes the band cuts the operations to
// 4 B H N (left + right + 1) D while the bytes stay, and memory bounds them.
// At the LM's sizes a launch is a few waves of short blocks, so the kernel
// sits far above its bound (PERF.md). No wgmma or TMA yet: mma.sync reaches
// a fraction of the warpgroup rate.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Four 8x8 bf16 matrices from shared memory, one row address per lane (lane
// 8m + r gives row r of matrix m); register m holds matrix m's fragment:
// element (lane / 4, 2 * (lane % 4) + {0, 1}), or its transpose with `trans`.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_16x8x16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int TILE = 64;  // query rows and keys per tile

// element strides of one [B, H, N, D] operand (last axis contiguous)
struct Strides {
  long long b, h, n;
};

template <int D>
struct Layout {
  static constexpr int LD = D + 8;  // bf16 row stride in shared memory
  static constexpr int TILE_ELEMS = TILE * LD;
  // q tile, then two K stages, then two V stages
  static constexpr int SMEM_BYTES = 5 * TILE_ELEMS * 2;
};

// Start the copy of `rows` valid D-element rows, `row_stride` elements apart,
// into shared memory as 16-byte cp.async transfers; rows past `rows` are
// zero-filled (their source is row 0, of which no byte is read).
template <int D>
__device__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                long long row_stride, int rows) {
  constexpr int LD = Layout<D>::LD;
  for (int i = threadIdx.x; i < TILE * (D / 8); i += blockDim.x) {
    int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool valid = r < rows;
    __pipeline_memcpy_async(dst + r * LD + c, src + (valid ? r : 0) * row_stride + c,
                            16, valid ? 0 : 16);
  }
}

// Start the copy of the rows [pos0, pos0 + rows) of the cos and sin tables
// ([N, rot_dim] f32) into shared memory, `tld` floats a row; no row past
// `rows` is read. A width that is a multiple of 4 moves in 16-byte cp.async
// transfers, a warp covering 32 / p rows at once (p: the row's transfers
// rounded up to a power of two); any other even width in 8-byte transfers,
// a warp to a row.
__device__ void load_tables_async(float* tcos, float* tsin, const float* cos_t,
                                  const float* sin_t, int rot_dim, int tld, int pos0, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (rot_dim % 4 == 0) {
    const int cpr = rot_dim / 4, lg = 32 - __clz(cpr - 1);  // p = 1 << lg >= cpr
    const int rr = lane >> lg, cc = lane & ((1 << lg) - 1), per_warp = 32 >> lg;
    if (cc >= cpr) return;
    for (int r = warp * per_warp + rr; r < rows; r += 4 * per_warp) {  // 4 warps
      const size_t src = (size_t)(pos0 + r) * rot_dim + 4 * cc;
      __pipeline_memcpy_async(tcos + r * tld + 4 * cc, cos_t + src, 16);
      __pipeline_memcpy_async(tsin + r * tld + 4 * cc, sin_t + src, 16);
    }
    return;
  }
  for (int r = warp; r < rows; r += 4)
    for (int c = lane; c < rot_dim / 2; c += 32) {
      const size_t src = (size_t)(pos0 + r) * rot_dim + 2 * c;
      __pipeline_memcpy_async(tcos + r * tld + 2 * c, cos_t + src, 8);
      __pipeline_memcpy_async(tsin + r * tld + 2 * c, sin_t + src, 8);
    }
}

// y1 = x1 cos1 - x2 sin1, y2 = x2 cos2 + x1 sin2 in f32, each product and
// the sum rounded on its own (no contraction into fma), as torch computes
// `t * cos + rotate_half(t) * sin`.
__device__ __forceinline__ float2 rotate_pair(float x1, float x2, float c1, float s1, float c2,
                                              float s2) {
  return make_float2(__fadd_rn(__fmul_rn(x1, c1), -__fmul_rn(x2, s1)),
                     __fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2)));
}

// Rotate the first rot_dim columns of a tile's `rows` valid rows in place
// with the table rows in shared memory, two threads a row: half-split with
// h = rot_dim / 2, column c < h pairs with c + h, rounded to bf16; the other
// columns pass through. An even h moves two neighbouring columns at a time
// (bf16x2 and float2 accesses).
template <int D>
__device__ void rope_tile(__nv_bfloat16* tile, const float* tcos, const float* tsin, int tld,
                          int rot_dim, int rows) {
  constexpr int LD = Layout<D>::LD;
  const int half = rot_dim / 2, r = threadIdx.x >> 1;
  if (r >= rows) return;
  __nv_bfloat16* row = tile + r * LD;
  const float* cr = tcos + r * tld;
  const float* sr = tsin + r * tld;
  if (half % 2 == 0) {
    for (int c = 2 * (threadIdx.x & 1); c < half; c += 4) {
      const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
      const float2 x2 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c + half));
      const float2 c1 = *reinterpret_cast<const float2*>(cr + c);
      const float2 s1 = *reinterpret_cast<const float2*>(sr + c);
      const float2 c2 = *reinterpret_cast<const float2*>(cr + c + half);
      const float2 s2 = *reinterpret_cast<const float2*>(sr + c + half);
      const float2 a = rotate_pair(x1.x, x2.x, c1.x, s1.x, c2.x, s2.x);
      const float2 b = rotate_pair(x1.y, x2.y, c1.y, s1.y, c2.y, s2.y);
      *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(a.x, b.x);
      *reinterpret_cast<__nv_bfloat162*>(row + c + half) = __floats2bfloat162_rn(a.y, b.y);
    }
    return;
  }
  for (int c = threadIdx.x & 1; c < half; c += 2) {
    const float2 y = rotate_pair(__bfloat162float(row[c]), __bfloat162float(row[c + half]),
                                 cr[c], sr[c], cr[c + half], sr[c + half]);
    row[c] = __float2bfloat16(y.x);
    row[c + half] = __float2bfloat16(y.y);
  }
}

template <int D, bool ROPE>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 Strides sq, Strides sk, Strides sv, Strides so,
                 int H, int N, int left, int right, float scale,
                 const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                 int rot_dim) {
  constexpr int LD = Layout<D>::LD;
  constexpr int TE = Layout<D>::TILE_ELEMS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sq_tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk_tile = sq_tile + TE;      // two stages
  __nv_bfloat16* sv_tile = sq_tile + 3 * TE;  // two stages
  // with the rotary: one stage of cos and sin table rows, padded by 4 floats
  const int tld = rot_dim + 4;
  float* tcos = reinterpret_cast<float*>(smem_raw + Layout<D>::SMEM_BYTES);
  float* tsin = tcos + TILE * tld;

  const int n_tiles = (N + TILE - 1) / TILE;
  const int tile = n_tiles - 1 - blockIdx.x;  // longest causal rows first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const int q0 = tile * TILE;
  const int nrows = min(TILE, N - q0);

  // the key tiles that hold a key of the band [q0 - left, q0 + 63 + right]
  const int kt_lo = left >= 0 ? max(q0 - left, 0) / TILE : 0;
  const int kt_hi = right >= 0 ? min(q0 + TILE - 1 + right, N - 1) / TILE : n_tiles - 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2;          // fragment row: query rows g and g + 8 of the warp's 16
  const int c2 = (lane & 3) * 2;    // fragment columns c2, c2 + 1 of each 8-wide tile
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;  // absolute query rows

  auto fetch = [&](int kt) {
    const int key0 = kt * TILE, nkeys = min(TILE, N - key0);
    const int stage = (kt - kt_lo) & 1;
    load_tile_async<D>(sk_tile + stage * TE, kb + key0 * sk.n, sk.n, nkeys);
    load_tile_async<D>(sv_tile + stage * TE, vb + key0 * sv.n, sv.n, nkeys);
    if (ROPE) load_tables_async(tcos, tsin, cos_t, sin_t, rot_dim, tld, key0, nkeys);
    __pipeline_commit();
  };

  load_tile_async<D>(sq_tile, qb + q0 * sq.n, sq.n, nrows);
  if constexpr (ROPE) {
    load_tables_async(tcos, tsin, cos_t, sin_t, rot_dim, tld, q0, nrows);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    rope_tile<D>(sq_tile, tcos, tsin, tld, rot_dim, nrows);
    __syncthreads();  // the query tile is rotated; the table stage is free
    fetch(kt_lo);
  } else {
    __pipeline_commit();
    fetch(kt_lo);
    __pipeline_wait_prior(1);  // the query tile has landed
    __syncthreads();
  }

  // Q as A operands, one per 16-wide slice of the head dim
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], sq_tile + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  const float scale_log2 = scale * 1.4426950408889634f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int key0 = kt * TILE;
    const int stage = (kt - kt_lo) & 1;
    __nv_bfloat16* ks = sk_tile + stage * TE;
    const __nv_bfloat16* vs = sv_tile + stage * TE;
    // a tile wholly inside the band for every row of the query tile, with
    // no ragged keys, needs no per-element mask
    const bool masked = key0 + TILE > N ||
                        (left >= 0 && key0 < q0 + TILE - 1 - left) ||
                        (right >= 0 && key0 + TILE - 1 > q0 + right);
    if constexpr (ROPE) {
      __pipeline_wait_prior(0);  // tile kt and its table rows have landed
      __syncthreads();
      // this query tile's own rotated copy of the key tile
      rope_tile<D>(ks, tcos, tsin, tld, rot_dim, min(TILE, N - key0));
      // every warp is done rotating tile kt (the table stage is free) and
      // with the products of tile kt-1 (its K/V stage may be overwritten)
      __syncthreads();
      if (kt < kt_hi) fetch(kt + 1);
    } else {
      __syncthreads();  // every warp is done with tile kt-1: its stage may be overwritten
      if (kt < kt_hi) {
        fetch(kt + 1);
        __pipeline_wait_prior(1);  // tile kt has landed; kt+1 stays in flight
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
    }

    // S = Q K^T: 8 tiles of 8 keys; one ldmatrix gives the B fragments of two
    // 16-wide slices of the head dim
    float s[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int hh = 0; hh < D / 32; ++hh) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (j * 8 + (lane & 7)) * LD + hh * 32 + (lane >> 3) * 8);
        mma_16x8x16(s[j], qa[2 * hh], kf[0], kf[1]);
        mma_16x8x16(s[j], qa[2 * hh + 1], kf[2], kf[3]);
      }
    }

    // mask, running max and sum; a row's 64 scores lie in the 4 lanes of a quad
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool keep = true;
        if (masked) {
          const int key = key0 + j * 8 + c2 + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          keep = key < N && (left < 0 || key >= row - left) && (right < 0 || key <= row + right);
        }
        s[j][e] = keep ? s[j][e] * scale_log2 : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // a row that has seen no visible key yet keeps m = -inf: exponents from 0
    const float use_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float use_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float alpha_lo = exp2f(m_lo - use_lo), alpha_hi = exp2f(m_hi - use_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    // P = exp2(S - m), summed in f32 and rounded to bf16 for the product; two
    // neighbouring 8-key tiles of the accumulator layout are one A operand
    float sum_lo = 0.f, sum_hi = 0.f;
    uint32_t pa[TILE / 16][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float p0 = exp2f(s[j][0] - use_lo), p1 = exp2f(s[j][1] - use_lo);
      const float p2 = exp2f(s[j][2] - use_hi), p3 = exp2f(s[j][3] - use_hi);
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;

    // O = alpha O + P V: D/8 tiles of 8 head dims; V's rows are keys, the B
    // operand's depth, so its fragments are read transposed: one ldmatrix
    // gives the fragments of two 16-key slices
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha_lo;
      o[j][1] *= alpha_lo;
      o[j][2] *= alpha_hi;
      o[j][3] *= alpha_hi;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (half * 32 + lane) * LD + j * 8);
        mma_16x8x16(o[j], pa[2 * half], vf[0], vf[1]);
        mma_16x8x16(o[j], pa[2 * half + 1], vf[2], vf[3]);
      }
    }
  }

  // l is clamped as in the TPU kernel: no row of these masks is empty, but a
  // zero-filled row past N may be
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const float ln2 = 0.6931471805599453f;
  if (row_lo < N) {
    __nv_bfloat16* dst = out + b * so.b + h * so.h + row_lo * so.n + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][0] * inv_lo, o[j][1] * inv_lo);
    if ((lane & 3) == 0)
      lse[((size_t)b * H + h) * N + row_lo] = m_lo * ln2 + logf(fmaxf(l_lo, 1e-30f));
  }
  if (row_hi < N) {
    __nv_bfloat16* dst = out + b * so.b + h * so.h + row_hi * so.n + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][2] * inv_hi, o[j][3] * inv_hi);
    if ((lane & 3) == 0)
      lse[((size_t)b * H + h) * N + row_hi] = m_hi * ln2 + logf(fmaxf(l_hi, 1e-30f));
  }
}

template <int D, bool ROPE>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const Strides* s, int B, int H, int N, int left, int right, float scale,
           const float* cos_t, const float* sin_t, int rot_dim, cudaStream_t stream) {
  const int smem = Layout<D>::SMEM_BYTES + (ROPE ? 2 * TILE * (rot_dim + 4) * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, ROPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TILE - 1) / TILE, B * H);
  flash_fwd_kernel<D, ROPE><<<grid, 128, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, (float*)lse, s[0], s[1], s[2], s[3], H, N, left, right, scale,
      cos_t, sin_t, rot_dim);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, void* lse,
             const Strides* s, int B, int H, int N, int left, int right, float scale,
             const float* cos_t, const float* sin_t, int rot_dim, cudaStream_t stream) {
  if (rot_dim > 0)
    return launch<D, true>(q, k, v, out, lse, s, B, H, N, left, right, scale, cos_t, sin_t,
                           rot_dim, stream);
  return launch<D, false>(q, k, v, out, lse, s, B, H, N, left, right, scale, nullptr, nullptr,
                          0, stream);
}

}  // namespace

// q, k, v, out: bf16 [B, H, N, D] with element strides (batch, head, row)
// given per operand in `strides` (12 values: q, k, v, out; the last axis is
// contiguous); lse [B, H, N] f32. left / right: the window bounds, -1 for an
// unbounded side (causal: right = 0). cos_t, sin_t: f32 [N, rot_dim]
// rotary tables, row-major, applied to q and k inside the kernel when
// rot_dim > 0 (null and 0 for none). D is 64 or 128 and rot_dim an even
// value in [0, D]; anything else returns cudaErrorInvalidValue.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         const long long* strides, int B, int H, int N, int D, int left,
                         int right, float scale, const void* cos_t, const void* sin_t,
                         int rot_dim, void* stream) {
  Strides s[4];
  for (int i = 0; i < 4; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (rot_dim < 0 || rot_dim > D || rot_dim % 2 || (rot_dim > 0 && (!cos_t || !sin_t)))
    return (int)cudaErrorInvalidValue;
  const float* c = (const float*)cos_t;
  const float* sn = (const float*)sin_t;
  if (D == 64)
    return launch_d<64>(q, k, v, out, lse, s, B, H, N, left, right, scale, c, sn, rot_dim,
                        (cudaStream_t)stream);
  if (D == 128)
    return launch_d<128>(q, k, v, out, lse, s, B, H, N, left, right, scale, c, sn, rot_dim,
                         (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
