// Flash-attention forward that reads q, k, v from and writes out to the
// [B, N, H, 64] activation layout through strides, bf16 in, f32 accumulation,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel stable_audio_tools_tpu/ops/kernels/flash_attention.py
// `_flash_nhd_pair_kernel` (reached from `flash_attention_nhd` through
// `_nhd_forward`). Same function: out = softmax(QK^T/sqrt(d))V per (batch,
// head) over all N keys, non-causal with the first P <= 128 rows a prepended
// prefix, or causal with P = 0, plus the f32 logsumexp. P (the probabilities)
// is rounded to bf16 before PV, as in the TPU kernel.
//
// What the TPU kernel is built around and this one is not: the head pair that
// fills a 128-lane tile, the block-diagonal K/V packing that fills a 128-deep
// matrix unit, an even head count, separate dense products for the prefix
// query rows. On Hopper the point of this entry is the layout: every block
// computes its own offsets from the tensors' strides (batch, row and head
// stride in elements; the last axis is contiguous), so q, k and v may be
// views of one fused [B, N, 3*H*64] projection output (row stride 3*H*64) or
// freshly made [B, N, H, 64] tensors (row stride H*64), each with strides of
// its own, and out is written as [B, N, H*64], the operand of the output
// projection. No transposed or contiguous copy is made on either side. The
// 64-element rows (128 bytes) move as 16-byte vectors; the wrapper checks that
// base pointers and strides keep them 16-byte aligned.
//
// Grid: one 128-thread block (4 warps) per (64-row query tile, b*H + h). Query
// tiles 0..ceil(Nm/64)-1 cover the main rows [P, N); ceil(P/64) more tiles
// cover the prefix rows with the same code. Each block streams the main K/V in
// 64-key tiles through shared memory, then the prefix keys as one or two more
// masked tiles, with the online softmax. Causal blocks stop at their diagonal
// tile and mask keys past the query row there. The ragged tail (N = 6145 is a
// multiple of no tile) is zero-filled, masked to -inf on the key side and
// never stored on the query side. lse is written as [B, H, N] f32, the layout
// the backward kernels read.
//
// Bound on the H100: at SA-2.0's shape (q, k, v [2, 6145, 24, 64]) the work is
// 4*B*H*N^2*D ~ 464 GFLOP against ~151 MB of q/k/v/out, ~3000 FLOP/byte: the
// tensor cores bound it (0.47 ms at the bf16 peak). What the design does
// about it:
// - the products run as mma.sync m16n8k16 (bf16 in, f32 out) on fragments
//   that ldmatrix reads from shared memory: each warp owns 16 query rows, keeps
//   their Q fragments, the 16 x 64 scores and the 16 x 64 output in registers
//   for the whole key loop, and the scores' accumulator layout is, pair of
//   8-key tiles by pair, the A-operand layout of the PV product, so the
//   probabilities never touch shared memory;
// - the softmax works on those registers in the exp2 domain (the scale is
//   folded with log2 e), a row's 64 scores spread over the 4 lanes of a quad;
// - strided rows cost more to fetch than a contiguous tile (one DRAM page and
//   one TLB entry per few rows), so the next K/V tile is fetched with
//   cp.async into a second shared-memory stage while the current one is
//   computed on; rows are padded to 144 bytes so that ldmatrix's eight row
//   reads fall on distinct banks.
// No wgmma or TMA yet: mma.sync reaches a fraction of the warpgroup rate, so
// the kernel stays below the roofline (PERF.md has the measured share).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim (the only one supported)
constexpr int TILE = 64;     // query rows and keys per tile
constexpr int LDH = 72;      // bf16 row stride in shared memory (144 B)

struct Smem {
  __nv_bfloat16 q[TILE * LDH];      // the query tile, read once into fragments
  __nv_bfloat16 k[2][TILE * LDH];   // two stages: one computed on, one in flight
  __nv_bfloat16 v[2][TILE * LDH];
};

// element strides of one [B, N, H, 64] operand (last axis contiguous)
struct Strides {
  long long b, n, h;
};

// Start the copy of `rows` valid 64-element rows, `row_stride` elements apart,
// into shared memory as 16-byte cp.async transfers; rows past `rows` are
// zero-filled (their source is row 0, of which no byte is read).
__device__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                long long row_stride, int rows) {
  for (int i = threadIdx.x; i < TILE * (D / 8); i += blockDim.x) {
    int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool valid = r < rows;
    __pipeline_memcpy_async(dst + r * LDH + c, src + (valid ? r : 0) * row_stride + c,
                            16, valid ? 0 : 16);
  }
}

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
__device__ __forceinline__ void mma_16x8x16(float (&c)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
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

__global__ void __launch_bounds__(128)
flash_nhd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 Strides sq, Strides sk, Strides sv, Strides so,
                 int H, int N, int P, int causal, float scale) {
  __shared__ __align__(128) Smem sm;

  const int Nm = N - P;
  const int n_main = (Nm + TILE - 1) / TILE;
  const int n_pref = (P + TILE - 1) / TILE;
  const int tile = blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  int row0, nrows;
  if (tile < n_main) {
    row0 = P + tile * TILE;
    nrows = min(TILE, Nm - tile * TILE);
  } else {
    row0 = (tile - n_main) * TILE;
    nrows = min(TILE, P - row0);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2;          // fragment row: query rows g and g + 8 of the warp's 16
  const int c2 = (lane & 3) * 2;    // fragment columns c2, c2 + 1 of each 8-wide tile
  const int row_lo = warp * 16 + g, row_hi = row_lo + 8;  // query rows within the tile

  // causal (P == 0): key tiles up to and including the diagonal one
  const int n_key_tiles = causal ? tile + 1 : n_main + n_pref;
  auto key_tile = [&](int kt, int& key0, int& nkeys) {
    if (kt < n_main) {
      key0 = P + kt * TILE;
      nkeys = min(TILE, Nm - kt * TILE);
    } else {
      key0 = (kt - n_main) * TILE;
      nkeys = min(TILE, P - key0);
    }
  };
  auto fetch = [&](int kt) {
    int key0, nkeys;
    key_tile(kt, key0, nkeys);
    load_tile_async(sm.k[kt & 1], kb + key0 * sk.n, sk.n, nkeys);
    load_tile_async(sm.v[kt & 1], vb + key0 * sv.n, sv.n, nkeys);
    __pipeline_commit();
  };

  load_tile_async(sm.q, qb + row0 * sq.n, sq.n, nrows);
  __pipeline_commit();
  fetch(0);
  __pipeline_wait_prior(1);  // the query tile has landed
  __syncthreads();

  // Q as A operands, one per 16-wide slice of the head dim: matrices (rows
  // 0-7, lo 8 columns), (rows 8-15, lo), (rows 0-7, hi), (rows 8-15, hi)
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], sm.q + (warp * 16 + (lane & 15)) * LDH + kk * 16 + (lane >> 4) * 8);

  // scores and softmax in the exp2 domain
  const float scale_log2 = scale * 1.4426950408889634f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kt = 0; kt < n_key_tiles; ++kt) {
    int key0, nkeys;
    key_tile(kt, key0, nkeys);
    const bool diagonal = causal && kt == tile;
    const __nv_bfloat16* ks = sm.k[kt & 1];
    const __nv_bfloat16* vs = sm.v[kt & 1];
    // every warp is done with tile kt-1: its stage may be overwritten
    __syncthreads();
    if (kt + 1 < n_key_tiles) {
      fetch(kt + 1);
      __pipeline_wait_prior(1);  // tile kt has landed; kt+1 stays in flight
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    // S = Q K^T: 8 tiles of 8 keys. K's rows are the B operand as they lie
    // (B[d][key] = K[key][d]): one ldmatrix gives the fragments of two
    // 16-wide slices of the head dim
    float s[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (j * 8 + (lane & 7)) * LDH + half * 32 + (lane >> 3) * 8);
        mma_16x8x16(s[j], qa[2 * half], kf[0], kf[1]);
        mma_16x8x16(s[j], qa[2 * half + 1], kf[2], kf[3]);
      }
    }

    // mask, running max and sum; a row's 64 scores lie in the 4 lanes of a quad
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + c2 + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        const bool keep = key < nkeys && !(diagonal && key > row);
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

    // O = alpha O + P V: 8 tiles of 8 head dims. V's rows are keys, the B
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
        ldmatrix_x4_trans(vf, vs + (half * 32 + lane) * LDH + j * 8);
        mma_16x8x16(o[j], pa[2 * half], vf[0], vf[1]);
        mma_16x8x16(o[j], pa[2 * half + 1], vf[2], vf[3]);
      }
    }
  }

  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const float ln2 = 0.6931471805599453f;
  if (row_lo < nrows) {
    __nv_bfloat16* dst = out + b * so.b + (row0 + row_lo) * so.n + h * so.h + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][0] * inv_lo, o[j][1] * inv_lo);
    if ((lane & 3) == 0)
      lse[((size_t)b * H + h) * N + row0 + row_lo] = m_lo * ln2 + logf(fmaxf(l_lo, 1e-30f));
  }
  if (row_hi < nrows) {
    __nv_bfloat16* dst = out + b * so.b + (row0 + row_hi) * so.n + h * so.h + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][2] * inv_hi, o[j][3] * inv_hi);
    if ((lane & 3) == 0)
      lse[((size_t)b * H + h) * N + row0 + row_hi] = m_hi * ln2 + logf(fmaxf(l_hi, 1e-30f));
  }
}

}  // namespace

// q, k, v, out: bf16 [B, N, H, 64] with element strides (batch, row, head)
// given per operand in `strides` (12 values: q, k, v, out); lse [B, H, N] f32.
extern "C" int flash_nhd_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int B, int H, int N, int P, int causal,
                             float scale, void* stream) {
  Strides s[4];
  for (int i = 0; i < 4; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int Nm = N - P;
  dim3 grid((Nm + TILE - 1) / TILE + (P + TILE - 1) / TILE, B * H);
  flash_nhd_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)lse, s[0], s[1],
      s[2], s[3], H, N, P, causal, scale);
  return (int)cudaGetLastError();
}
