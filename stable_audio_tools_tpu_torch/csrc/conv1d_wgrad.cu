// Weight and bias gradients of a stride-1 conv1d, with or without a fused
// snake-beta on its input, bf16 in, f32 out, for Hopper (sm_90a).
//
// Replaces the TPU kernels stable_audio_tools_tpu/ops/kernels/conv1d_snake.py
// `_bwd_dw_kernel_snake` (SNAKE = true; reached from `_snake_conv1d_bwd`
// through `_run_bwd_dw`) and `_bwd_dw_kernel_plain` (SNAKE = false; reached
// from `conv1d_wgrad`, which ops/conv.py `_conv1d_s1_bwd` calls):
//
//   dW[co, ci, j] = sum_b sum_t dy[b, co, t] * s(x)pad[b, ci, t + j*d]
//   db[co]        = sum_b sum_t dy[b, co, t]
//
// with s = snake(x; alpha, beta) (exact sinf in f32, rounded to bf16 as the
// forward kernels round it: the same code, snake_conv.cuh) or the identity,
// and xpad[t'] = x[t' - pad_lo], exactly 0 outside [0, L) (JAX
// `_snake_window`). Products of bf16 values accumulate in f32.
//
// Layout: dy [B, Co, Lout] and x [B, Ci, L] (channels before time); dW
// [Co, Ci, k] (torch's weight layout) and db [Co], both f32.
//
// Bound on the H100: 2*B*Lout*Ci*Co*k operations; at the Oobleck path's
// k = 7 widths the tensor cores bound it, the k = 1 convs at C <= 256 and
// the narrow convs (Ci = 2 of the encoder's conv_in, 128 -> 2 of the
// decoder's conv_out) are bound by reading dy and x. Exact sinf is ~20 FP32
// instructions an element, so the snake has to run once per x element and
// block, and under the products.
//
// The design: an implicit GEMM whose reduction is time, D_j[co, ci] +=
// sum_t dy[co, t] window[t + j*d, ci], the tap shift on the window.
// - A block owns one chunk of 64 input channels (N = 64), one tile of output
//   channels (M) and up to 8 taps, and walks its share of the (batch row,
//   T-sample chunk) sequence, T = 256 or 128 (the wrapper's `wgrad_tile`:
//   256 where two dy stages fit beside the windows at any span; the longer
//   chunk halves the per-chunk hand-offs, 20-30% of the time at k = 7).
//   Producer warps build the snake'd window of each chunk once (T + (k-1)*d
//   rows, the forward's producers and layout: time-major rows of 8
//   channels, no swizzle; consecutive chunks of a batch row carry the halo)
//   and every tap reads it: the window is the MN-major B operand of `wgmma`
//   m64n64k16, and tap j's operand starts j*d rows down (a descriptor start
//   at any 16-byte row; the two 8-row halves of a k-step 128 bytes apart,
//   the 8-channel groups a column apart). dy is the K-major A operand,
//   time-contiguous as it lies in memory, brought by TMA in the 128-byte
//   swizzle (T / 64 boxes of 64 samples a chunk, rows past Co and samples
//   past Lout zero-filled) into a ring of stages.
// - Two consumer warpgroups (`setmaxnreg` 168 / 88) share the window and the
//   dy stage; each keeps at most 4 (taps x 64-row tiles) of 64 x 64 f32
//   accumulators (128 registers). With more than 4 taps, or Co <= 64, the
//   two split the taps (k = 7: taps 0-3 and 4-6) over one 64-channel co
//   tile; otherwise they split the co tile (128 channels, or 256 with two
//   64-row tiles each where k <= 2 and Co > 128), so each x element is
//   snake'd once per 64, 128 or 256 output channels. At k = 7 the snake is
//   then about half the kernel's time (the plain instance at the same shape
//   takes half as long): the per-element snake, not the products, bounds it.
// - The reduction over B*L is split S ways, S sized so the blocks about fill
//   the SMs (one a SM); each split's partial is written to a workspace
//   [S, k, Co, Ci] and `conv1d_wgrad_reduce` sums the S partials in a fixed
//   order. No atomics: the result does not depend on the schedule. db
//   partials [S, Co] come from the warpgroups of the blocks of input chunk 0
//   whose taps start at 0, summed from the dy stages they already hold.
// - The narrow convs take the same tiles: at Ci = 2 (the plain conv_in) 62 of
//   the 64 window channels are zero and at Co = 2 (the decoder's conv_out) 62
//   of 64 dy rows, so their products are padded 32x. Built with the products
//   switched off (scripts/snake_conv_bwd_probe.py narrow; H100 80GB HBM3,
//   700 W) they take 0.08 of 0.12 ms at the conv_in and 0.20 of 0.24 ms at
//   the conv_out, where the snake takes 0.10: folding the taps into a
//   narrower wgmma N could save at most the difference, so they keep these
//   tiles.

#include "snake_conv.cuh"

namespace {

struct WArgs {
  const __nv_bfloat16* x;  // [B, Ci, L]
  const float* alpha;
  const float* beta;
  float* ws;    // [S, k, Co, Ci]
  float* dbws;  // [S, Co] or null
  int Ci, Co, L, Lout, k, d, pad_lo, carry;
  int tiles, total, per;   // chunks a batch row, B * tiles, chunks a split
  int co_blk, n_ci, n_tg, split_taps, stages;
};

// One thread: dy's T / 64 boxes of 64 samples x co_blk rows for each chunk
// of the block's sequence, into the stages.
template <int WT>
__device__ __forceinline__ void load_dy(const CUtensorMap* map, uint32_t base, uint32_t dfull,
                                        uint32_t dempty, const WArgs& a, int s0, int s1,
                                        int co0) {
  const int bytes = a.co_blk * WT * 2;
  int q = 0;
  for (int seq = s0; seq < s1; ++seq, ++q) {
    const int b = seq / a.tiles, tile = seq % a.tiles, st = q % a.stages, n = q / a.stages;
    if (n > 0) mbar_wait(dempty + 8 * st, (n - 1) & 1);
    mbar_expect_tx(dfull + 8 * st, bytes);
    for (int h = 0; h < WT / 64; ++h)
      tma_3d(base + st * bytes + h * a.co_blk * 128, map, dfull + 8 * st, tile * WT + 64 * h,
             co0, b);
  }
}

// A consumer warpgroup: MT 64-row co tiles (rows mrow + 64 m of the stage)
// x NT taps (jb, jb + 1, ...) of 64 x 64 accumulators over the sequence,
// then its partial into ws[split]; with `db` also the sums of its dy rows.
template <int MT, int NT, int WT>
__device__ __forceinline__ void consume_w(const WArgs& a, const Layout& lay, uint32_t base,
                                          unsigned char* smem, uint32_t dfull, uint32_t dempty,
                                          uint32_t xfull, uint32_t xempty, int s0, int s1,
                                          int split, int co0, int mrow, int ci0, int jb,
                                          bool db) {
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
  const int bytes = a.co_blk * WT * 2;
  float acc[MT][NT > 0 ? NT : 1][32];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < (NT > 0 ? NT : 1); ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[m][j][e] = 0.f;
  // db: MT = 1, two threads a row (a 64-sample box each); MT = 2, one a row
  const int drow = MT == 1 ? tid / 2 : tid, dbox0 = MT == 1 ? tid % 2 : 0;
  float dsum = 0.f;
  int q = 0;
  for (int seq = s0; seq < s1; ++seq, ++q) {
    const int buf = q & 1, st = q % a.stages;
    mbar_wait(xfull + 8 * buf, (q >> 1) & 1);
    mbar_wait(dfull + 8 * st, (q / a.stages) & 1);
    const uint32_t xw = base + lay.x + buf * lay.xw, dys = base + st * bytes;
    if constexpr (NT > 0) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WT / 16; ++kk)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint64_t da =
              desc(dys + (kk / 4) * a.co_blk * 128 + (mrow + 64 * m) * 128 + (kk % 4) * 32);
#pragma unroll
          for (int j = 0; j < (NT > 0 ? NT : 1); ++j)
            wgmma_k<64, 1>(acc[m][j], da,
                           desc_plain(xw + ((jb + j) * a.d + 16 * kk) * 16, 128, lay.chs));
        }
      wg_commit();
    }
    if (db) {  // the rows in any order of their 16-byte pieces: the swizzle moves only those
      const unsigned char* row = smem + st * bytes + (mrow + drow) * 128;
#pragma unroll
      for (int h = dbox0; h < WT / 64; h += (MT == 1 ? 2 : 1))
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + h * a.co_blk * 128 + c * 16);
          const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vw[e]));
            dsum += f.x + f.y;
          }
        }
    }
    if constexpr (NT > 0) wg_wait<0>();
    release(xempty, buf, lane);
    release(dempty, st, lane);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < (NT > 0 ? NT : 1); ++j) reg_fence(acc[m][j]);

  // acc[m][j] register 4 g + e: co row 16 w + lane / 4 + 8 (e / 2) of tile m,
  // ci column 8 g + 2 (lane % 4) + (e % 2)
  if constexpr (NT > 0)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float* out = a.ws + ((size_t)split * a.k + jb + j) * a.Co * a.Ci;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int co = co0 + mrow + 64 * m + 16 * w + lane / 4 + 8 * ((r >> 1) & 1);
          const int ci = ci0 + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
          if (co < a.Co && ci < a.Ci) out[(size_t)co * a.Ci + ci] = acc[m][j][r];
        }
      }
  if (db) {
    if constexpr (MT == 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    const int co = co0 + mrow + drow;
    if (dbox0 == 0 && co < a.Co) a.dbws[(size_t)split * a.Co + co] = dsum;
  }
}

template <int MT, int WT>
__device__ __forceinline__ void consumer(int nt, const WArgs& a, const Layout& lay,
                                         uint32_t base, unsigned char* smem, uint32_t dfull,
                                         uint32_t dempty, uint32_t xfull, uint32_t xempty,
                                         int s0, int s1, int split, int co0, int mrow, int ci0,
                                         int jb, bool db) {
#define WGRAD_CONSUME(N)                                                                        \
  consume_w<MT, N, WT>(a, lay, base, smem, dfull, dempty, xfull, xempty, s0, s1, split, co0, mrow, \
                   ci0, jb, db)
  if constexpr (MT == 1) {
    if (nt == 4) WGRAD_CONSUME(4);
    else if (nt == 3) WGRAD_CONSUME(3);
    else if (nt == 2) WGRAD_CONSUME(2);
    else if (nt == 1) WGRAD_CONSUME(1);
    else WGRAD_CONSUME(0);
  } else {
    if (nt == 2) WGRAD_CONSUME(2);
    else WGRAD_CONSUME(1);
  }
#undef WGRAD_CONSUME
}

template <int MT, bool SNAKE, int WT>
__global__ void __launch_bounds__(THREADS, 1)
conv1d_wgrad_kernel(const __grid_constant__ CUtensorMap dymap, const __grid_constant__ WArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const int span = (a.k - 1) * a.d;
  const Layout lay(a.stages * a.co_blk * WT * 2, WT, 0, span, 1, a.carry, a.stages);
  const uint32_t dfull = base + lay.bar, dempty = dfull + 8 * a.stages;
  const uint32_t xfull = dempty + 8 * a.stages, xempty = xfull + 16;
  // block: (split, (co tile, tap group, input chunk))
  const int split = blockIdx.x, cc = blockIdx.y % a.n_ci, tg = (blockIdx.y / a.n_ci) % a.n_tg;
  const int co0 = blockIdx.y / (a.n_ci * a.n_tg) * a.co_blk;
  const int s0 = split * a.per, s1 = min(s0 + a.per, a.total);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(dfull + 8 * s, 1);
      mbar_init(dempty + 8 * s, CONSUMERS / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(xfull + 8 * s, SNAKE_WARPS);
      mbar_init(xempty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n");
    if (tid < CONSUMERS + 32) {
      if (tid == CONSUMERS) load_dy<WT>(&dymap, base, dfull, dempty, a, s0, s1, co0);
    } else {
      int q = 0;  // the sequence as runs of consecutive chunks of one batch row
      for (int b = s0 / a.tiles; b * a.tiles < s1; ++b)
        fill_windows<WT, SNAKE, true>(a, lay, smem, xfull, xempty, b, max(s0 - b * a.tiles, 0),
                                      min(s1 - b * a.tiles, a.tiles), cc, cc + 1, q);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 168;\n");
    const int wg = tid / 128, j0 = 8 * tg, kg = min(8, a.k - j0);
    int jb = j0, nt = kg, mrow = 0;
    if (a.split_taps) {  // one co tile, the group's taps halved
      const int first = (kg + 1) / 2;
      jb = j0 + (wg ? first : 0);
      nt = wg ? kg - first : first;
    } else {  // the co tile halved, every tap of the group
      mrow = wg * MT * 64;
    }
    const bool db = a.dbws != nullptr && cc == 0 && jb == 0;
    consumer<MT, WT>(nt, a, lay, base, smem, dfull, dempty, xfull, xempty, s0, s1, split, co0, mrow,
                 cc * CIC, jb, db);
  }
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

// The rest of the plan for the wrapper's (mt, split_taps): out = {carry,
// dy stages, shared-memory bytes}; false where the shape is refused.
bool wplan(int B, int Ci, int Co, int Lout, int k, int d, int S, int mt, int split_taps, int WT,
           int* out) {
  if ((k - 1) * d > MAX_SPAN || k < 1 || d < 1 || (mt != 1 && mt != 2)) return false;
  if (WT != 128 && WT != 256) return false;
  const int kg = k < 8 ? k : 8, span = (k - 1) * d, total = B * ((Lout + WT - 1) / WT);
  // a warpgroup holds at most 4 (taps x 64-row tiles) of accumulators
  if (split_taps ? mt != 1 : kg * mt > 4) return false;
  if (S < 1 || S > total) return false;
  const int co_blk = split_taps ? 64 : 128 * mt, per = (total + S - 1) / S;
  auto bytes = [&](int stages, bool carry) {
    return Layout(stages * co_blk * WT * 2, WT, 0, span, 1, carry, stages).bytes;
  };
  int stages = 4;
  while (bytes(stages, false) > SMEM_MAX)
    if (--stages < 2) return false;
  const int carry = per > 1 && span > 0 && span <= WT && bytes(stages, true) <= SMEM_MAX;
  out[0] = carry, out[1] = stages, out[2] = bytes(stages, carry);
  return true;
}

template <int MT, bool SNAKE, int WT>
int launch_w(const CUtensorMap& map, const WArgs& a, int S, int n_blk, int smem,
             cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const int err = set_smem(conv1d_wgrad_kernel<MT, SNAKE, WT>, SMEM_MAX);
    if (err) return err;
    ready = true;
  }
  conv1d_wgrad_kernel<MT, SNAKE, WT><<<dim3(S, n_blk), THREADS, smem, stream>>>(map, a);
  return (int)cudaGetLastError();
}

}  // namespace

// dy bf16 [B, Co, Lout] with rows `ld` samples apart (ld % 8 == 0, ld >=
// Lout; 16-byte aligned), x bf16 [B, Ci, L], alpha / beta f32 [Ci] (null for
// the plain conv), ws f32 [S, k, Co, Ci] and dbws [S, Co], dW f32 [Co, Ci,
// k], db f32 [Co] or null; (S, mt, split_taps) the wrapper's plan
// (`wgrad_splits`, `wgrad_tile`).
extern "C" int conv1d_wgrad(const void* dy, const void* x, const void* alpha, const void* beta,
                            void* ws, void* dbws, void* dW, void* db, int B, int Co, int Ci,
                            int L, int Lout, int ld, int k, int d, int pad_lo, int S, int mt,
                            int split_taps, int T, void* stream) {
  int p[3];
  if (!wplan(B, Ci, Co, Lout, k, d, S, mt, split_taps, T, p) || ld % 8 || ld < Lout)
    return (int)cudaErrorInvalidValue;
  const int co_blk = split_taps ? 64 : 128 * mt;
  const int tiles = (Lout + T - 1) / T, total = B * tiles;
  const WArgs a{(const __nv_bfloat16*)x, (const float*)alpha, (const float*)beta, (float*)ws,
                db != nullptr ? (float*)dbws : nullptr, Ci, Co, L, Lout, k, d, pad_lo, p[0],
                tiles, total, (total + S - 1) / S, co_blk, (Ci + CIC - 1) / CIC, (k + 7) / 8,
                split_taps, p[1]};
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap map;  // dy as [B][Co][Lout], rows ld samples apart
  const cuuint64_t dims[3] = {(cuuint64_t)Lout, (cuuint64_t)Co, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)Co * ld * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)co_blk, 1}, unit[3] = {1, 1, 1};
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(dy), dims, strides, box,
          unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_blk = ((Co + co_blk - 1) / co_blk) * a.n_tg * a.n_ci;
  const bool snake = alpha != nullptr;
#define WGRAD_LAUNCH(M, W)                                                     \
  (snake ? launch_w<M, true, W>(map, a, S, n_blk, p[2], s)                     \
         : launch_w<M, false, W>(map, a, S, n_blk, p[2], s))
  int err = mt == 2 ? (T == 256 ? WGRAD_LAUNCH(2, 256) : WGRAD_LAUNCH(2, 128))
                    : (T == 256 ? WGRAD_LAUNCH(1, 256) : WGRAD_LAUNCH(1, 128));
#undef WGRAD_LAUNCH
  if (err != 0) return err;
  const size_t n = (size_t)Co * Ci * k + (db != nullptr ? Co : 0);
  conv1d_wgrad_reduce<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)ws, (const float*)dbws, (float*)dW, (float*)db, S, k, Co, Ci);
  return (int)cudaGetLastError();
}
