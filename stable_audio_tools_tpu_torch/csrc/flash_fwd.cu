// Flash-attention forward over [B, H, N, D] with D in {64, 128}, unmasked,
// causal or sliding-window, bf16 in, f32 accumulation, for Hopper (sm_90a).
//
// Replaces four TPU kernels of stable_audio_tools_tpu/ops/kernels/flash_attention.py,
// one function at four call sites:
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
//   partial rotary embedding applied to q and k (flash_rope_kernel below,
//   one pass ahead of the attention kernel).
// Same function: out = softmax(QK^T/sqrt(D) + mask) V per (batch, head), plus
// the f32 logsumexp, where key j is visible from query i iff
//   j < N, j >= i - left (left >= 0), j <= i + right (right >= 0);
// left = right = -1 is unmasked, causal attention is right = 0 (the wrapper
// folds `causal` into right, as min(right, 0) when a window is given too). P
// (the probabilities) is rounded to bf16 before PV, as in the TPU kernels.
//
// Bound on the H100: the work is 4 D per visible (query, key) pair. At
// SA-2.0's unmasked shape ([2, 24, 6145, 64]) that is ~464 GFLOP against
// ~151 MB: the tensor cores bound it (0.47 ms). Under the causal mask at the
// LM's training shape ([4, 16, 500, 64]) it is ~2.1 GFLOP against ~16.5 MB,
// ~125 FLOP/byte, so memory bounds it (4.9 us); at 1503 rows the operations
// do. At TAAE's windowed shapes the band cuts the operations to
// 4 B H N (left + right + 1) D while the bytes stay, and memory bounds them.
// At D = 64 the exponentials weigh as much as the products: one MUFU ex2 (16
// a clock an SM) per 256 tensor-core FLOP (4,096 a clock), so the softmax
// has to run under the products.
//
// The design (flash_fwd_tma_kernel<D>):
// - 128 query rows a block in two consumer warpgroups of 64 rows and one
//   producer warpgroup; `setmaxnreg` moves the producer's registers to the
//   consumers (24 / 240 a thread);
// - one producer thread issues TMA loads: the block's Q once, then K and V
//   tiles of 128 keys into a ring of stages (3 at D = 64, 2 at D = 128), each
//   stage guarded by a "full" mbarrier (TMA bytes landed) and an "empty" one
//   (all eight consumer warps done with it), so the loads of the next tiles
//   run under the products of the current one and every K/V tile is fetched
//   once per 128 query rows;
// - the operands are 4-D tensor maps over the caller's strides (the outer
//   three axes ordered by stride), so [B, N, H, D] projections and views of
//   one fused [B, N, 3*H*D] QKV output are read without copies; rows past N
//   come back zero-filled and are masked to -inf on the key side and never
//   stored on the query side; the 128-byte swizzle is what the wgmma
//   descriptors read;
// - S = Q K^T is `wgmma` m64n128k16 with both operands in shared memory,
//   K-major; the online softmax runs in the accumulator registers in the
//   exp2 domain (the scale folded with log2 e into one FMA), a row's 128
//   scores over the 4 lanes of a quad, its max and its sum each in four
//   independent chains (one serial chain a row cost 1.7x the kernel's time:
//   with two warps a scheduler, nothing hides its latency); P is rounded to
//   bf16 in registers and O += P V is `wgmma` m64n64k16 with P as register A
//   (the accumulator layout of S is the A fragment layout) and V read
//   MN-major;
// - at D = 64 (OVERLAP) each warpgroup issues the scores of tile i + 1
//   together with the PV product of tile i and computes the exponentials of
//   tile i + 1 while that product runs (O is rescaled once it is done); at
//   D = 128, where O is 64 f32 a thread, that overlap measured slower and the
//   products run one after the other;
// - band skipping (the TPU kernel's `_q_visible_range`) over 128-row blocks:
//   a block visits only the key tiles that hold a key of
//   [q0 - left, q0 + 127 + right], and tiles wholly inside the band for all of
//   a warpgroup's rows skip the per-element mask (at D = 128 a warpgroup
//   also skips the products of a tile none of its 64 rows sees); blocks take
//   the query blocks from the last to the first, so under a causal mask the
//   longest rows start first;
// - the shared-memory limit is set once per instantiation, not per launch.
// PERF.md records the variants measured against this one on the H100 (64-key
// tiles, a lone producer warp without `setmaxnreg`, the two warpgroups
// taking turns at the tensor cores, the mma.sync / cp.async kernel it
// replaced): none was faster on the main paths' shapes.
//
// Rotary (flash_fwd_rope): q and k are rotated once per (batch, row, head)
// in a pass ahead of the attention, into contiguous [B, N, H, D] buffers that
// the attention kernel then reads (v stays a view of the projection): the
// first rot_dim columns, half-split (y1 = x1 cos - x2 sin,
// y2 = x2 cos + x1 sin, each product and sum rounded as torch's elementwise
// ops round them, the result rounded to bf16, as the TPU kernel rounds
// before its products), the other columns copied. A K tile is so rotated
// once, not once per query tile that visits it, and no table load stands
// between the attention kernel's K/V loads.

#include <math.h>

#include "hopper.cuh"

namespace {

// element strides of one [B, H, N, D] operand (last axis contiguous)
struct Strides {
  long long b, h, n;
};

constexpr int BM = 128;            // query rows a block
constexpr int QROWS = 64;          // query rows of one consumer warpgroup
constexpr int BN = 128;            // keys a K / V tile
constexpr int CONSUMERS = 256;     // two consumer warpgroups, then the producer
constexpr int THREADS = CONSUMERS + 128;

// Shared memory (byte offsets from a 1024-aligned base): the two warpgroups'
// Q tiles, the K and V stages, the barriers. A [rows][D] tile is D / 64
// sub-tiles of [rows][64 bf16] in the 128-byte swizzle.
template <int D>
struct TmaSmem {
  static constexpr int STAGES = D == 64 ? 3 : 2;  // K/V ring stages
  static constexpr int Q_SUB = QROWS * 128;
  static constexpr int KV_SUB = BN * 128;
  static constexpr int Q_TILE = D / 64 * Q_SUB;
  static constexpr int KV_TILE = D / 64 * KV_SUB;
  static constexpr int Q = 0;
  static constexpr int K = Q + 2 * Q_TILE;
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int BAR = V + STAGES * KV_TILE;  // q, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + the base's alignment
};

// One box (64 columns x the map's rows x 1 head x 1 batch) of an operand's
// 4-D map, whose outer axes are ordered by stride: `order` holds the
// positions (1-3) of the row, head and batch axes, 2 bits each.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int order, int col, int row, int h, int b) {
  const int pn = order & 3, ph = (order >> 2) & 3;
  const int c1 = pn == 1 ? row : ph == 1 ? h : b;
  const int c2 = pn == 2 ? row : ph == 2 ? h : b;
  const int c3 = pn == 3 ? row : ph == 3 ? h : b;
  tma_4d(dst, map, bar, col, c1, c2, c3);
}

// One consumer warpgroup's state and steps over its 64 query rows.
template <int D>
struct Rows {
  using S = TmaSmem<D>;
  uint32_t q_s;
  int r0, r_lo, c_lane, N, left, right;
  float sl2;
  float o[D / 64][32];
  // running max (scaled, log2 domain) and this thread's part of the row sums
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  // issue S = Q K^T for the K tile at k_s (not committed)
  __device__ __forceinline__ void scores(float (&s)[BN / 2], uint32_t k_s) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, desc(q_s + (kk >> 2) * S::Q_SUB + (kk & 3) * 32),
                    desc(k_s + (kk >> 2) * S::KV_SUB + (kk & 3) * 32), kk);
  }

  // the online softmax of the scores of keys [k0, k0 + BN): mask, new max,
  // P = exp2(S s log2 e - m) in place (f32), the row sums; returns the
  // factors (lo, hi rows) by which O must be rescaled
  __device__ __forceinline__ float2 softmax(float (&s)[BN / 2], int k0) {
    // a tile wholly inside the band for all 64 rows, with no ragged keys,
    // needs no per-element mask
    const bool masked = k0 + BN > N || (left >= 0 && k0 < r0 + QROWS - 1 - left) ||
                        (right >= 0 && k0 + BN - 1 > r0 + right);
    if (masked) {
#pragma unroll
      for (int g = 0; g < BN / 8; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * g + c_lane + (e & 1), row = r_lo + 8 * (e >> 1);
          if (!(key < N && visible(row, key, left, right))) s[4 * g + e] = -INFINITY;
        }
    }
    // the row maxima and sums in four independent chains each (latency)
    float mx[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[0][c] = fmaxf(s[4 * c], s[4 * c + 1]);
      mx[1][c] = fmaxf(s[4 * c + 2], s[4 * c + 3]);
    }
#pragma unroll
    for (int g = 4; g < BN / 8; ++g) {
      mx[0][g & 3] = fmaxf(mx[0][g & 3], fmaxf(s[4 * g], s[4 * g + 1]));
      mx[1][g & 3] = fmaxf(mx[1][g & 3], fmaxf(s[4 * g + 2], s[4 * g + 3]));
    }
    float mx_lo = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
    float mx_hi = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo * sl2), mn_hi = fmaxf(m_hi, mx_hi * sl2);
    // a row that has seen no visible key yet keeps m = -inf: exponents from 0
    const float use_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float use_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float2 alpha = make_float2(exp2_approx(m_lo - use_lo), exp2_approx(m_hi - use_hi));
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum[2][4] = {};
#pragma unroll
    for (int g = 0; g < BN / 8; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(s[4 * g + e], sl2, -(e < 2 ? use_lo : use_hi)));
        s[4 * g + e] = p;
        sum[e >> 1][g & 3] += p;
      }
    l_lo = l_lo * alpha.x + ((sum[0][0] + sum[0][1]) + (sum[0][2] + sum[0][3]));
    l_hi = l_hi * alpha.y + ((sum[1][0] + sum[1][1]) + (sum[1][2] + sum[1][3]));
    return alpha;
  }

  __device__ __forceinline__ void rescale(float2 alpha) {
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] *= (i & 2) ? alpha.y : alpha.x;
  }

  // issue O += P V for the V tile at v_s (K = the BN keys, V read
  // MN-major; not committed)
  __device__ __forceinline__ void pv(const uint32_t (&pa)[BN / 16][4], uint32_t v_s) {
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) {
      reg_fence(o[hh]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(o[hh], pa[kk], desc(v_s + hh * S::KV_SUB + kk * 16 * 128));
    }
  }

  __device__ __forceinline__ void fence_o() {
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) reg_fence(o[hh]);
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, int order_q, int order_k,
                     int order_v, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     Strides so, int H, int N, int left, int right, float scale) {
  using S = TmaSmem<D>;
  constexpr int STAGES = S::STAGES;
  constexpr bool OVERLAP = D == 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t q_bar = base + S::BAR, full = q_bar + 8, empty = full + 8 * STAGES;

  const int n_blocks = (N + BM - 1) / BM;
  const int q0 = (n_blocks - 1 - blockIdx.x) * BM;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  // the key tiles that hold a key of the band [q0 - left, q0 + 127 + right]
  const int kt_lo = left >= 0 ? max(q0 - left, 0) / BN : 0;
  const int kt_hi = right >= 0 ? min(q0 + BM - 1 + right, N - 1) / BN : (N - 1) / BN;
  const int n_it = kt_hi - kt_lo + 1;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      // the second warpgroup's rows may all lie past N: it computes nothing
      const int q_tiles = q0 + QROWS < N ? 2 : 1;
      mbar_expect_tx(q_bar, q_tiles * S::Q_TILE);
      for (int wg = 0; wg < q_tiles; ++wg)
#pragma unroll
        for (int hh = 0; hh < D / 64; ++hh)
          load_rows(base + S::Q + wg * S::Q_TILE + hh * S::Q_SUB, &map_q, q_bar, order_q,
                    hh * 64, q0 + wg * QROWS, h, b);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * st, (it / STAGES - 1) & 1);
        const uint32_t bar = full + 8 * st;
        const int k0 = (kt_lo + it) * BN;
        mbar_expect_tx(bar, 2 * S::KV_TILE);
#pragma unroll
        for (int hh = 0; hh < D / 64; ++hh) {
          load_rows(base + S::K + st * S::KV_TILE + hh * S::KV_SUB, &map_k, bar, order_k,
                    hh * 64, k0, h, b);
          load_rows(base + S::V + st * S::KV_TILE + hh * S::KV_SUB, &map_v, bar, order_v,
                    hh * 64, k0, h, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  Rows<D> R;
  R.q_s = base + S::Q + wg * S::Q_TILE;
  R.r0 = q0 + wg * QROWS;                        // the warpgroup's first row
  R.r_lo = R.r0 + warp * 16 + (lane >> 2);       // accumulator rows r_lo, r_lo + 8
  R.c_lane = 2 * (lane & 3);                     // columns 8 g + c_lane + {0, 1}
  R.N = N, R.left = left, R.right = right, R.sl2 = scale * LOG2E;
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) R.o[hh][i] = 0.f;
  auto k_tile = [&](int it) { return base + S::K + (it % STAGES) * S::KV_TILE; };
  auto v_tile = [&](int it) { return base + S::V + (it % STAGES) * S::KV_TILE; };
  auto wait_full = [&](int it) { mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1); };
  auto release = [&](int it) {  // this warp is done with the stage of tile it
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % STAGES));
  };
  if (R.r0 >= N) {  // no row of this warpgroup lies inside N
    for (int it = 0; it < n_it; ++it) {
      wait_full(it);
      release(it);
    }
    return;
  }
  mbar_wait(q_bar, 0);

  if constexpr (!OVERLAP) {
    for (int it = 0; it < n_it; ++it) {
      const int k0 = (kt_lo + it) * BN;
      wait_full(it);
      // a tile none of the warpgroup's rows sees under the band is skipped
      const bool sees = (right < 0 || k0 <= R.r0 + QROWS - 1 + right) &&
                        (left < 0 || k0 + BN - 1 >= R.r0 - left);
      if (sees) {
        float s[BN / 2];
        wg_fence();
        R.scores(s, k_tile(it));
        wg_commit();
        wg_wait<0>();
        reg_fence(s);
        const float2 alpha = R.softmax(s, k0);
        uint32_t pa[BN / 16][4];
        to_a_frags(s, pa);
        R.rescale(alpha);
        wg_fence();
        R.pv(pa, v_tile(it));
        wg_commit();
        wg_wait<0>();
        R.fence_o();
      }
      release(it);
    }
  } else {
    // tile 0: scores and softmax; then per tile: the scores of tile it and
    // the PV product of tile it - 1 in flight together, the exponentials of
    // tile it under the PV product, O rescaled once that product is done
    float s[BN / 2];
    uint32_t pa[BN / 16][4];
    wait_full(0);
    wg_fence();
    R.scores(s, k_tile(0));
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    R.softmax(s, kt_lo * BN);  // O is zero: no rescale
    to_a_frags(s, pa);
    for (int it = 1; it < n_it; ++it) {
      wait_full(it);
      wg_fence();
      R.scores(s, k_tile(it));
      wg_commit();
      R.pv(pa, v_tile(it - 1));
      wg_commit();
      wg_wait<1>();  // the scores have landed; the PV product may still run
      reg_fence(s);
      const float2 alpha = R.softmax(s, (kt_lo + it) * BN);
      wg_wait<0>();
      R.fence_o();
      release(it - 1);
      R.rescale(alpha);
      to_a_frags(s, pa);
    }
    wg_fence();
    R.pv(pa, v_tile(n_it - 1));
    wg_commit();
    wg_wait<0>();
    R.fence_o();
    release(n_it - 1);
  }

  // the row sums over the quad; l clamped as in the TPU kernel (a
  // zero-filled row past N may be empty)
  float l_lo = R.l_lo, l_hi = R.l_hi;
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const float ln2 = 0.6931471805599453f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = R.r_lo + 8 * half;
    if (row >= N) continue;
    const float inv = half ? inv_hi : inv_lo;
    __nv_bfloat16* dst = out + b * so.b + h * so.h + row * so.n + R.c_lane;
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
      for (int g = 0; g < 8; ++g)
        *reinterpret_cast<uint32_t*>(dst + hh * 64 + 8 * g) =
            pack_bf16(R.o[hh][4 * g + 2 * half] * inv, R.o[hh][4 * g + 2 * half + 1] * inv);
    if ((lane & 3) == 0) {
      const float m = half ? R.m_hi : R.m_lo, l = half ? l_hi : l_lo;
      lse[(size_t)bh * N + row] = m * ln2 + logf(fmaxf(l, 1e-30f));
    }
  }
}

// ============================================================================
// rotary pass
// ============================================================================

// One block per (batch, row): the 2 H D / 2 column pairs of the row's q and
// k heads, rotated into contiguous [B, N, H, D] buffers qr, kr.
__global__ void __launch_bounds__(256)
flash_rope_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  Strides sq, Strides sk, __nv_bfloat16* __restrict__ qr,
                  __nv_bfloat16* __restrict__ kr, int H, int N, int D,
                  const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                  int rot_dim) {
  const int b = blockIdx.x / N, n = blockIdx.x % N;
  const int pairs = H * D / 2, half = rot_dim / 2;
  const float* cr = cos_t + (size_t)n * rot_dim;
  const float* sr = sin_t + (size_t)n * rot_dim;
  for (int j = threadIdx.x; j < 2 * pairs; j += blockDim.x) {
    const bool is_k = j >= pairs;
    const int jj = is_k ? j - pairs : j, h = jj / (D / 2), c = 2 * (jj % (D / 2));
    const Strides s = is_k ? sk : sq;
    const __nv_bfloat16* x = (is_k ? k : q) + b * s.b + n * s.n + h * s.h;
    const float2 xc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + c));
    float y[2] = {xc.x, xc.y};
    if (c < rot_dim) {  // c even and rot_dim even: both columns rotate
      const float2 cs = *reinterpret_cast<const float2*>(cr + c);
      const float2 sn = *reinterpret_cast<const float2*>(sr + c);
      const float cv[2] = {cs.x, cs.y}, sv[2] = {sn.x, sn.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = c + e;
        const float partner = __bfloat162float(x[cc < half ? cc + half : cc - half]);
        const float a = __fmul_rn(y[e], cv[e]), r = __fmul_rn(partner, sv[e]);
        y[e] = cc < half ? __fadd_rn(a, -r) : __fadd_rn(a, r);
      }
    }
    __nv_bfloat16* dst = (is_k ? kr : qr) + (((size_t)b * N + n) * H + h) * D + c;
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y[0], y[1]);
  }
}

// ============================================================================
// host
// ============================================================================

// One [B, H, N, D] bf16 operand, read through its element strides, as a 4-D
// map (D, then the row, head and batch axes ordered by stride), box 64
// columns x `rows` rows, 128-byte swizzle; rows past N read as zeros.
// `order` gets the positions of the row, head and batch axes.
bool map_operand(CUtensorMap* map, int* order, const void* ptr, Strides s, int B, int H, int N,
                 int D, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  struct Axis {
    long long stride;
    int size, box, id;
  } ax[3] = {{s.n, N, rows, 0}, {s.h, H, 1, 1}, {s.b, B, 1, 2}};
  for (int i = 1; i < 3; ++i)  // insertion sort by stride
    for (int j = i; j > 0 && ax[j].stride < ax[j - 1].stride; --j) {
      const Axis t = ax[j];
      ax[j] = ax[j - 1];
      ax[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D}, strides[3];
  cuuint32_t box[4] = {64}, unit[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)ax[i].size;
    strides[i] = (cuuint64_t)ax[i].stride * 2;
    box[i + 1] = (cuuint32_t)ax[i].box;
    pos[ax[i].id] = i + 1;
  }
  *order = pos[0] | pos[1] << 2 | pos[2] << 4;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const Strides* s,
           int B, int H, int N, int left, int right, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int oq, ok, ov;
  if (!(map_operand(&mq, &oq, q, s[0], B, H, N, D, QROWS) &&
        map_operand(&mk, &ok, k, s[1], B, H, N, D, BN) &&
        map_operand(&mv, &ov, v, s[2], B, H, N, D, BN)))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = TmaSmem<D>::BYTES;
  static bool ready = false;  // the shared-memory limit, set once per instantiation
  if (!ready) {
    const int err = set_smem(flash_fwd_tma_kernel<D>, smem);
    if (err) return err;
    ready = true;
  }
  dim3 grid((N + BM - 1) / BM, B * H);
  flash_fwd_tma_kernel<D><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, oq, ok, ov, (__nv_bfloat16*)out, (float*)lse, s[3], H, N, left, right, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: bf16 [B, H, N, D] with element strides (batch, head, row)
// given per operand in `strides` (12 values: q, k, v, out; the last axis is
// contiguous, every row and base on 16 bytes); lse [B, H, N] f32.
// left / right: the window bounds, -1 for an unbounded side (causal:
// right = 0). D is 64 or 128; anything else returns cudaErrorInvalidValue.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         const long long* strides, int B, int H, int N, int D, int left,
                         int right, float scale, void* stream) {
  Strides s[4];
  for (int i = 0; i < 4; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64>(q, k, v, out, lse, s, B, H, N, left, right, scale, st);
  if (D == 128) return launch<128>(q, k, v, out, lse, s, B, H, N, left, right, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The rotary pass: q, k bf16 [B, N, H, D] through element strides (batch,
// head, row) (6 values: q, k), rotated by the f32 tables cos_t, sin_t
// [N, rot_dim] (row-major, rot_dim even in [2, D]) into the contiguous
// [B, N, H, D] buffers qr, kr.
extern "C" int flash_fwd_rope(const void* q, const void* k, void* qr, void* kr,
                              const long long* strides, int B, int H, int N, int D,
                              const void* cos_t, const void* sin_t, int rot_dim, void* stream) {
  if (rot_dim <= 0 || rot_dim > D || rot_dim % 2 || !cos_t || !sin_t)
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]};
  flash_rope_kernel<<<B * N, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, sq, sk, (__nv_bfloat16*)qr,
      (__nv_bfloat16*)kr, H, N, D, (const float*)cos_t, (const float*)sin_t, rot_dim);
  return (int)cudaGetLastError();
}
