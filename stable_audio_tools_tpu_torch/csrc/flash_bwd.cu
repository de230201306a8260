// Flash-attention backward from the saved logsumexp, bf16 in, f32
// accumulation, for Hopper (sm_90a); head dim 64 or 128, unmasked or under a
// causal / sliding-window band.
//
// Replaces the TPU kernels of stable_audio_tools_tpu/ops/kernels/
// flash_attention.py reached from the VJPs of `flash_attention`,
// `flash_attention_prefix`, `flash_attention_nhd` and
// `flash_attention_fused_qkv` (all through `_flash_backward`):
//   - `_bwd_fused_kernel` (single pass: dK/dV per key block, dQ revisited
//     across a sequential grid) -> flash_bwd_dkv_kernel<D, true>: the same
//     single pass, with dQ added into an f32 buffer by 16-byte vector
//     reductions (`red.global.add.v4.f32`), because a GPU runs the key
//     blocks in parallel and in no order;
//   - `_bwd_dkv_kernel` -> flash_bwd_dkv_kernel<D, false>;
//   - `_bwd_dq_kernel`  -> flash_bwd_dq_kernel<D> (with the dK/dV kernel, the
//     two-pass route: no atomics, deterministic, two more N^2 D products).
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
// (the wrapper folds it in), both -1 is the unmasked function. Band
// skipping, as the TPU kernels' `_k_visible_range` (dK/dV: the query tiles
// that see a key tile, [key0 - right, key0 + 63 + left]) and
// `_q_visible_range` (dQ: the key tiles a query tile sees,
// [q0 - left, q0 + 63 + right]); tile pairs wholly inside the band and
// inside N skip the per-element mask.
//
// Layout: q, k, v, dO, dK, dV, dQ are [B*H, N, D] contiguous bf16; lse and
// dsum [B*H, N] f32; every base on 16 bytes. N need not be a multiple of 64.
//
// Bound on the H100: 5 products of 2 N^2 D per b*h over the visible pairs,
// against 9 N D bf16 + 2 N f32 bytes per b*h. At SA-2.0's training shape
// ([4,24,6145,64], unmasked) that is 2.32 TFLOP against 0.07 GB: the tensor
// cores bound it, 2.35 ms at 989 TFLOP/s; at SA-Open's ([4,24,1025,64])
// 0.065 ms, also operations. A window cuts the products to the band, and the
// long windowed shapes become memory-bound.
//
// What held the earlier WMMA kernels back (54.1 ms at 6145 rows, 4.3% of
// the bound), and what this design does about each:
// - Tensor cores through WMMA with a shared-memory round trip: every 16x64
//   tile of S^T and dP^T went to a per-warp f32 buffer, came back one float
//   a lane (4-way bank conflicts), went out again as bf16 P^T and dS^T and
//   came back as fragments. Here every product is a warpgroup
//   `wgmma.mma_async` m64n64k16 (bf16 in, f32 accumulate): S^T = K Q^T and
//   dP^T = V dO^T (dQ kernel: S = Q K^T, dP = dO V^T) read both operands
//   from shared memory; P^T and dS^T are formed in the accumulator
//   registers (exp2 with the scale and log2 e folded in), rounded to bf16
//   there and fed as the register A operand of dV += P^T dO and
//   dK += dS^T Q (dQ += dS K), whose B is the same shared-memory tile read
//   MN-major: the m64nN accumulator layout is the A fragment layout of the
//   next m64nNk16. No f32 score tile touches shared memory.
// - Synchronous loads: each tile came in by 16-byte loads after the previous
//   one was done with. Here one thread issues TMA copies into a ring of two
//   stages, each guarded by an mbarrier: the next (Q, dO, lse, dsum) tile
//   (dK/dV) or (K, V) tile (dQ) lands while the current one is computed on;
//   the resident tiles (K, V or Q, dO) come in once. The maps are 3-D over
//   [B*H, N, D], so the ragged tail of a head is zero-filled, not read from
//   the next head, with boxes of 64 rows x 64 columns in the 128-byte
//   swizzle that the wgmma descriptors read. lse and dsum come by 1-D maps
//   over [B*H*N] f32 (their rows are not 16-byte strided): a 1-D box must
//   start on 16 bytes, so a tile's 64 entries come in a box of 68 from the
//   start rounded down to 4 entries (the entries past a head's N that a
//   tail tile picks up belong to masked queries). The dQ kernel reads the
//   lse and dsum of its threads' two rows once, by plain loads.
// - Occupancy: 64-row tiles, one warpgroup a block. In experiment builds on
//   the H100, two warpgroups sharing each streamed stage (128-row blocks,
//   half the L2 re-reads) were slower at 6145 and 1025 rows, and holding the
//   D = 64 dK/dV kernel to 168 registers so that three blocks share an SM
//   was faster than two blocks without spills, though ptxas then serialises
//   its wgmmas (chip_smoke.py prints the registers and spills).
// - The fused route's dQ: dS^T also goes to shared memory in the swizzled
//   layout, the tile's dQ rows are one wgmma per 64 columns with A read
//   MN-major from there, and they are added into dq_acc by 16-byte vector
//   reductions after a lane-pair exchange, not by scalar atomicAdd. Its
//   reductions (16 KB a tile pair) make it slower than the two-pass route at
//   6145 rows (PERF.md).
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so no -lcuda) and passed by value
// as __grid_constant__ kernel parameters, one per operand. The mbarrier, TMA
// and wgmma helpers are shared with flash_fwd.cu (hopper.cuh). Not used yet:
// warp specialisation, a deeper ring, persistent blocks, and overlap of one
// iteration's last product with the next one's first.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int TILE = 64;            // rows of a tile and of a warpgroup's slice
constexpr int WG_THREADS = 128;     // one warpgroup
constexpr int SUB_BYTES = 64 * 128; // one swizzled [64 rows][64 bf16] sub-tile
// lse / dsum boxes: a 1-D TMA box must start on 16 bytes, so a tile's 64
// entries come in a box of 68 from the start rounded down to 4 entries
constexpr int ROW_BOX = TILE + 4;
constexpr int ROW_STAGE = 384;      // bytes of one lse or dsum stage (128-aligned)

// blocks an SM should hold: at D = 64 the kernels are held to 168 registers
// a thread so that three fit (the dK/dV kernel was faster so than two blocks
// without spills); at D = 128 one warpgroup's dK and dV fill the registers
template <int D>
__host__ __device__ constexpr int min_blocks() { return D == 64 ? 3 : 1; }

// Byte offset of k-step kk (16 columns) of a [64][D] tile read K-major: the
// tile is D / 64 swizzled sub-tiles of 64 columns, 8 KB apart.
__device__ __forceinline__ uint32_t kmajor(int kk) {
  return (uint32_t)((kk >> 2) * SUB_BYTES + (kk & 3) * 32);
}

// Byte offset of k-step kk (16 rows) of 64-column sub-tile h read MN-major.
__device__ __forceinline__ uint32_t mnmajor(int h, int kk) {
  return (uint32_t)(h * SUB_BYTES + kk * 16 * 128);
}

// whether the per-element mask is needed for the tile pair
// [q0, q0+63] x [k0, k0+63]: part of it outside the band or past N
__device__ __forceinline__ bool pair_masked(int q0, int k0, int N, int left, int right) {
  return q0 + TILE > N || k0 + TILE > N || (left >= 0 && k0 < q0 + TILE - 1 - left) ||
         (right >= 0 && k0 + TILE - 1 > q0 + right);
}

// the 64-row tiles of [r0 - lo_off, r0 + 63 + hi_off] clipped to [0, N);
// an offset -1 leaves that side open
__device__ __forceinline__ void tile_range(int r0, int lo_off, int hi_off, int N, int& lo,
                                           int& hi) {
  lo = lo_off >= 0 ? max(r0 - lo_off, 0) / TILE : 0;
  hi = hi_off >= 0 ? min(r0 + TILE - 1 + hi_off, N - 1) / TILE : (N - 1) / TILE;
}

// Store the warpgroup's [64][64] f32 accumulator as bf16 into columns
// col0..col0+63 of rows row0.. of out ([*, D]), rows >= N skipped.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float (&x)[32], int row0,
                                          int col0, int N, int warp, int lane) {
  const int r = row0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int c = col0 + 8 * g + 2 * (lane & 3);
    if (r < N)
      *reinterpret_cast<uint32_t*>(out + (size_t)r * D + c) = pack_bf16(x[4 * g], x[4 * g + 1]);
    if (r + 8 < N)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8) * D + c) =
          pack_bf16(x[4 * g + 2], x[4 * g + 3]);
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

// Shared memory of the dK/dV kernel (byte offsets from a 1024-aligned base):
// K and V of the block's keys, two stages of Q and dO, the fused route's
// dS^T, two stages of lse and dsum, the barriers.
template <int D, bool ATOMIC_DQ>
struct DkvSmem {
  static constexpr int TILE_B = D / 64 * SUB_BYTES;  // one [64][D] bf16 tile
  static constexpr int K = 0;
  static constexpr int V = K + TILE_B;
  static constexpr int Q = V + TILE_B;
  static constexpr int DO = Q + 2 * TILE_B;
  static constexpr int DST = DO + 2 * TILE_B;
  static constexpr int LSE = DST + (ATOMIC_DQ ? SUB_BYTES : 0);
  static constexpr int DSUM = LSE + 2 * ROW_STAGE;
  static constexpr int BAR = DSUM + 2 * ROW_STAGE;  // full[0], full[1], resident
  static constexpr int BYTES = BAR + 3 * 8 + 1024;  // + the base's alignment
};

// ... of the dQ kernel: Q and dO of the block's queries, two stages of K and V
template <int D>
struct DqSmem {
  static constexpr int TILE_B = D / 64 * SUB_BYTES;
  static constexpr int Q = 0;
  static constexpr int DO = Q + TILE_B;
  static constexpr int K = DO + TILE_B;
  static constexpr int V = K + 2 * TILE_B;
  static constexpr int BAR = V + 2 * TILE_B;
  static constexpr int BYTES = BAR + 3 * 8 + 1024;
};

// Issue the TMA copies of one [64][D] tile (D / 64 boxes) at rows row0 of
// head bh.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int bh) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h) tma_3d(dst + h * SUB_BYTES, map, bar, h * 64, row0, bh);
}

__device__ __forceinline__ void init_barriers(uint32_t bar) {
  for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// dK, dV for 64 keys of one b*h (and, ATOMIC_DQ, dQ added into dq_acc).
template <int D, bool ATOMIC_DQ>
__global__ void __launch_bounds__(WG_THREADS, min_blocks<D>())
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_lse,
                     const __grid_constant__ CUtensorMap map_dsum,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ dq_acc, int N, float scale, int left, int right) {
  using S = DkvSmem<D, ATOMIC_DQ>;
  constexpr int DS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const float* lse_s = reinterpret_cast<const float*>(smem + S::LSE);
  const float* dsum_s = reinterpret_cast<const float*>(smem + S::DSUM);
  const uint32_t bar = base + S::BAR;  // full[0], full[1] at +0, +8; resident at +16

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * TILE;
  int qt_lo, qt_hi;  // the query tiles that see a key of this tile
  tile_range(key0, right, left, N, qt_lo, qt_hi);
  const int n_it = qt_hi - qt_lo + 1;
  constexpr uint32_t STAGE_TX = 2 * S::TILE_B + 2 * ROW_BOX * 4;

  const CUtensorMap *mq = &map_q, *mdo = &map_do, *mlse = &map_lse, *mdsum = &map_dsum;
  auto issue = [=](int stage, int qt) {  // Q, dO, lse, dsum of query tile qt
    const uint32_t b = bar + 8 * stage;
    mbar_expect_tx(b, STAGE_TX);
    load_tile<D>(base + S::Q + stage * S::TILE_B, mq, b, qt * TILE, bh);
    load_tile<D>(base + S::DO + stage * S::TILE_B, mdo, b, qt * TILE, bh);
    const int first = (bh * N + qt * TILE) & ~3;
    tma_1d(base + S::LSE + stage * ROW_STAGE, mlse, b, first);
    tma_1d(base + S::DSUM + stage * ROW_STAGE, mdsum, b, first);
  };

  if (tid == 0) init_barriers(bar);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar + 16, 2 * S::TILE_B);
    load_tile<D>(base + S::K, &map_k, bar + 16, key0, bh);
    load_tile<D>(base + S::V, &map_v, bar + 16, key0, bh);
    issue(0, qt_lo);
  }

  const uint32_t k_s = base + S::K, v_s = base + S::V, dst_s = base + S::DST;
  const int r_lo = warp * 16 + (lane >> 2);  // accumulator rows r_lo, r_lo + 8
  const int c_lane = 2 * (lane & 3);         // accumulator columns 8 g + c_lane + {0, 1}
  const float sl2 = scale * LOG2E;
  float dk_acc[DS][32], dv_acc[DS][32];
#pragma unroll
  for (int h = 0; h < DS; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[h][i] = dv_acc[h][i] = 0.f;
  mbar_wait(bar + 16, 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, qt = qt_lo + it, q0 = qt * TILE;
    if (tid == 0 && it + 1 < n_it) issue(st ^ 1, qt + 1);  // its stage was freed last iteration
    mbar_wait(bar + 8 * st, (it >> 1) & 1);
    const uint32_t q_s = base + S::Q + st * S::TILE_B, do_s = base + S::DO + st * S::TILE_B;
    const int rem = (bh * N + q0) & 3;  // the tile's first entry in its lse / dsum box
    const float* lse_t = lse_s + st * ROW_STAGE / 4 + rem;
    const float* dsum_t = dsum_s + st * ROW_STAGE / 4 + rem;
    const bool masked = pair_masked(q0, key0, N, left, right);
    float s[32], dp[32];
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, K = D
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(s, desc(k_s + kmajor(kk)), desc(q_s + kmajor(kk)), kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(dp, desc(v_s + kmajor(kk)), desc(do_s + kmajor(kk)), kk);
    wg_commit();
    wg_wait<1>();
    reg_fence(s);
    // P^T = exp2(S^T s log2 e - lse[query] log2 e), masked, in registers
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int c = 8 * g + c_lane;
      const float l0 = lse_t[c] * LOG2E, l1 = lse_t[c + 1] * LOG2E;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(s[4 * g + e], sl2, -((e & 1) ? l1 : l0)));
        if (masked) {
          const int key = key0 + r_lo + 8 * (e >> 1), qry = q0 + c + (e & 1);
          if (!(key < N && qry < N && visible(qry, key, left, right))) p = 0.f;
        }
        s[4 * g + e] = p;
      }
    }
    uint32_t pa[4][4];
    to_a_frags(s, pa);
    // dV += P^T dO: K = the 64 queries, dO read MN-major
    wg_fence();
#pragma unroll
    for (int h = 0; h < DS; ++h) {
      reg_fence(dv_acc[h]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv_acc[h], pa[kk], desc(do_s + mnmajor(h, kk)));
    }
    wg_commit();
    wg_wait<1>();
    reg_fence(dp);
    // dS^T = P^T (dP^T - dsum[query]) s
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float d0 = dsum_t[8 * g + c_lane], d1 = dsum_t[8 * g + c_lane + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * g + e] = s[4 * g + e] * (dp[4 * g + e] - ((e & 1) ? d1 : d0)) * scale;
    }
    uint32_t da[4][4];
    to_a_frags(dp, da);
    // dK += dS^T Q
    wg_fence();
#pragma unroll
    for (int h = 0; h < DS; ++h) {
      reg_fence(dk_acc[h]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk_acc[h], da[kk], desc(q_s + mnmajor(h, kk)));
    }
    wg_commit();
    if constexpr (ATOMIC_DQ) {
      // dS^T [64 keys][64 queries] into shared memory, 128-byte swizzled
      unsigned char* dst = smem + S::DST;
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r_lo + 8 * half;
          *reinterpret_cast<uint32_t*>(dst + r * 128 + ((g ^ (r & 7)) << 4) + c_lane * 2) =
              da[g >> 1][2 * (g & 1) + half];
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      // dQ rows of the tile += dS K, per 64 columns: A = dS read transposed
      // from dS^T, B = K read MN-major
#pragma unroll
      for (int h = 0; h < DS; ++h) {
        float dq[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(dq, desc(dst_s + kk * 16 * 128), desc(k_s + mnmajor(h, kk)), kk);
        wg_commit();
        wg_wait<0>();
        reg_fence(dq);
        // lane pairs exchange halves so that each lane adds 4 adjacent
        // columns of one row: even lanes row r_lo, odd lanes row r_lo + 8
        const bool odd = lane & 1;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const float x0 = __shfl_xor_sync(0xffffffffu, odd ? dq[4 * g] : dq[4 * g + 2], 1);
          const float x1 = __shfl_xor_sync(0xffffffffu, odd ? dq[4 * g + 1] : dq[4 * g + 3], 1);
          const int row = q0 + r_lo + (odd ? 8 : 0);
          const int col = h * 64 + 8 * g + c_lane - (odd ? 2 : 0);
          const float4 val = odd ? make_float4(x0, x1, dq[4 * g + 2], dq[4 * g + 3])
                                 : make_float4(dq[4 * g], dq[4 * g + 1], x0, x1);
          if (row < N)
            atomicAdd(reinterpret_cast<float4*>(dq_acc + ((size_t)bh * N + row) * D + col), val);
        }
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int h = 0; h < DS; ++h) {
      reg_fence(dk_acc[h]);
      reg_fence(dv_acc[h]);
    }
    __syncthreads();  // stage st (and dS^T) free for the copy issued next iteration
  }

  const size_t off = (size_t)bh * N * D;
#pragma unroll
  for (int h = 0; h < DS; ++h) {
    store_acc<D>(dk + off, dk_acc[h], key0, h * 64, N, warp, lane);
    store_acc<D>(dv + off, dv_acc[h], key0, h * 64, N, warp, lane);
  }
}

// dQ for 64 queries of one b*h: the second pass over the key tiles.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, min_blocks<D>())
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, int N, float scale, int left, int right) {
  using S = DqSmem<D>;
  constexpr int DS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t bar = base + S::BAR;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  int kt_lo, kt_hi;  // the key tiles this query tile sees
  tile_range(q0, left, right, N, kt_lo, kt_hi);
  const int n_it = kt_hi - kt_lo + 1;
  constexpr uint32_t STAGE_TX = 2 * S::TILE_B;

  const CUtensorMap *mk = &map_k, *mv = &map_v;
  auto issue = [=](int stage, int kt) {  // K, V of key tile kt
    const uint32_t b = bar + 8 * stage;
    mbar_expect_tx(b, STAGE_TX);
    load_tile<D>(base + S::K + stage * S::TILE_B, mk, b, kt * TILE, bh);
    load_tile<D>(base + S::V + stage * S::TILE_B, mv, b, kt * TILE, bh);
  };

  if (tid == 0) init_barriers(bar);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar + 16, 2 * S::TILE_B);
    load_tile<D>(base + S::Q, &map_q, bar + 16, q0, bh);
    load_tile<D>(base + S::DO, &map_do, bar + 16, q0, bh);
    issue(0, kt_lo);
  }

  const uint32_t q_s = base + S::Q, do_s = base + S::DO;
  const int r_lo = warp * 16 + (lane >> 2);
  const int c_lane = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  // lse (times log2 e) and dsum of this thread's two query rows
  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + 8 * half;
    lse_r[half] = row < N ? lse[(size_t)bh * N + row] * LOG2E : 0.f;
    dsum_r[half] = row < N ? dsum[(size_t)bh * N + row] : 0.f;
  }
  float dq_acc[DS][32];
#pragma unroll
  for (int h = 0; h < DS; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[h][i] = 0.f;
  mbar_wait(bar + 16, 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, kt = kt_lo + it, k0 = kt * TILE;
    if (tid == 0 && it + 1 < n_it) issue(st ^ 1, kt + 1);
    mbar_wait(bar + 8 * st, (it >> 1) & 1);
    const uint32_t k_s = base + S::K + st * S::TILE_B, v_s = base + S::V + st * S::TILE_B;
    const bool masked = pair_masked(q0, k0, N, left, right);
    float s[32], dp[32];
    // S = Q K^T and dP = dO V^T: 64 queries x 64 keys, K = D
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(s, desc(q_s + kmajor(kk)), desc(k_s + kmajor(kk)), kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(dp, desc(do_s + kmajor(kk)), desc(v_s + kmajor(kk)), kk);
    wg_commit();
    wg_wait<1>();
    reg_fence(s);
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(s[4 * g + e], sl2, -lse_r[e >> 1]));
        if (masked) {
          const int qry = q0 + r_lo + 8 * (e >> 1), key = k0 + 8 * g + c_lane + (e & 1);
          if (!(key < N && qry < N && visible(qry, key, left, right))) p = 0.f;
        }
        s[4 * g + e] = p;
      }
    wg_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dsum_r[(i >> 1) & 1]) * scale;
    uint32_t da[4][4];
    to_a_frags(dp, da);
    // dQ += dS K: K = the 64 keys, K read MN-major
    wg_fence();
#pragma unroll
    for (int h = 0; h < DS; ++h) {
      reg_fence(dq_acc[h]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(dq_acc[h], da[kk], desc(k_s + mnmajor(h, kk)));
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int h = 0; h < DS; ++h) reg_fence(dq_acc[h]);
    __syncthreads();  // stage st free for the copy issued next iteration
  }

#pragma unroll
  for (int h = 0; h < DS; ++h)
    store_acc<D>(dq + (size_t)bh * N * D, dq_acc[h], q0, h * 64, N, warp, lane);
}

// ---- host ------------------------------------------------------------------

// [BH, N, D] bf16 as a 3-D map, box 64 x 64 x 1, 128-byte swizzle; rows past
// N (and past the last head) read as zeros
bool map_rows(CUtensorMap* map, const void* ptr, int BH, int N, int D) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2};
  const cuuint32_t box[3] = {64, TILE, 1}, unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// [BH * N] f32 as a 1-D map, box ROW_BOX; entries past the end read as zeros
bool map_flat(CUtensorMap* map, const void* ptr, int count) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)count};
  const cuuint64_t strides[1] = {4};  // not read for rank 1
  const cuuint32_t box[1] = {ROW_BOX}, unit[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
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
  CUtensorMap mq, mk, mv, mdo, mlse, mdsum;
  if (!(map_rows(&mq, q, BH, N, D) && map_rows(&mk, k, BH, N, D) &&
        map_rows(&mv, v, BH, N, D) && map_rows(&mdo, dout, BH, N, D) &&
        map_flat(&mlse, lse, BH * N) && map_flat(&mdsum, dsum, BH * N)))
    return (int)cudaErrorInvalidValue;
  const int smem = DkvSmem<D, ATOMIC>::BYTES;
  const int err = set_smem(flash_bwd_dkv_kernel<D, ATOMIC>, smem);
  if (err) return err;
  dim3 grid((N + TILE - 1) / TILE, BH);
  flash_bwd_dkv_kernel<D, ATOMIC><<<grid, WG_THREADS, smem, stream>>>(
      mq, mk, mv, mdo, mlse, mdsum, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (float*)dq_acc, N,
      scale, left, right);
  return (int)cudaGetLastError();
}

template <int D>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* dsum, void* dq, int BH, int N, float scale, int left, int right,
              cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!(map_rows(&mq, q, BH, N, D) && map_rows(&mk, k, BH, N, D) &&
        map_rows(&mv, v, BH, N, D) && map_rows(&mdo, dout, BH, N, D)))
    return (int)cudaErrorInvalidValue;
  const int smem = DqSmem<D>::BYTES;
  const int err = set_smem(flash_bwd_dq_kernel<D>, smem);
  if (err) return err;
  dim3 grid((N + TILE - 1) / TILE, BH);
  flash_bwd_dq_kernel<D><<<grid, WG_THREADS, smem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)dsum, (__nv_bfloat16*)dq, N, scale,
      left, right);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry takes the head dim D (64 or 128; anything else returns
// cudaErrorInvalidValue) and, where masked, the band (left, right; -1 = open).
// Every tensor must start on a 16-byte boundary (the tensor maps' rule).

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
