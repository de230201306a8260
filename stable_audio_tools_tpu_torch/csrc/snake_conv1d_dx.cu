// Input gradient of the fused snake-beta -> conv1d, bf16 in and out, f32
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel stable_audio_tools_tpu/ops/kernels/conv1d_snake.py
// `_bwd_dx_kernel` (reached from `_snake_conv1d_bwd` through `_run_bwd_dx`).
// With y = conv1d(snake(x), W) (stride 1, dilation d, zero padding pad_lo):
//
//   ds[b, ci, l] = sum_j sum_co W[co, ci, j] * dy[b, co, l + pad_lo - j*d]
//   dx           = ds * (1 + alpha * binv * sin(2 alpha x))
//   dalpha[ci]  += ds * x * binv * sin(2 alpha x)
//   dbeta[ci]   += -ds * sin^2(alpha x) * binv^2        (binv = 1/(beta+1e-9))
//
// ds is a stride-1 conv of dy with the flipped, transposed weights
// wt[j, ci, co] = W[co, ci, k-1-j] and a left offset off = (k-1)*d - pad_lo
// (JAX :455-456); dy positions outside [0, Lout) read as 0. The snake
// derivative uses exact sincosf in f32 (the JAX package's CPU maths; the TPU
// kernel's polynomial is not ported): CUDA's sincosf rebuilt without the
// branch to its slow path (`sincos_fast`, bit for bit the same for |a x| <
// 105615, checked on the card over every such float), sincosf itself beyond.
//
// Layout: dy [B, Co, Lout], x and dx [B, Ci, L] (channels before time, the
// port's layout); the weights arrive as [k, Ci, Co_pad] (the wrapper permutes
// torch's [Co, Ci, k] once per call and pads Co to a multiple of 64 with
// zeros: one weight-sized copy); the kernel reads tap k-1-j for tap j, so no
// flipped copy is made. dalpha/dbeta partials [B, nblk, Ci] f32, one row per
// (batch, 128 output rows), summed by the wrapper: every element is written
// by exactly one warpgroup, so there are no atomics and the result does not
// depend on the schedule.
//
// Bound on the H100: 2*B*L*Ci*Co*k operations against ~2 bytes per element
// of dy, x and dx: tensor-core bound at the Oobleck path's k = 7 widths; the
// k = 1 convs at C <= 256 are bound by reading dy and x and writing dx.
//
// The design is the forward's (snake_conv1d.cu, rows 12 and 3; the shared
// body in snake_conv.cuh) with dy in the place of x: an implicit GEMM
// D[l, ci] += sum_j window_j[l, co] wt_j[co, ci] whose window is dy laid out
// time-major and K-major without swizzle by seven producer warps (a
// transpose only: no snake), read by `wgmma` at row j*d for tap j, the weight
// slices brought by TMA in the 128-byte swizzle into a ring, two consumer
// warpgroups (`setmaxnreg` 168 / 88), and strips of tiles that carry the
// window's last (k-1)*d rows to the next tile where they fit and dy has more
// than one chunk of 64 channels. The output
// tile is the wrapper's `dx_tile` over Ci: past 64 channels two 64-channel
// warpgroups side by side (128 rows x 128 channels a block), 64 accumulator
// registers a thread where the forward's 128 made the epilogue spill. The
// epilogue takes each channel's eight consecutive rows from the transposed
// stage, with x there loaded before the tile's products (16 bytes a thread
// where L % 8 == 0), applies the snake's derivative, writes dx and reduces the dalpha / dbeta terms over
// the warpgroup's 128 rows (sixteen lanes a channel, by shuffles). Rows past
// L and channels past Ci add nothing.

#include "snake_conv.cuh"

namespace {

struct EpiDx {
  static constexpr bool kSnake = false;
  static constexpr bool kFlip = true;  // tap k-1-j of the weights for tap j
  // x at the eight rows l..l+7 of channel c (bf16, 0 past L or Ci)
  typedef uint4 Held;
  __device__ static __forceinline__ void hold(const Args& a, Held& h, int c, int l, int b) {
    h = make_uint4(0u, 0u, 0u, 0u);
    if (c >= a.Co || l >= a.Lout) return;
    const size_t idx = ((size_t)b * a.Co + c) * a.Lout + l;
    if ((a.Lout & 7) == 0 && (reinterpret_cast<uintptr_t>(a.xs) & 15) == 0) {
      h = __ldg(reinterpret_cast<const uint4*>(a.xs + idx));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(a.xs) + idx;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (l + e < a.Lout) w[e / 2] |= (uint32_t)__ldg(xs + e) << (16 * (e & 1));
      h = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __device__ static __forceinline__ void piece(const Args& a, const float (&v)[8], int c, int l,
                                               int l0, int b, int lane, const Held& h) {
    float sa = 0.f, sb = 0.f;
    if (c < a.Co && l < a.Lout) {
      const float al = a.alpha[c], binv = 1.f / (a.beta[c] + 1e-9f);
      const size_t idx = ((size_t)b * a.Co + c) * a.Lout + l;
      const bool vec = (a.Lout & 7) == 0;
      float xv[8];
      const uint32_t hw[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hw[e]));
        xv[2 * e] = f.x;
        xv[2 * e + 1] = f.y;
      }
      // sincosf without its slow path, which only |a x| >= 105615 takes
      float t[8], sn[8], cs[8];
      bool slow = false;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        t[e] = al * xv[e];
        sincos_fast(t[e], &sn[e], &cs[e]);
        slow |= fabsf(t[e]) >= 105615.f;
      }
      if (slow)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (fabsf(t[e]) >= 105615.f) sincosf(t[e], &sn[e], &cs[e]);
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float s = sn[e];
        const float ds2 = 2.f * s * cs[e];  // sin(2 a x)
        o[e] = v[e] * (1.f + al * binv * ds2);
        if (l + e < a.Lout) {
          sa += v[e] * xv[e] * binv * ds2;
          sb -= v[e] * s * s * binv * binv;
        }
      }
      if (vec) {
        *reinterpret_cast<uint4*>(a.y + idx) =
            make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                       pack_bf16(o[6], o[7]));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (l + e < a.Lout) a.y[idx + e] = __float2bfloat16(o[e]);
      }
    }
    // the channel's 128 rows lie on sixteen neighbouring lanes
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, m);
      sb += __shfl_xor_sync(0xffffffffu, sb, m);
    }
    if ((lane & 15) == 0 && c < a.Co) {
      const size_t p = ((size_t)b * a.nblk + l0 / 128) * a.Co + c;
      a.pa[p] = sa;
      a.pb[p] = sb;
    }
  }
};

template <int NT, bool SPLIT_N>
__global__ void __launch_bounds__(THREADS, 1)
snake_conv1d_dx_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ Args a) {
  body<NT, SPLIT_N, EpiDx>(&wmap, a);
}

template <int NT, bool SPLIT_N>
int launch_t(const Plan& p, const Args& a, const void* wp, int B, int co_pad,
             cudaStream_t stream) {
  static bool ready = false;
  return launch_body<NT, SPLIT_N>(snake_conv1d_dx_kernel<NT, SPLIT_N>, &ready, p, a, wp, B,
                                  co_pad, stream);
}

}  // namespace

// dx, dalpha / dbeta partials of snake_conv1d for dy. wp: bf16 [k, Ci, Co_pad]
// (torch's [Co, Ci, k] permuted, not flipped; Co_pad = Co rounded up to 64,
// zero-filled); (nt, split) the wrapper's `dx_tile` for Ci (8 or 64, split
// only at 64); pa / pb f32 [B, nblk,
// Ci] with nblk = ceil(L / rows) * rows / 128 for the tile's rows (256, or
// 128 where split).
extern "C" int snake_conv1d_dx(const void* dy, const void* wp, const void* x, const void* alpha,
                               const void* beta, void* dx, void* pa, void* pb, int B, int Co,
                               int Ci, int Lout, int L, int k, int d, int pad_lo, int nt,
                               int split, int nblk, void* stream) {
  if ((k - 1) * d > MAX_SPAN || k < 1 || d < 1 || nt == 128) return (int)cudaErrorInvalidValue;
  const int off = (k - 1) * d - pad_lo;
  // the forward's plan with the roles swapped: the window is dy (Co
  // channels, Lout long), the output dx (Ci channels, L long)
  Plan p;
  if (!plan(B, Co, Ci, L, k, d, nt, split, true, &p)) return (int)cudaErrorInvalidValue;
  if (nblk != p.tiles * p.bm / 128) return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)dy, (const float*)alpha, (const float*)beta, nullptr,
               nullptr, (__nv_bfloat16*)dx, (const __nv_bfloat16*)x, (float*)pa, (float*)pb,
               Co, Ci, Lout, L, k, d, off, p.S, p.carry, p.ws, nblk};
  const int co_pad = (Co + CIC - 1) / CIC * CIC;
  cudaStream_t s = (cudaStream_t)stream;
  if (split) return launch_t<64, true>(p, a, wp, B, co_pad, s);
  if (nt == 64) return launch_t<64, false>(p, a, wp, B, co_pad, s);
  return launch_t<8, false>(p, a, wp, B, co_pad, s);
}
