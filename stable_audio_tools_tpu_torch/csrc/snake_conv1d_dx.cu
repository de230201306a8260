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
// wt[j, co, ci] = W[co, ci, k-1-j] and a left offset off = (k-1)*d - pad_lo
// (JAX :455-456); dy positions outside [0, Lout) read as 0. The snake
// derivative uses exact sincosf in f32 (the JAX package's CPU maths; the TPU
// kernel's polynomial is not ported).
//
// Layout: dy [B, Co, Lout], x and dx [B, Ci, L] (channels before time, the
// port's layout); wt [k, Co, Ci] (the wrapper flips and permutes torch's
// [Co, Ci, k] once per call); dalpha/dbeta partials [B, nblk, Ci] f32, one
// row per (batch, time block), summed by the wrapper: every element is
// written by exactly one block, so there are no atomics and the result does
// not depend on the schedule.
//
// Tiling: the forward kernel's (csrc/snake_conv1d.cu), with dy in the place
// of x and no snake prologue: one block owns BL time rows x 64 input channels
// (BL = 128 with 8 warps for k > 1, 64 with 4 warps for k = 1), loads the dy
// window of BL + (k-1)*d rows time-major per chunk of 32 output channels and
// the [k, 32, 64] weight slice into shared memory, and accumulates with WMMA
// bf16 16x16x16 fragments (f32). The epilogue stages the accumulators
// column-major (each warp then reads one channel's rows without bank
// conflicts), applies the snake derivative at each position, writes dx
// coalesced along time and reduces dalpha/dbeta over the block's rows with
// warp shuffles. Rows past L are masked out of the sums.
//
// Bound on the H100: 2*B*L*Ci*Co*k operations against ~2 bytes per element
// of dy, x and dx: tensor-core bound at every width of the Oobleck path.
// What the design does about it: the tensor cores, and the fusion of the
// snake derivative and its parameter gradients into the epilogue, so ds never
// reaches device memory. Loads are synchronous and the window is re-read for
// each 64-channel tile, so it stays well below the peak, as the forward does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int COB = 64;       // input channels (ci) per block: the "output" here
constexpr int CIC = 32;       // output channels (co) per chunk: the reduction
constexpr int LDX = 48;       // bf16 row stride of the dy window (96 B)
constexpr int LDW = 64;       // bf16 row stride of the weight slice (128 B)
constexpr int MAX_SPAN = 192; // max (k-1)*d supported

template <int BL, int THREADS = BL / 16 * 32>
__global__ void __launch_bounds__(THREADS)
snake_conv1d_dx_kernel(const __nv_bfloat16* __restrict__ dy,   // [B, Co, Lout]
                       const __nv_bfloat16* __restrict__ wt,   // [k, Co, Ci]
                       const __nv_bfloat16* __restrict__ x,    // [B, Ci, L]
                       const float* __restrict__ alpha,
                       const float* __restrict__ beta,
                       __nv_bfloat16* __restrict__ dx,         // [B, Ci, L]
                       float* __restrict__ pa,                 // [B, nblk, Ci]
                       float* __restrict__ pb,
                       int Co, int Ci, int Lout, int L, int k, int d, int off) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int LDS = BL + 4;  // f32 column stride of the stage
  constexpr int NW = THREADS / 32;
  const int span = (k - 1) * d;
  const int rows = BL + span;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int ys_elems = ((rows * LDX + 63) / 64) * 64;
  __nv_bfloat16* ws = ys + ys_elems;                  // [k][CIC][LDW]
  float* stage = reinterpret_cast<float*>(smem_raw);  // [COB][LDS], after the loop

  const int l0 = blockIdx.x * BL;
  const int ci0 = blockIdx.y * COB;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* dyb = dy + (size_t)b * Co * Lout;
  const bool vec_w = Ci % 8 == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[COB / 16];
#pragma unroll
  for (int n = 0; n < COB / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int co0 = 0; co0 < Co; co0 += CIC) {
    __syncthreads();  // previous chunk's fragments are loaded
    // dy window: row t holds dy time l0 - off + t, 0 outside [0, Lout)
    for (int c = warp; c < CIC; c += NW) {
      const int co = co0 + c;
      const bool live = co < Co;
      for (int t = lane; t < rows; t += 32) {
        const int pos = l0 - off + t;
        __nv_bfloat16 val = __float2bfloat16(0.f);
        if (live && pos >= 0 && pos < Lout) val = dyb[(size_t)co * Lout + pos];
        ys[t * LDX + c] = val;
      }
    }
    // weight slice [k][CIC][COB] of wt, zero outside Co / Ci
    if (vec_w) {  // groups of 8 channels lie wholly inside or outside Ci
      for (int i = threadIdx.x; i < k * CIC * (COB / 8); i += THREADS) {
        const int o = (i % (COB / 8)) * 8, c = (i / (COB / 8)) % CIC;
        const int j = i / ((COB / 8) * CIC);
        const int co = co0 + c, ci = ci0 + o;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (co < Co && ci < Ci)
          val = *reinterpret_cast<const uint4*>(wt + ((size_t)j * Co + co) * Ci + ci);
        *reinterpret_cast<uint4*>(ws + (j * CIC + c) * LDW + o) = val;
      }
    } else {
      for (int i = threadIdx.x; i < k * CIC * COB; i += THREADS) {
        const int o = i % COB, c = (i / COB) % CIC, j = i / (COB * CIC);
        const int co = co0 + c, ci = ci0 + o;
        __nv_bfloat16 val = __float2bfloat16(0.f);
        if (co < Co && ci < Ci) val = wt[((size_t)j * Co + co) * Ci + ci];
        ws[(j * CIC + c) * LDW + o] = val;
      }
    }
    __syncthreads();

    for (int j = 0; j < k; ++j) {
      const __nv_bfloat16* yw = ys + (warp * 16 + j * d) * LDX;
#pragma unroll
      for (int cs = 0; cs < CIC; cs += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, yw + cs, LDX);
#pragma unroll
        for (int n = 0; n < COB / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, ws + (j * CIC + cs) * LDW + n * 16, LDW);
          wmma::mma_sync(acc[n], af, bf, acc[n]);
        }
      }
    }
  }
  __syncthreads();  // the stage aliases the dy window
  // column-major: stage[o * LDS + t] holds ds at row t, channel ci0 + o
#pragma unroll
  for (int n = 0; n < COB / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16 * LDS + warp * 16, acc[n], LDS,
                            wmma::mem_col_major);
  __syncthreads();

  const int nblk = gridDim.x;
  for (int o = warp; o < COB; o += NW) {
    const int ci = ci0 + o;
    if (ci >= Ci) break;  // uniform across the warp
    const float a = alpha[ci];
    const float binv = 1.f / (beta[ci] + 1e-9f);
    const size_t row = ((size_t)b * Ci + ci) * L;
    float sa = 0.f, sb = 0.f;
    for (int t = lane; t < BL; t += 32) {
      const int l = l0 + t;
      if (l < L) {
        const float g = stage[o * LDS + t];
        const float xv = __bfloat162float(x[row + l]);
        float s, c;
        sincosf(a * xv, &s, &c);
        const float ds2 = 2.f * s * c;  // sin(2 a x)
        dx[row + l] = __float2bfloat16(g * (1.f + a * binv * ds2));
        sa += g * xv * binv * ds2;
        sb -= g * s * s * binv * binv;
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, m);
      sb += __shfl_xor_sync(0xffffffffu, sb, m);
    }
    if (lane == 0) {
      const size_t p = ((size_t)b * nblk + blockIdx.x) * Ci + ci;
      pa[p] = sa;
      pb[p] = sb;
    }
  }
}

template <int BL>
int launch(const void* dy, const void* wt, const void* x, const void* alpha,
           const void* beta, void* dx, void* pa, void* pb, int B, int Co, int Ci,
           int Lout, int L, int k, int d, int off, cudaStream_t stream) {
  const int rows = BL + (k - 1) * d;
  const int ys_bytes = ((rows * LDX + 63) / 64) * 64 * 2;
  const int ws_bytes = k * CIC * LDW * 2;
  int smem = ys_bytes + ws_bytes;
  const int stage_bytes = COB * (BL + 4) * 4;
  if (smem < stage_bytes) smem = stage_bytes;
  cudaFuncSetAttribute(snake_conv1d_dx_kernel<BL>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((L + BL - 1) / BL, (Ci + COB - 1) / COB, B);
  snake_conv1d_dx_kernel<BL><<<grid, BL / 16 * 32, smem, stream>>>(
      (const __nv_bfloat16*)dy, (const __nv_bfloat16*)wt, (const __nv_bfloat16*)x,
      (const float*)alpha, (const float*)beta, (__nv_bfloat16*)dx, (float*)pa,
      (float*)pb, Co, Ci, Lout, L, k, d, off);
  return (int)cudaGetLastError();
}

}  // namespace

// Time blocks per batch row of the partials: the wrapper sizes pa/pb as
// [B, snake_conv1d_dx_blocks(L, k), Ci].
extern "C" int snake_conv1d_dx_blocks(int L, int k) {
  const int bl = k == 1 ? 64 : 128;
  return (L + bl - 1) / bl;
}

extern "C" int snake_conv1d_dx(const void* dy, const void* wt, const void* x,
                               const void* alpha, const void* beta, void* dx,
                               void* pa, void* pb, int B, int Co, int Ci, int Lout,
                               int L, int k, int d, int pad_lo, void* stream) {
  if ((k - 1) * d > MAX_SPAN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int off = (k - 1) * d - pad_lo;
  if (k == 1)
    return launch<64>(dy, wt, x, alpha, beta, dx, pa, pb, B, Co, Ci, Lout, L, k, d, off, s);
  return launch<128>(dy, wt, x, alpha, beta, dx, pa, pb, B, Co, Ci, Lout, L, k, d, off, s);
}
