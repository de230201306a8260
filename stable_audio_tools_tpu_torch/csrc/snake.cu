// Snake-beta activation, forward and backward, for Hopper (sm_90a), over
// x [B, C, L] (channels before time) with per-channel alpha, beta [C] (f32,
// post-exp), binv = 1 / (beta + 1e-9):
//   forward   y = x + sin^2(alpha x) binv;
//   backward  dx = g (1 + alpha binv sin(2 alpha x)),
//             dalpha = sum g x binv sin(2 alpha x),
//             dbeta = -sum g sin^2(alpha x) binv^2 (sums over batch and time).
//
// Replaces stable_audio_tools_tpu/ops/kernels/snake.py `_fwd_kernel` (row 4,
// through `_fwd`) and `_bwd_kernel` (row 9, through `_bwd`). The TPU kernels
// take [B*L, C] and a range-reduced sin^2 polynomial; these keep [B, C, L]
// and exact f32 sines (snake_math.cuh): the forward is `snake_n`, the
// snake-conv kernels' own; the backward takes `sincos_lean`, CUDA's sincosf
// bit for bit for |alpha x| < 105615 in fewer instructions than the
// snake-conv epilogue's `sincos_fast`, and sincosf itself beyond.
//
// Bound on the H100: bytes. The backward reads x and g and writes dx, 6
// bytes an element in bf16 (the forward 4): at [4, 128, 65536] 60 us. Its
// arithmetic is a few dozen instructions an element, most of them the sine
// pair, so the instruction rate is close behind the memory's: the design
// spends few instructions on the sines (`sincos_lean`) and issues the next
// vector's loads ahead of each vector's arithmetic. The design:
// - a work plan sized by live elements (ops/kernels/snake.py `snake_plan`,
//   passed in; the Python function is the one definition): a block of 256
//   threads takes `tpr` threads along a row (a power of two covering the
//   row's vectors, at most 256), so THREADS / tpr rows a pass, `col_steps`
//   vectors a thread along its row and `row_passes` passes: a tile of 2-16 K
//   elements whatever the site (2048 x 32: 64 rows a block; 128 x 65536: one
//   row, eight vectors a thread), never a 4096-lane block of dead lanes;
// - 16-byte loads and stores (8 bf16 / f16 or 4 f32 a thread) where L is a
//   multiple of the vector and every pointer lies on 16 bytes, else one
//   element a thread (ragged L, offset views); the backward loads a
//   thread's next x and g vectors before the sines of the current ones;
// - deterministic per-channel sums without float atomics: each block reduces
//   each row's partials (warp shuffles, then the row's warps in order
//   through shared memory) into a workspace [2][B*C][ncb] that every slot of
//   is written once; a second kernel in the same call sums each channel's
//   B * ncb slots in a fixed order (b, then the column block: a lane's
//   strided terms in order, then a shuffle tree) and writes dalpha, dbeta
//   [2, C] in f32. Two calls give the same bits.
// The host calls one C function a direction through ctypes
// (ops/kernels/snake.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "snake_math.cuh"

namespace {

constexpr int F32 = 0, BF16 = 1, F16 = 2;  // dtype codes of the C interface
constexpr int THREADS = 256;               // a block of either direction
constexpr int REDUCE_WARPS = 8;            // channels a block of the second stage

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// two 16-bit values of T from / into one 32-bit word
__device__ __forceinline__ float2 unpack2(uint32_t w, __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ float2 unpack2(uint32_t w, __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half*) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// VW consecutive elements of T as loaded: one 16-byte vector when VW > 1
template <typename T, int VW>
struct Raw {
  uint4 v;
};
template <typename T>
struct Raw<T, 1> {
  T v;
};

template <typename T, int VW>
__device__ __forceinline__ Raw<T, VW> load_raw(const T* p) {
  if constexpr (VW == 1) {
    return {*p};
  } else {
    static_assert(VW * sizeof(T) == 16, "a vector is 16 bytes");
    return {*reinterpret_cast<const uint4*>(p)};
  }
}

template <typename T, int VW>
__device__ __forceinline__ void to_floats(const Raw<T, VW>& raw, float (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = to_f(raw.v);
  } else if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(raw.v.x), v[1] = __uint_as_float(raw.v.y);
    v[2] = __uint_as_float(raw.v.z), v[3] = __uint_as_float(raw.v.w);
  } else {
    const uint32_t w[4] = {raw.v.x, raw.v.y, raw.v.z, raw.v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack2(w[j], (T*)nullptr);
      v[2 * j] = f.x, v[2 * j + 1] = f.y;
    }
  }
}

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VW]) {
  if constexpr (VW == 1) {
    *p = from_f<T>(v[0]);
  } else {
    uint4 raw;
    if constexpr (sizeof(T) == 4) {
      raw = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                       __float_as_uint(v[3]));
    } else {
      raw = make_uint4(pack2(v[0], v[1], (T*)nullptr), pack2(v[2], v[3], (T*)nullptr),
                       pack2(v[4], v[5], (T*)nullptr), pack2(v[6], v[7], (T*)nullptr));
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// sincosf of |t| >= 105615 (its slow path, with a stack frame: rare), out of
// line so that the loop around it keeps its registers
__device__ __noinline__ float2 sincos_slow(float t) {
  float s, c;
  sincosf(t, &s, &c);
  return make_float2(s, c);
}

// sin and cos of a * v for n values: the lean pair for all, then sincosf
// for any |a v| >= 105615
template <int N>
__device__ __forceinline__ void sincos_n(float a, const float (&v)[N], float (&s)[N],
                                         float (&c)[N]) {
  bool slow = false;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float t = __fmul_rn(a, v[e]);
    sincos_lean(t, &s[e], &c[e]);
    slow |= fabsf(t) >= 105615.f;
  }
  if (slow) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float t = __fmul_rn(a, v[e]);
      if (fabsf(t) >= 105615.f) {
        const float2 sc = sincos_slow(t);
        s[e] = sc.x, c[e] = sc.y;
      }
    }
  }
}

// Where a thread works under the plan: block b of the grid is row block
// b / ncb, column block b % ncb; thread t takes row pass slot t / tpr and
// the vectors lane * VW + s * tpr * VW (s < col_steps) of the column block.
struct Walk {
  int rows_pass, step, rb, cb, sub, lane, col0;
  __device__ Walk(int tpr, int col_steps, int ncb, int vw) {
    rows_pass = THREADS / tpr;
    step = tpr * vw;
    rb = blockIdx.x / ncb;
    cb = blockIdx.x - rb * ncb;
    sub = threadIdx.x / tpr;
    lane = threadIdx.x % tpr;
    col0 = cb * col_steps * step + lane * vw;
  }
  __device__ int row(int pass, int row_passes, int slot) const {
    return (rb * row_passes + pass) * rows_pass + slot;
  }
};

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
snake_fwd_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                 const float* __restrict__ beta, T* __restrict__ y, int rows, int C, int L,
                 int tpr, int col_steps, int row_passes, int ncb) {
  const Walk w(tpr, col_steps, ncb, VW);
  for (int p = 0; p < row_passes; ++p) {
    const int row = w.row(p, row_passes, w.sub);
    if (row >= rows) break;
    float a[VW], binv[VW];
    a[0] = alpha[row % C];
    binv[0] = 1.f / (beta[row % C] + 1e-9f);
#pragma unroll
    for (int u = 1; u < VW; ++u) a[u] = a[0], binv[u] = binv[0];
    const size_t base = (size_t)row * L;
    int col = w.col0;
    for (int s = 0; s < col_steps && col < L; ++s, col += w.step) {
      float v[VW];
      to_floats<T, VW>(load_raw<T, VW>(x + base + col), v);
      snake_n<VW>(v, a, binv);
      store_vec<T, VW>(y + base + col, v);
    }
  }
}

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
snake_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ alpha, const float* __restrict__ beta,
                 T* __restrict__ dx, float* __restrict__ ws, int rows, int C, int L, int tpr,
                 int col_steps, int row_passes, int ncb) {
  __shared__ float red[2][THREADS / 32];
  const Walk w(tpr, col_steps, ncb, VW);
  const int width = tpr < 32 ? tpr : 32;  // a row's lanes within one warp
  for (int p = 0; p < row_passes; ++p) {
    const int row = w.row(p, row_passes, w.sub);
    // per thread: sa = sum g x sin(ax) cos(ax), sb = sum g sin^2(ax); the
    // second stage scales them by 2 binv and -binv^2
    float sa = 0.f, sb = 0.f;
    if (row < rows) {
      const float a = alpha[row % C];
      const float ab2 = 2.f * a * (1.f / (beta[row % C] + 1e-9f));
      const T* xr = x + (size_t)row * L;
      const T* gr = g + (size_t)row * L;
      int col = w.col0;
      // the next vector's loads go out before this one's arithmetic
      Raw<T, VW> rx, rg;
      if (col < L) rx = load_raw<T, VW>(xr + col), rg = load_raw<T, VW>(gr + col);
      for (int s = 0; s < col_steps && col < L; ++s, col += w.step) {
        float xv[VW], gv[VW], sn[VW], cs[VW], out[VW];
        to_floats<T, VW>(rx, xv);
        to_floats<T, VW>(rg, gv);
        if (s + 1 < col_steps && col + w.step < L)
          rx = load_raw<T, VW>(xr + col + w.step), rg = load_raw<T, VW>(gr + col + w.step);
        sincos_n<VW>(a, xv, sn, cs);
#pragma unroll
        for (int u = 0; u < VW; ++u) {
          const float gsc = gv[u] * (sn[u] * cs[u]);  // g sin(2ax) / 2
          out[u] = fmaf(ab2, gsc, gv[u]);
          sa = fmaf(gsc, xv[u], sa);
          sb = fmaf(gv[u], sn[u] * sn[u], sb);
        }
        store_vec<T, VW>(dx + (size_t)row * L + col, out);
      }
    }
    // the row's partial: its lanes within a warp, then (tpr > 32) its warps
    // in order; every thread takes part, live row or not
    for (int off = width >> 1; off > 0; off >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    const size_t plane = (size_t)rows * ncb;
    if (tpr <= 32) {
      if (w.lane == 0 && row < rows) {
        ws[(size_t)row * ncb + w.cb] = sa;
        ws[plane + (size_t)row * ncb + w.cb] = sb;
      }
      continue;
    }
    const int warp = threadIdx.x / 32, wpr = tpr / 32;
    if (threadIdx.x % 32 == 0) red[0][warp] = sa, red[1][warp] = sb;
    __syncthreads();
    if (threadIdx.x < w.rows_pass) {
      const int r = w.row(p, row_passes, threadIdx.x);
      if (r < rows) {
        float ta = 0.f, tb = 0.f;
        for (int k = 0; k < wpr; ++k) {
          ta += red[0][threadIdx.x * wpr + k];
          tb += red[1][threadIdx.x * wpr + k];
        }
        ws[(size_t)r * ncb + w.cb] = ta;
        ws[plane + (size_t)r * ncb + w.cb] = tb;
      }
    }
    __syncthreads();  // `red` is free for the next pass
  }
}

// dalpha[c] = 2 binv sum sa, dbeta[c] = -binv^2 sum sb over the B * ncb
// slots of channel c, in the order (b, column block); one warp a channel
__global__ void __launch_bounds__(32 * REDUCE_WARPS)
snake_bwd_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ beta,
                        float* __restrict__ out, int B, int C, int ncb) {
  const int c = blockIdx.x * REDUCE_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (c >= C) return;  // uniform across the warp
  const size_t plane = (size_t)B * C * ncb;
  float sa = 0.f, sb = 0.f;
  for (int i = lane; i < B * ncb; i += 32) {
    const int b = i / ncb;
    const size_t slot = ((size_t)b * C + c) * ncb + (i - b * ncb);
    sa += ws[slot];
    sb += ws[plane + slot];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }
  if (lane == 0) {
    const float binv = 1.f / (beta[c] + 1e-9f);
    out[c] = 2.f * binv * sa;
    out[C + c] = -(binv * binv) * sb;
  }
}

template <typename T, int VW>
int fwd_t(const void* x, const float* alpha, const float* beta, void* y, int rows, int C,
          int L, int tpr, int col_steps, int row_passes, int ncb, int blocks,
          cudaStream_t st) {
  snake_fwd_kernel<T, VW><<<blocks, THREADS, 0, st>>>((const T*)x, alpha, beta, (T*)y, rows, C,
                                                      L, tpr, col_steps, row_passes, ncb);
  return (int)cudaGetLastError();
}

template <typename T, int VW>
int bwd_t(const void* x, const void* g, const float* alpha, const float* beta, void* dx,
          float* ws, float* out, int B, int C, int L, int tpr, int col_steps, int row_passes,
          int ncb, int blocks, cudaStream_t st) {
  snake_bwd_kernel<T, VW><<<blocks, THREADS, 0, st>>>((const T*)x, (const T*)g, alpha, beta,
                                                      (T*)dx, ws, B * C, C, L, tpr, col_steps,
                                                      row_passes, ncb);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  snake_bwd_reduce_kernel<<<(C + REDUCE_WARPS - 1) / REDUCE_WARPS, 32 * REDUCE_WARPS, 0, st>>>(
      ws, beta, out, B, C, ncb);
  return (int)cudaGetLastError();
}

// The grid of a plan, or 0 if the plan does not fit the shape (a vector
// path needs L a multiple of the vector and every pointer on 16 bytes)
int plan_blocks(int rows, int L, int vw, int tpr, int col_steps, int row_passes, int ncb,
                uintptr_t ptrs) {
  if (rows <= 0 || L <= 0 || tpr <= 0 || tpr > THREADS || (tpr & (tpr - 1)) || col_steps <= 0 ||
      row_passes <= 0)
    return 0;
  if (vw > 1 && (L % vw || ptrs % 16)) return 0;
  const long long cols = (long long)col_steps * tpr * vw;
  if (ncb != (L + cols - 1) / cols) return 0;
  const long long per = (long long)(THREADS / tpr) * row_passes;
  const long long blocks = (rows + per - 1) / per * ncb;
  return blocks > 0x7fffffff ? 0 : (int)blocks;
}

}  // namespace

// y = snake(x) over x, y [rows = B*C, L] (contiguous, dtype code 0 f32,
// 1 bf16, 2 f16) under the plan (vec 1: 16-byte vectors, 0: one element a
// thread; tpr, col_steps, row_passes, ncb as `snake_plan` gives them);
// alpha, beta [C] f32. A plan that does not fit returns cudaErrorInvalidValue.
extern "C" int snake_fwd(const void* x, const float* alpha, const float* beta, void* y,
                         int rows, int C, int L, int dtype, int vec, int tpr, int col_steps,
                         int row_passes, int ncb, void* stream) {
  const int vw = vec ? (dtype == F32 ? 4 : 8) : 1;
  const int blocks = plan_blocks(rows, L, vw, tpr, col_steps, row_passes, ncb,
                                 (uintptr_t)x | (uintptr_t)y);
  if (!blocks || C <= 0 || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SNAKE_FWD(T, VW) \
  fwd_t<T, VW>(x, alpha, beta, y, rows, C, L, tpr, col_steps, row_passes, ncb, blocks, st)
  if (dtype == BF16) return vec ? SNAKE_FWD(__nv_bfloat16, 8) : SNAKE_FWD(__nv_bfloat16, 1);
  if (dtype == F16) return vec ? SNAKE_FWD(__half, 8) : SNAKE_FWD(__half, 1);
  return vec ? SNAKE_FWD(float, 4) : SNAKE_FWD(float, 1);
#undef SNAKE_FWD
}

// dx [B, C, L] and out [2, C] f32 (dalpha, dbeta) of snake(x) for the
// cotangent g (x, g, dx contiguous, one dtype), through the workspace ws
// [2, B*C, ncb] f32; the plan as for snake_fwd. Two launches on `stream`.
extern "C" int snake_bwd(const void* x, const void* g, const float* alpha, const float* beta,
                         void* dx, float* ws, float* out, int B, int C, int L, int dtype,
                         int vec, int tpr, int col_steps, int row_passes, int ncb,
                         void* stream) {
  const int vw = vec ? (dtype == F32 ? 4 : 8) : 1;
  const int blocks = plan_blocks(B * C, L, vw, tpr, col_steps, row_passes, ncb,
                                 (uintptr_t)x | (uintptr_t)g | (uintptr_t)dx);
  if (!blocks || B <= 0 || C <= 0 || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SNAKE_BWD(T, VW)                                                                    \
  bwd_t<T, VW>(x, g, alpha, beta, dx, ws, out, B, C, L, tpr, col_steps, row_passes, ncb, \
               blocks, st)
  if (dtype == BF16) return vec ? SNAKE_BWD(__nv_bfloat16, 8) : SNAKE_BWD(__nv_bfloat16, 1);
  if (dtype == F16) return vec ? SNAKE_BWD(__half, 8) : SNAKE_BWD(__half, 1);
  return vec ? SNAKE_BWD(float, 4) : SNAKE_BWD(float, 1);
#undef SNAKE_BWD
}
