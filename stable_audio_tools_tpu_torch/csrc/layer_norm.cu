// Fused last-axis LayerNorm forward for Hopper (sm_90a):
//   y = (x - mean) * rsqrt(var + eps) * gamma (+ beta)
// over the rows of x [rows, C], with two-pass f32 row statistics
// (mean, then the mean of the squared deviations), y in x's dtype.
//
// Replaces stable_audio_tools_tpu/ops/kernels/layer_norm.py `_ln_kernel` and
// `_ln_kernel_beta` (reached from `fused_layer_norm` through `_ln_forward`).
// The gradient stays plain PyTorch, as the JAX package's is plain XLA.
//
// Bound on the H100: bytes. At the DiT's rows ([2050, 1536] bf16) it reads x
// and writes y once, 12.6 MB, against ~8 FLOP an element: 3.8 us at
// 3.35 TB/s. At that size a launch is a few microseconds of device time, so
// the design keeps both the device and the host side short:
// - ln_warp_kernel: one warp a row, four rows a block; a lane holds its part
//   of the row in registers from 16-byte vector loads (C = 1536 bf16: six
//   vectors a lane), so x is read once; the two statistics are warp-shuffle
//   sums; gamma and beta are read in their own dtype (f32, bf16 or f16), so a
//   bf16 gamma needs no cast launch. It takes rows whose length is a
//   multiple of the vector (8 bf16 / f16, 4 f32) up to 16 vectors a lane
//   (C <= 4096 bf16, 2048 f32) with every pointer on 16 bytes;
// - ln_block_kernel: any other row (C up to the wrapper's limit, any
//   alignment): one block of 256 threads a row, scalar loads, block
//   reductions through shared memory, the row re-read from cache for each
//   pass.
// The host calls one C function through ctypes (ops/kernels/layer_norm.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes of the C interface
constexpr int F32 = 0, BF16 = 1, F16 = 2;

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

// element i of a parameter vector in its own dtype
__device__ __forceinline__ float param(const void* p, int dtype, int i) {
  if (dtype == F32) return reinterpret_cast<const float*>(p)[i];
  if (dtype == BF16) return to_f(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  return to_f(reinterpret_cast<const __half*>(p)[i]);
}

// VW consecutive elements of a parameter vector from 16-byte-aligned
// storage, by vector loads
template <int VW>
__device__ __forceinline__ void params(const void* p, int dtype, int i, float (&out)[VW]) {
  if (dtype == F32) {
#pragma unroll
    for (int v = 0; v < VW / 4; ++v) {
      const float4 x = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i)[v];
      out[4 * v] = x.x;
      out[4 * v + 1] = x.y;
      out[4 * v + 2] = x.z;
      out[4 * v + 3] = x.w;
    }
    return;
  }
  // 16-bit: VW elements are VW * 2 bytes (16 or 8)
  uint32_t w[VW / 2];
  if constexpr (VW == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(reinterpret_cast<const uint16_t*>(p) + i);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(reinterpret_cast<const uint16_t*>(p) + i);
    w[0] = x.x, w[1] = x.y;
  }
#pragma unroll
  for (int j = 0; j < VW / 2; ++j) {
    if (dtype == BF16) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      out[2 * j] = f.x, out[2 * j + 1] = f.y;
    } else {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[j]));
      out[2 * j] = f.x, out[2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr int WARP_ROWS = 4;  // rows (warps) a block of ln_warp_kernel

template <typename T, int NV>
__global__ void __launch_bounds__(32 * WARP_ROWS)
ln_warp_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
               const void* __restrict__ beta, T* __restrict__ y, int rows, int C, float eps,
               int g_dtype, int b_dtype) {
  constexpr int VW = 16 / sizeof(T);  // elements a 16-byte vector
  const int row = blockIdx.x * WARP_ROWS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
  const int nvec = C / VW;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  float v[NV][VW];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) {
      const uint4 raw = xr[j];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        v[i][u] = to_f(e[u]);
        sum += v[i][u];
      }
    }
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < nvec)
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        v[i][u] -= mean;
        sq += v[i][u] * v[i][u];
      }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) {
      float g[VW], bb[VW];
      params<VW>(gamma, g_dtype, j * VW, g);
      if (beta != nullptr) params<VW>(beta, b_dtype, j * VW, bb);
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        float out = v[i][u] * rstd * g[u];
        if (beta != nullptr) out += bb[u];
        e[u] = from_f<T>(out);
      }
      yr[j] = raw;
    }
  }
}

constexpr int BLOCK = 256;

// the sum of x over the block, returned to every thread
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // `red` is free from the previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = lane < BLOCK / 32 ? red[lane] : 0.f;
  return warp_sum(t);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
ln_block_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                const void* __restrict__ beta, T* __restrict__ y, int C, float eps,
                int g_dtype, int b_dtype) {
  __shared__ float red[BLOCK / 32];
  const T* xr = x + (size_t)blockIdx.x * C;
  T* yr = y + (size_t)blockIdx.x * C;
  float sum = 0.f;
  for (int c = threadIdx.x; c < C; c += BLOCK) sum += to_f(xr[c]);
  const float mean = block_sum(sum, red) / C;
  float sq = 0.f;
  for (int c = threadIdx.x; c < C; c += BLOCK) {
    const float d = to_f(xr[c]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(block_sum(sq, red) / C + eps);
  for (int c = threadIdx.x; c < C; c += BLOCK) {
    float out = (to_f(xr[c]) - mean) * rstd * param(gamma, g_dtype, c);
    if (beta != nullptr) out += param(beta, b_dtype, c);
    yr[c] = from_f<T>(out);
  }
}

template <typename T, int NV>
int warp_launch(const void* x, const void* g, const void* b, void* y, int rows, int C,
                float eps, int gd, int bd, cudaStream_t stream) {
  ln_warp_kernel<T, NV><<<(rows + WARP_ROWS - 1) / WARP_ROWS, 32 * WARP_ROWS, 0, stream>>>(
      (const T*)x, g, b, (T*)y, rows, C, eps, gd, bd);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* g, const void* b, void* y, int rows, int C, float eps,
             int gd, int bd, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x | (uintptr_t)y | (uintptr_t)g | (uintptr_t)b) % 16 == 0;
  const int lanes_vecs = (C / VW + 31) / 32;  // vectors a lane
  if (aligned && C % VW == 0 && lanes_vecs <= 16) {
    if (lanes_vecs <= 1) return warp_launch<T, 1>(x, g, b, y, rows, C, eps, gd, bd, stream);
    if (lanes_vecs <= 2) return warp_launch<T, 2>(x, g, b, y, rows, C, eps, gd, bd, stream);
    if (lanes_vecs <= 3) return warp_launch<T, 3>(x, g, b, y, rows, C, eps, gd, bd, stream);
    if (lanes_vecs <= 4) return warp_launch<T, 4>(x, g, b, y, rows, C, eps, gd, bd, stream);
    if (lanes_vecs <= 6) return warp_launch<T, 6>(x, g, b, y, rows, C, eps, gd, bd, stream);
    if (lanes_vecs <= 8) return warp_launch<T, 8>(x, g, b, y, rows, C, eps, gd, bd, stream);
    if (lanes_vecs <= 12) return warp_launch<T, 12>(x, g, b, y, rows, C, eps, gd, bd, stream);
    return warp_launch<T, 16>(x, g, b, y, rows, C, eps, gd, bd, stream);
  }
  ln_block_kernel<T><<<rows, BLOCK, 0, stream>>>((const T*)x, g, b, (T*)y, C, eps, gd, bd);
  return (int)cudaGetLastError();
}

}  // namespace

// y [rows, C] = LayerNorm of x [rows, C] (both contiguous, x_dtype) with
// gamma [C] (g_dtype) and beta [C] (b_dtype; null for none). Dtype codes:
// 0 f32, 1 bf16, 2 f16; anything else returns cudaErrorInvalidValue.
extern "C" int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                              int rows, int C, int x_dtype, int g_dtype, int b_dtype, float eps,
                              void* stream) {
  if (g_dtype < 0 || g_dtype > 2 || (beta != nullptr && (b_dtype < 0 || b_dtype > 2)) ||
      rows <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == BF16)
    return launch_t<__nv_bfloat16>(x, gamma, beta, y, rows, C, eps, g_dtype, b_dtype, st);
  if (x_dtype == F16) return launch_t<__half>(x, gamma, beta, y, rows, C, eps, g_dtype, b_dtype, st);
  if (x_dtype == F32) return launch_t<float>(x, gamma, beta, y, rows, C, eps, g_dtype, b_dtype, st);
  return (int)cudaErrorInvalidValue;
}
