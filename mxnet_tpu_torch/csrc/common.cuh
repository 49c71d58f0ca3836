// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel file exposes `extern "C"` entry points with a plain C
// interface (pointers, sizes, a dtype code, the stream) that
// `ops/kernels/_build.py` loads with ctypes. Each entry launches on the
// caller's stream, allocates nothing, and returns `cudaGetLastError()`
// so a refused launch (too many threads, too much shared memory) raises
// in the Python wrapper instead of passing silently.
//
// Built with `nvcc -gencode arch=compute_90a,code=sm_90a -O3` and never
// with `--use_fast_math`: that flag would swap `expf`, division and
// `sqrtf` for approximations and break parity with the reference's
// f32 arithmetic (int8 KV rounding in particular divides by the scale).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

// dtype codes; ops/kernels/_build.py holds the same table
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp astype
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (is_max = false) or max over the whole block; every thread gets the
// result. `scratch` holds one float per warp. blockDim.x is a multiple of
// 32 and at most 1024.
__device__ __forceinline__ float block_reduce(float v, float* scratch,
                                              bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float identity = is_max ? __int_as_float(0xff800000) : 0.0f;
    float r = lane < nwarps ? scratch[lane] : identity;
    r = is_max ? warp_max(r) : warp_sum(r);
    if (lane == 0) scratch[0] = r;
  }
  __syncthreads();
  return scratch[0];
}

// ---- asynchronous copies --------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
