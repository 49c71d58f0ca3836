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

// ---- 16-byte vectors -------------------------------------------------------

// 16 bytes at p (8 bf16/f16 or 4 f32 values) widened to f32
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&out)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) out[j] = to_f32(e[j]);
}

// f32 values rounded to T and written as one 16-byte store
template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&v)[16 / sizeof(T)]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) e[j] = from_f32<T>(v[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// ---- bulk copies (TMA without a tensor map) and mbarriers -------------------
//
// One thread arms an mbarrier with the bytes it expects and issues
// `cp.async.bulk` copies of contiguous, 16-byte-aligned runs of global
// memory into the block's shared memory; the copy engine completes the
// barrier's transactions, and the threads that need the data wait on the
// barrier's phase parity.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// makes initialised barriers visible to the copy engine and the cluster
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival, and `bytes` more transaction bytes for the current phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// one arrival (a consumer releasing a ring stage back to the producer)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spin until the phase of the given parity has completed. A phase that
// never completes (a byte count that disagrees with the copies) traps
// after about 2^26 polls, each of which may suspend the thread for a
// while, so that a fault ends the launch with an error instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}
// `bytes` (a multiple of 16) from global src to the block's own shared
// dst, both 16-byte aligned; completes `bar`'s transactions
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// orders this block's earlier generic accesses of shared memory before
// later bulk copies into it
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
