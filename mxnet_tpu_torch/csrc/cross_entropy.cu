// K3 — row-wise logsumexp in one streaming pass, for Hopper.
//
// Replaces `_lse_kernel` (mxnet_tpu/ops/pallas/cross_entropy.py:34,
// reached through fused_lse :64 and cross_entropy_with_logits :105).
// Input (N, V) f32 or bf16 logits, output (N,) f32 lse = m + log(l) with
// an online max m (starting at the finite -1e30) and sum l, and the
// `l == 0` guard of the TPU kernel. The V tail needs no padding: the loop
// stops at V (32000 is no power of two).
//
// Bound on this card: bytes. Every logit is read once and only N floats
// are written; at the LM head's (8184, 32000) f32 that is 1.05 GB, 0.31 ms
// at 3.35 TB/s. The exponentials (one per logit plus one rescale per
// chunk) are far below the FMA and SFU rates. Design: one 256-thread
// block per row; each thread reads 16-byte chunks (4 f32 or 8 bf16
// values) strided across the row, so a warp reads 512 contiguous bytes a
// step, and keeps its own (m, l); the pairs are merged over the warp with
// shuffles and over the block through shared memory. The TPU kernel's
// sequential V grid axis, whose VMEM scratch carried (m, l), becomes the
// loop inside the block.
#include "common.cuh"

namespace {

constexpr int LSE_THREADS = 256;
constexpr float NEG_BIG = -1e30f;

// 16 bytes -> 4 f32 or 8 bf16 values (bf16 to f32 is the top 16 bits)
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// merge the running pair (m, l) with (mo, lo)
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(LSE_THREADS)
row_lse_kernel(const T* __restrict__ x, float* __restrict__ lse, int64_t v,
               int vec) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float m_s[LSE_THREADS / 32], l_s[LSE_THREADS / 32];
  const T* row = x + (int64_t)blockIdx.x * v;
  float m = NEG_BIG, l = 0.0f;
  int64_t tail = 0;
  if (vec) {  // the row starts on a 16-byte boundary
    const int64_t nv = v / VEC;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int64_t c = threadIdx.x; c < nv; c += LSE_THREADS) {
      float f[VEC];
      unpack(__ldg(rv + c), f);
      float cm = f[0];
#pragma unroll
      for (int e = 1; e < VEC; ++e) cm = fmaxf(cm, f[e]);
      const float mn = fmaxf(m, cm);
      float add = 0.0f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) add += expf(f[e] - mn);
      l = l * expf(m - mn) + add;
      m = mn;
    }
    tail = nv * VEC;
  }
  for (int64_t c = tail + threadIdx.x; c < v; c += LSE_THREADS) {
    const float xv = to_f32(row[c]);
    const float mn = fmaxf(m, xv);
    l = l * expf(m - mn) + expf(xv - mn);
    m = mn;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, mo, lo);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = m_s[0];
    l = l_s[0];
    for (int w = 1; w < LSE_THREADS / 32; ++w) merge(m, l, m_s[w], l_s[w]);
    lse[blockIdx.x] = m + logf(l == 0.0f ? 1.0f : l);
  }
}

}  // namespace

extern "C" int mxt_row_lse(const void* x, void* lse, int64_t n, int64_t v,
                           int vec, int dtype, void* stream) {
  if (n <= 0) return 0;
  if (v < 1 || n > 2147483647) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      row_lse_kernel<float><<<(unsigned)n, LSE_THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(lse), v, vec);
      break;
    case kBF16:
      row_lse_kernel<__nv_bfloat16><<<(unsigned)n, LSE_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<float*>(lse), v,
          vec);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
