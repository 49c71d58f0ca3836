// K5a / K5b — the fused decode-step projections for Hopper.
//
// K5a replaces `_qkv_kernel` (mxnet_tpu/ops/pallas/fused_decode.py:92,
// reached through fused_qkv_project): x . W_qkv^T + b, split by head,
// and for int8 pools the per-(token, head) quantization of K and V
// straight into the pool row layout [D int8 values | 4 bytes of the f32
// scale, little-endian] (ops/nn.py kv_cache_quantize). A float store
// dtype is a cast instead.
// K5b replaces `_out_kernel` (fused_decode.py:120, reached through
// fused_out_project): a . W_out^T + b.
//
// Bound on this card: bytes. At decode (N = 8 tokens) the products are
// rank-8 updates whose cost is reading the weights once: 7.08 MB of f32
// W_qkv and 2.36 MB of W_out per layer at units 768. Design: a warp
// computes one output feature for up to 8 tokens at a time, streaming
// that weight row with 16-byte loads (units * itemsize % 16 == 0 is
// required); the activations are re-read from L1. W_qkv (3U, U) is read
// row-major as it is — output feature h*D + d of Q/K/V is row
// {0, U, 2U} + h*D + d — with no per-step transposed copy (the TPU
// wrapper re-slabs w.T on every call).
// K5a runs one block per (Q|K|V, head) so that a block holds all D
// features of a (token, head) for the int8 amax. Rounding follows
// jnp.round (half to even, rintf) on t / scale — a divide, never a
// multiply by the reciprocal of the scale.
#include "common.cuh"

namespace {

constexpr int NC = 8;            // tokens per pass
constexpr int QKV_THREADS = 512;
constexpr int OUT_THREADS = 256;
constexpr int MAX_D = 256;

template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&out)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) out[j] = to_f32(e[j]);
}

// One warp: acc[n] = sum_i x[n, i] * w_row[i] for n < nc; every lane ends
// with every sum.
template <typename T>
__device__ __forceinline__ void warp_row_dot(const T* __restrict__ w_row,
                                             const T* __restrict__ x0, int u,
                                             int nc, float (&acc)[NC]) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = 0.0f;
#pragma unroll 2
  for (int i = lane * V; i < u; i += 32 * V) {
    float w[V];
    load16(w_row + i, w);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if (n < nc) {
        float xv[V];
        load16(x0 + (int64_t)n * u + i, xv);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[n] = fmaf(xv[j], w[j], acc[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = warp_sum(acc[n]);
}

// acc[lane] without indexing a register array by a run-time value
__device__ __forceinline__ float pick_lane(const float (&acc)[NC], int lane) {
  float v = 0.0f;
#pragma unroll
  for (int n = 0; n < NC; ++n) v = (n == lane) ? acc[n] : v;
  return v;
}

template <typename T, typename S, bool QUANT>
__global__ void __launch_bounds__(QKV_THREADS)
qkv_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const T* __restrict__ bias, T* __restrict__ q_out,
           S* __restrict__ k_out, S* __restrict__ v_out, int n_tok, int u,
           int heads, int d, int dp) {
  __shared__ float y_s[NC][MAX_D];
  const int which = blockIdx.x / heads;  // 0 = Q, 1 = K, 2 = V
  const int h = blockIdx.x % heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int n0 = 0; n0 < n_tok; n0 += NC) {
    const int nc = min(NC, n_tok - n0);
    for (int f = warp; f < d; f += nwarps) {
      const int64_t o = (int64_t)which * u + (int64_t)h * d + f;
      float acc[NC];
      warp_row_dot(w + o * u, x + (int64_t)n0 * u, u, nc, acc);
      if (lane < nc)
        y_s[lane][f] = pick_lane(acc, lane) + (bias ? to_f32(bias[o]) : 0.0f);
    }
    __syncthreads();
    if (which == 0) {
      for (int idx = threadIdx.x; idx < nc * d; idx += blockDim.x) {
        const int n = idx / d, f = idx % d;
        q_out[((int64_t)(n0 + n) * heads + h) * d + f] = from_f32<T>(y_s[n][f]);
      }
    } else {
      S* dst = which == 1 ? k_out : v_out;
      if constexpr (QUANT) {
        for (int n = warp; n < nc; n += nwarps) {
          float amax = 0.0f;
          for (int f = lane; f < d; f += 32) amax = fmaxf(amax, fabsf(y_s[n][f]));
          amax = warp_max(amax);
          // amax * f32(1/127): the reference runs compiled, where XLA
          // folds its divide by the constant 127 into this multiply
          const float scale = fmaxf(amax, 1e-6f) * (1.0f / 127.0f);
          int8_t* row = reinterpret_cast<int8_t*>(dst) +
                        ((int64_t)(n0 + n) * heads + h) * dp;
          for (int f = lane; f < d; f += 32) {
            const float qv = fminf(fmaxf(rintf(y_s[n][f] / scale), -127.0f), 127.0f);
            row[f] = (int8_t)qv;
          }
          if (lane < 4) {
            // bitcast of the f32 scale, byte `lane` of its little-endian form
            const unsigned int bits = __float_as_uint(scale);
            row[d + lane] = (int8_t)((bits >> (8 * lane)) & 0xffu);
          }
        }
      } else {
        for (int idx = threadIdx.x; idx < nc * d; idx += blockDim.x) {
          const int n = idx / d, f = idx % d;
          dst[((int64_t)(n0 + n) * heads + h) * dp + f] = from_f32<S>(y_s[n][f]);
        }
      }
    }
    __syncthreads();  // y_s is rewritten by the next pass
  }
}

template <typename T>
__global__ void __launch_bounds__(OUT_THREADS)
out_kernel(const T* __restrict__ a, const T* __restrict__ w,
           const T* __restrict__ bias, T* __restrict__ out, int n_tok,
           int u_in, int u_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int o = blockIdx.x * nwarps + warp;  // one output feature per warp
  if (o >= u_out) return;
  const float b = bias ? to_f32(bias[o]) : 0.0f;
  for (int n0 = 0; n0 < n_tok; n0 += NC) {
    const int nc = min(NC, n_tok - n0);
    float acc[NC];
    warp_row_dot(w + (int64_t)o * u_in, a + (int64_t)n0 * u_in, u_in, nc, acc);
    if (lane < nc)
      out[(int64_t)(n0 + lane) * u_out + o] = from_f32<T>(pick_lane(acc, lane) + b);
  }
}

template <typename T, typename S, bool QUANT>
void launch_qkv(const void* x, const void* w, const void* b, void* q, void* k,
                void* v, int n, int u, int heads, int d, int dp,
                cudaStream_t s) {
  qkv_kernel<T, S, QUANT><<<3 * heads, QKV_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(q), static_cast<S*>(k),
      static_cast<S*>(v), n, u, heads, d, dp);
}

template <typename T>
int dispatch_store(int store_dtype, const void* x, const void* w,
                   const void* b, void* q, void* k, void* v, int n, int u,
                   int heads, int d, int dp, cudaStream_t s) {
  switch (store_dtype) {
    case kI8: launch_qkv<T, int8_t, true>(x, w, b, q, k, v, n, u, heads, d, dp, s); break;
    case kF32: launch_qkv<T, float, false>(x, w, b, q, k, v, n, u, heads, d, dp, s); break;
    case kBF16:
      launch_qkv<T, __nv_bfloat16, false>(x, w, b, q, k, v, n, u, heads, d, dp, s);
      break;
    case kF16: launch_qkv<T, __half, false>(x, w, b, q, k, v, n, u, heads, d, dp, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" int mxt_qkv_project(const void* x, const void* w_qkv,
                               const void* b_qkv, void* q, void* k_store,
                               void* v_store, int n, int u, int heads,
                               int dtype, int store_dtype, void* stream) {
  if (n <= 0) return 0;
  const int d = heads > 0 ? u / heads : 0;
  if (heads <= 0 || u % heads || d > MAX_D) return (int)cudaErrorInvalidValue;
  const int dp = store_dtype == kI8 ? d + 4 : d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case kF32:
      err = dispatch_store<float>(store_dtype, x, w_qkv, b_qkv, q, k_store,
                                  v_store, n, u, heads, d, dp, s);
      break;
    case kBF16:
      err = dispatch_store<__nv_bfloat16>(store_dtype, x, w_qkv, b_qkv, q,
                                          k_store, v_store, n, u, heads, d,
                                          dp, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

extern "C" int mxt_out_project(const void* a, const void* w_out,
                               const void* b_out, void* out, int n, int u_in,
                               int u_out, int dtype, void* stream) {
  if (n <= 0 || u_out <= 0) return 0;
  const int warps = OUT_THREADS / 32;
  const int blocks = (u_out + warps - 1) / warps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      out_kernel<float><<<blocks, OUT_THREADS, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(w_out),
          static_cast<const float*>(b_out), static_cast<float*>(out), n, u_in,
          u_out);
      break;
    case kBF16:
      out_kernel<__nv_bfloat16><<<blocks, OUT_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const __nv_bfloat16*>(w_out),
          static_cast<const __nv_bfloat16*>(b_out),
          static_cast<__nv_bfloat16*>(out), n, u_in, u_out);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
