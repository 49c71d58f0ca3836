// K2 — row LayerNorm forward, and K2r — row RMSNorm forward, for Hopper.
//
// K2 replaces `_ln_kernel` (mxnet_tpu/ops/pallas/layer_norm.py:32, reached
// through fused_layer_norm -> _run_norm). Computes, per row of an (N, D)
// input, mean and the centred variance in f32, then
// y = (x - mean) * rstd * gamma + beta, and also writes mean and rstd
// (f32, (N,)) for the training slice's backward.
//
// K2r replaces `_rms_kernel` (layer_norm.py:50, reached through
// fused_rms_norm -> _rms_fwd -> _run_norm): ms = sum(x^2) / D in f32,
// rstd = 1 / sqrt(ms + eps), y = x * rstd * gamma computed in f32 and
// rounded once to the input dtype; rstd (f32, (N,)) is written for the
// backward. One block per row, one reduction.
//
// Bound on this card: bytes. Each element is read once and written once
// (the row lives in registers between the two reductions), so at the
// decode shape (8, 768) the kernel is launch-bound, at the prefill shape
// (1024, 768) it moves 6.3 MB and at the train shape (8192, 768) 50.4 MB.
// K2 has two routes, chosen by the row's shape (ops/kernels/layer_norm.py
// ln_route):
// - ln_fwd_warp_kernel: one warp per row, for rows of 16-byte multiples
//   on 16-byte-aligned storage with D <= 1024. The row lives in registers
//   as 16-byte vectors (lane-strided: vector j on lane j % 32), gamma and
//   beta are loaded before the first reduction so that their latency
//   overlaps the row's, and the mean and the centred variance are two
//   warp sums: no shared memory and no block barrier. A block holds
//   LN_WARPS warps and walks the rows with a grid stride, so gamma and
//   beta are read once per warp.
// - ln_fwd_kernel: one block per row, every other row (D <= 8192).
// The TPU's (8, 128) row and column padding (`_pad_rows` / `_pad_cols`)
// has no counterpart here.
#include "common.cuh"

namespace {

constexpr int VPT = 8;  // elements per thread: D <= 8 * 1024 = 8192
constexpr int LN_WARPS = 4;        // rows in flight per block, warp route
constexpr int LN_WARP_MAX_D = 1024;

// The warp route: VPL 16-byte vectors a lane at most (D * itemsize <=
// VPL * 512 bytes).
template <typename T, int VPL>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   const T* __restrict__ beta, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int64_t n, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int nvec = d / V;
  float g[VPL][V], b[VPL][V];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int j = lane + 32 * k;
    if (j < nvec) {
      load16(gamma + j * V, g[k]);
      load16(beta + j * V, b[k]);
    }
  }
  for (int64_t row = (int64_t)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
       row < n; row += (int64_t)gridDim.x * LN_WARPS) {
    const T* xr = x + row * d;
    float v[VPL][V];
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int j = lane + 32 * k;
      if (j < nvec) {
        load16(xr + j * V, v[k]);
#pragma unroll
        for (int e = 0; e < V; ++e) s += v[k][e];
      }
    }
    const float mean = warp_sum(s) / (float)d;
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (lane + 32 * k < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float c = v[k][e] - mean;
          v[k][e] = c;
          ss += c * c;
        }
      }
    }
    const float var = warp_sum(ss) / (float)d;
    // correctly rounded sqrt and divide (no rsqrtf approximation)
    const float rstd = 1.0f / sqrtf(var + eps);
    T* yr = y + row * d;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int j = lane + 32 * k;
      if (j < nvec) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float yn = v[k][e] * rstd;
          o[e] = yn * g[k][e] + b[k][e];
        }
        store16(yr + j * V, o);
      }
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

template <typename T>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const T* __restrict__ gamma,
                              const T* __restrict__ beta, T* __restrict__ y,
                              float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int d,
                              float eps) {
  __shared__ float scratch[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float v[VPT];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    v[k] = i < d ? to_f32(xr[i]) : 0.0f;
    s += v[k];
  }
  const float mean = block_reduce(s, scratch, false) / (float)d;
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    const float c = i < d ? v[k] - mean : 0.0f;
    v[k] = c;
    ss += c * c;
  }
  const float var = block_reduce(ss, scratch, false) / (float)d;
  // correctly rounded sqrt and divide (no rsqrtf approximation)
  const float rstd = 1.0f / sqrtf(var + eps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < d) {
      const float yn = v[k] * rstd;
      yr[i] = from_f32<T>(yn * to_f32(gamma[i]) + to_f32(beta[i]));
    }
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
__global__ void rms_fwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ gamma,
                               T* __restrict__ y,
                               float* __restrict__ rstd_out, int d,
                               float eps) {
  __shared__ float scratch[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float v[VPT];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    v[k] = i < d ? to_f32(xr[i]) : 0.0f;
    ss += v[k] * v[k];
  }
  const float ms = block_reduce(ss, scratch, false) / (float)d;
  // correctly rounded sqrt and divide (no rsqrtf approximation)
  const float rstd = 1.0f / sqrtf(ms + eps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < d) yr[i] = from_f32<T>(v[k] * rstd * to_f32(gamma[i]));
  }
  if (threadIdx.x == 0) rstd_out[row] = rstd;
}

// one thread per VPT elements of a row, whole warps, at most 1024
int row_threads(int d) {
  int threads = (d + VPT - 1) / VPT;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  return threads;
}

template <typename T>
void launch(const void* x, const void* g, const void* b, void* y, void* mean,
            void* rstd, int64_t n, int d, float eps, cudaStream_t stream) {
  ln_fwd_kernel<T><<<(unsigned)n, row_threads(d), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), d, eps);
}

// enough blocks to fill the card once (LN_WARPS rows each), at most one
// per LN_WARPS rows; the warps walk the rest with a grid stride
template <typename T, int VPL>
int launch_warp(const void* x, const void* g, const void* b, void* y,
                void* mean, void* rstd, int64_t n, int d, float eps,
                cudaStream_t stream) {
  auto kernel = ln_fwd_warp_kernel<T, VPL>;
  // resident blocks per SM: a property of the kernel, asked once
  static const int per_sm = [] {
    int v = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &v, ln_fwd_warp_kernel<T, VPL>, LN_WARPS * 32, 0);
    return v > 0 ? v : 1;
  }();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return (int)err;
  const int64_t want = (n + LN_WARPS - 1) / LN_WARPS;
  const int64_t full = (int64_t)sms * per_sm;
  kernel<<<(unsigned)(want < full ? want : full), LN_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), n, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_warp(const void* x, const void* g, const void* b, void* y,
                  void* mean, void* rstd, int64_t n, int d, float eps,
                  cudaStream_t s) {
  // at most LN_WARP_MAX_D * itemsize / 512 vectors a lane: 8 in f32, 4 in
  // bf16
  const int vpl = ((d * (int)sizeof(T)) / 16 + 31) / 32;
  if (vpl <= 1) return launch_warp<T, 1>(x, g, b, y, mean, rstd, n, d, eps, s);
  if (vpl <= 2) return launch_warp<T, 2>(x, g, b, y, mean, rstd, n, d, eps, s);
  if (vpl <= 3) return launch_warp<T, 3>(x, g, b, y, mean, rstd, n, d, eps, s);
  if constexpr (sizeof(T) == 4) {
    if (vpl <= 4) return launch_warp<T, 4>(x, g, b, y, mean, rstd, n, d, eps, s);
    if (vpl <= 6) return launch_warp<T, 6>(x, g, b, y, mean, rstd, n, d, eps, s);
    return launch_warp<T, 8>(x, g, b, y, mean, rstd, n, d, eps, s);
  } else {
    return launch_warp<T, 4>(x, g, b, y, mean, rstd, n, d, eps, s);
  }
}

template <typename T>
void launch_rms(const void* x, const void* g, void* y, void* rstd, int64_t n,
                int d, float eps, cudaStream_t stream) {
  rms_fwd_kernel<T><<<(unsigned)n, row_threads(d), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(y),
      static_cast<float*>(rstd), d, eps);
}

}  // namespace

extern "C" int mxt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int64_t n, int d, float eps,
                                  int dtype, void* stream) {
  if (n <= 0) return 0;
  if (d < 1 || d > VPT * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch<float>(x, gamma, beta, y, mean, rstd, n, d, eps, s); break;
    case kBF16:
      launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, d, eps, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2's warp route: rows of 16-byte multiples, D <= 1024, every pointer
// 16-byte aligned (the wrapper checks; ops/kernels/layer_norm.py ln_route)
extern "C" int mxt_layer_norm_fwd_warp(const void* x, const void* gamma,
                                       const void* beta, void* y, void* mean,
                                       void* rstd, int64_t n, int d,
                                       float eps, int dtype, void* stream) {
  if (n <= 0) return 0;
  const int item = dtype == kF32 ? 4 : 2;
  if (d < 1 || d > LN_WARP_MAX_D || (d * item) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_warp<float>(x, gamma, beta, y, mean, rstd, n, d, eps, s);
    case kBF16:
      return dispatch_warp<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, d,
                                          eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mxt_rms_norm_fwd(const void* x, const void* gamma, void* y,
                                void* rstd, int64_t n, int d, float eps,
                                int dtype, void* stream) {
  if (n <= 0) return 0;
  if (d < 1 || d > VPT * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch_rms<float>(x, gamma, y, rstd, n, d, eps, s); break;
    case kBF16:
      launch_rms<__nv_bfloat16>(x, gamma, y, rstd, n, d, eps, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
