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
// backward. The same one-block-per-row design as K2 with one reduction
// instead of two.
//
// Bound on this card: bytes. Each element is read once and written once
// (the row lives in registers between the two reductions), so at the
// decode shape (8, 768) the kernel is launch-bound and at the prefill
// shape (1024, 768) it moves 6.3 MB. Design: one block per row, each
// thread holds up to VPT elements in registers; the TPU's (8, 128) row
// and column padding (`_pad_rows` / `_pad_cols`) has no counterpart here.
#include "common.cuh"

namespace {

constexpr int VPT = 8;  // elements per thread: D <= 8 * 1024 = 8192

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
