// K1 — flash attention forward for Hopper. Its FA2 backward (K1c, K1d)
// is in flash_attention_bwd.cu.
//
// Replaces two TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py:
// `_flash_kernel` (K1a, :70) and `_flash_kernel_resident` (K1b, :144),
// both reached through `_flash_forward` (:264). The two TPU bodies
// compute the same function and differ only in how K/V reach VMEM
// (streamed per grid step, or the whole head resident). On Hopper one
// kernel serves both: K/V tiles are staged through shared memory by a
// loop inside the block, whatever the length.
//
// Layout (B*H, L, D), contiguous, f32 or bf16; D <= 128. The mask is
// bottom-right causal, k <= q + (Lk - Lq), with the finite -1e30 of the
// TPU kernels; rows and keys past the ragged edge are masked here (the
// TPU padded to a block). A row with no live key gives out = 0 and
// lse = -1e30 (the `l == 0` guard), as K1a does.
//
// Bound on this card, f32 at B8 H12 L1024 D64 causal: operations. The
// forward does 2 products over the causal half (12.9 GFLOP, 0.19 ms at
// 67 TFLOP/s f32) and moves about 0.1 GB (0.03 ms). f32 runs on the FMA
// units (no TF32, so the reference arithmetic holds); bf16 operands are
// widened to f32, which is exact, and accumulate in f32, with p rounded
// to bf16 before P.V, as the TPU kernels round.
//
// Design: 64-row tiles, 256 threads per block (two blocks per SM, so
// at most 128 registers a thread), each thread owning a 4 x 4
// block of the 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and
// 4 rows of the 64 x D output. Tiles sit row-major in shared memory with a
// row stride of D + 4 floats, so every inner-loop operand is one 16-byte
// load without bank conflicts and each load feeds 16 FMAs. A row's 64
// scores live in the 16 lanes of one half-warp, so the online-softmax max
// and sum are four shuffles. Causal tiles wholly above the diagonal are
// not visited. The sequential grid axis of the TPU kernels, whose VMEM
// scratch carried m / l / acc across grid steps, becomes the loop inside
// the block; nothing carries between blocks and nothing is accumulated
// with atomics, so results are deterministic.
#include "common.cuh"

namespace {

constexpr int FA_T = 64;          // rows of a q tile and of a k tile
constexpr int FA_THREADS = 256;   // 16 x 16
constexpr int FA_PS = FA_T + 4;   // row stride of a 64 x 64 score tile
constexpr float NEG_BIG = -1e30f; // finite: -inf breaks the online carry

__device__ __forceinline__ float f4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The value a TPU kernel would feed its next product: unchanged for f32,
// rounded to bf16 (nearest even) for bf16 operands.
template <typename T>
__device__ __forceinline__ float as_operand(float v) {
  return to_f32(from_f32<T>(v));
}

// Stage rows [r0, r0 + 64) of a (rows, d) matrix into a 64 x DP f32 tile
// (row stride DP + 4), zero past `rows` and past column d.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int rows, int d) {
  for (int idx = threadIdx.x; idx < FA_T * DP; idx += FA_THREADS) {
    const int r = idx / DP, c = idx % DP;
    float v = 0.0f;
    if (r0 + r < rows && c < d) v = to_f32(src[(int64_t)(r0 + r) * d + c]);
    dst[r * (DP + 4) + c] = v;
  }
}

// acc[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c] over c < DP.
template <int DP>
__device__ __forceinline__ void tile_abT(const float* a, const float* b,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * (DP + 4) + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * (DP + 4) + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][4 c + e] += sum_k p[ty + 16 i][k] * v[k][64 c + 4 tx + e] over
// the 64 rows k of a score tile `p` (stride FA_PS) and a value tile `v`.
template <int DP>
__device__ __forceinline__ void tile_pv(const float* p, const float* v,
                                        int ty, int tx,
                                        float acc[4][DP / 16]) {
#pragma unroll 2
  for (int k = 0; k < FA_T; k += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * FA_PS + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        const float4 w = *reinterpret_cast<const float4*>(
            v + (k + kk) * (DP + 4) + 64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pk = f4(pv[i], kk);
          acc[i][4 * c + 0] = fmaf(pk, w.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pk, w.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pk, w.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pk, w.w, acc[i][4 * c + 3]);
        }
      }
    }
  }
}

// max / sum over the 16 lanes of a half-warp (one score row)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool live(int qpos, int kpos, int lq, int lk,
                                     int causal) {
  return qpos < lq && kpos < lk && (!causal || kpos <= qpos + (lk - lq));
}

// number of k tiles a q tile starting at q0 can see
__device__ __forceinline__ int live_k_tiles(int q0, int lq, int lk,
                                            int causal) {
  const int n_k = (lk + FA_T - 1) / FA_T;
  if (!causal) return n_k;
  const int last = min(q0 + FA_T, lq) - 1 + (lk - lq);  // last visible key
  return last < 0 ? 0 : min(n_k, last / FA_T + 1);
}

template <typename T, int DP>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int lq, int lk, int d, int causal,
                 float scale) {
  extern __shared__ float4 fa_smem[];
  float* q_s = reinterpret_cast<float*>(fa_smem);
  float* k_s = q_s + FA_T * (DP + 4);
  float* v_s = k_s + FA_T * (DP + 4);
  float* p_s = v_s + FA_T * (DP + 4);
  constexpr int OC = DP / 16;  // output columns per thread
  const int n_q = (lq + FA_T - 1) / FA_T;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * FA_T;  // longest rows first
  const int64_t bh = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + bh * lk * d;
  const T* vb = v + bh * lk * d;
  load_tile<T, DP>(q_s, q + bh * lq * d, q0, lq, d);

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }
  const int n_k = live_k_tiles(q0, lq, lk, causal);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * FA_T;
    __syncthreads();  // the previous tile's P.V has read k_s, v_s, p_s
    load_tile<T, DP>(k_s, kb, k0, lk, d);
    load_tile<T, DP>(v_s, vb, k0, lk, d);
    __syncthreads();
    float s[4][4];
    tile_abT<DP>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = NEG_BIG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = live(qpos, k0 + tx + 16 * j, lq, lk, causal);
        s[i][j] = ok ? s[i][j] * scale : NEG_BIG;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(rmax));
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = live(qpos, k0 + tx + 16 * j, lq, lk, causal);
        const float p = ok ? expf(s[i][j] - m_new) : 0.0f;
        rsum += p;
        p_s[(ty + 16 * i) * FA_PS + tx + 16 * j] = as_operand<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pv<DP>(p_s, v_s, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= lq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
    T* orow = out + (bh * lq + row) * d;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = 64 * (c / 4) + 4 * tx + (c % 4);
      if (col < d) orow[col] = from_f32<T>(acc[i][c] / denom);
    }
    if (tx == 0) lse[bh * lq + row] = m[i] + logf(denom);
  }
}

constexpr size_t tile_floats(int dp) { return (size_t)FA_T * (dp + 4); }

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int bh, int lq, int lk, int d, int causal, float scale,
        cudaStream_t s) {
  const size_t smem = (3 * tile_floats(DP) + FA_T * FA_PS) * sizeof(float);
  auto kern = flash_fwd_kernel<T, DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((lq + FA_T - 1) / FA_T, bh);
  kern<<<grid, FA_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), lq, lk, d, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int lq, int lk, int d) {
  return bh < 1 || bh > 65535 || lq < 1 || lk < 1 || d < 1 || d > 128;
}

}  // namespace

// Each entry takes its DP (64 or 128) from d; d <= 64 zero-pads to 64.
#define FA_DISPATCH(FN, ...)                                            \
  switch (dtype) {                                                      \
    case kF32:                                                          \
      return d <= 64 ? FN<float, 64>(__VA_ARGS__)                       \
                     : FN<float, 128>(__VA_ARGS__);                     \
    case kBF16:                                                         \
      return d <= 64 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)               \
                     : FN<__nv_bfloat16, 128>(__VA_ARGS__);             \
    default: return (int)cudaErrorInvalidValue;                         \
  }

extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int lq, int lk,
                             int d, int causal, float scale, int dtype,
                             void* stream) {
  if (bad_shape(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(fwd, q, k, v, out, lse, bh, lq, lk, d, causal, scale, s)
}
