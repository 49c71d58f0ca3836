// K1 — flash attention forward and its FA2 backward (dQ, then dK/dV) for
// Hopper.
//
// Replaces three TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py:
// - `_flash_kernel` (K1a, :70) and `_flash_kernel_resident` (K1b, :144),
//   both reached through `_flash_forward` (:264). The two TPU bodies
//   compute the same function and differ only in how K/V reach VMEM
//   (streamed per grid step, or the whole head resident). On Hopper one
//   kernel serves both: K/V tiles are staged through shared memory by a
//   loop inside the block, whatever the length.
// - `_bwd_dq_kernel` (K1c, :379) and `_bwd_dkv_kernel` (K1d, :432), both
//   reached through `_flash_bwd_pallas` (:490).
//
// Layout (B*H, L, D), contiguous, f32 or bf16; D <= 128. The mask is
// bottom-right causal, k <= q + (Lk - Lq), with the finite -1e30 of the
// TPU kernels; rows and keys past the ragged edge are masked here (the
// TPU padded to a block). A row with no live key gives out = 0 and
// lse = -1e30 (the `l == 0` guard), as K1a does.
//
// Bound on this card, f32 at B8 H12 L1024 D64 causal: operations. The
// forward does 2 products over the causal half (12.9 GFLOP, 0.19 ms at
// 67 TFLOP/s f32), dQ 3 (0.29 ms), dK/dV 4 (0.39 ms); each moves about
// 0.1 GB (0.03 ms). f32 runs on the FMA units (no TF32, so the reference
// arithmetic holds); bf16 operands are widened to f32, which is exact,
// and accumulate in f32, with p rounded to bf16 before P.V and dV and ds
// before dQ and dK, as the TPU kernels and `pair_grads` (:730) round.
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
// scratch carried m / l / acc (or dq, dk, dv) across grid steps, becomes
// the loop inside the block; nothing carries between blocks and nothing
// is accumulated with atomics, so results are deterministic.
// D = rowsum(dO * O) is computed once, by the dQ kernel (as K1c does),
// and written out for the dK/dV kernel, which K1d instead recomputed per
// block from dO and O.
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

template <typename T, int DP>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta, int lq,
                    int lk, int d, int causal, float scale) {
  extern __shared__ float4 fa_smem[];
  float* q_s = reinterpret_cast<float*>(fa_smem);
  float* g_s = q_s + FA_T * (DP + 4);
  float* k_s = g_s + FA_T * (DP + 4);
  float* v_s = k_s + FA_T * (DP + 4);
  float* ds_s = v_s + FA_T * (DP + 4);
  float* lse_s = ds_s + FA_T * FA_PS;
  float* dl_s = lse_s + FA_T;
  constexpr int OC = DP / 16;
  const int n_q = (lq + FA_T - 1) / FA_T;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * FA_T;
  const int64_t bh = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + bh * lk * d;
  const T* vb = v + bh * lk * d;
  load_tile<T, DP>(q_s, q + bh * lq * d, q0, lq, d);
  load_tile<T, DP>(g_s, g + bh * lq * d, q0, lq, d);
  load_tile<T, DP>(k_s, o + bh * lq * d, q0, lq, d);  // O, for D only
  __syncthreads();
  {
    // D = rowsum(dO * O) in f32: four threads per row
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    float sum = 0.0f;
    for (int c = part; c < DP; c += 4)
      sum = fmaf(g_s[r * (DP + 4) + c], k_s[r * (DP + 4) + c], sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      const int row = q0 + r;
      dl_s[r] = sum;
      lse_s[r] = row < lq ? lse[bh * lq + row] : 0.0f;
      if (row < lq) delta[bh * lq + row] = sum;
    }
  }
  float acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  const int n_k = live_k_tiles(q0, lq, lk, causal);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * FA_T;
    __syncthreads();  // O (first pass) or the previous tile is read
    load_tile<T, DP>(k_s, kb, k0, lk, d);
    load_tile<T, DP>(v_s, vb, k0, lk, d);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abT<DP>(q_s, k_s, ty, tx, s);
    tile_abT<DP>(g_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = live(q0 + r, k0 + tx + 16 * j, lq, lk, causal);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.0f;
        const float ds = p * (dp[i][j] - dl_s[r]) * scale;
        ds_s[r * FA_PS + tx + 16 * j] = as_operand<T>(ds);
      }
    }
    __syncthreads();
    tile_pv<DP>(ds_s, k_s, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= lq) continue;
    T* drow = dq + (bh * lq + row) * d;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = 64 * (c / 4) + 4 * tx + (c % 4);
      if (col < d) drow[col] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int lq, int lk, int d, int causal,
                     float scale) {
  extern __shared__ float4 fa_smem[];
  float* k_s = reinterpret_cast<float*>(fa_smem);
  float* v_s = k_s + FA_T * (DP + 4);
  float* q_s = v_s + FA_T * (DP + 4);
  float* g_s = q_s + FA_T * (DP + 4);
  float* p_s = g_s + FA_T * (DP + 4);
  float* ds_s = p_s + FA_T * FA_PS;
  float* lse_s = ds_s + FA_T * FA_PS;
  float* dl_s = lse_s + FA_T;
  constexpr int OC = DP / 16;
  const int k0 = blockIdx.x * FA_T;  // causal: early k tiles are longest
  const int64_t bh = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + bh * lq * d;
  const T* gb = g + bh * lq * d;
  load_tile<T, DP>(k_s, k + bh * lk * d, k0, lk, d);
  load_tile<T, DP>(v_s, v + bh * lk * d, k0, lk, d);
  float adk[4][OC], adv[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) adk[i][c] = adv[i][c] = 0.0f;
  // causal: the first q tile holding a row that sees key k0
  int qt = 0;
  if (causal) {
    const int first = k0 - (lk - lq);
    qt = first > 0 ? first / FA_T : 0;
  }
  const int n_q = (lq + FA_T - 1) / FA_T;
  for (; qt < n_q; ++qt) {
    const int q0 = qt * FA_T;
    __syncthreads();  // the previous tile's products have read q_s, g_s
    load_tile<T, DP>(q_s, qb, q0, lq, d);
    load_tile<T, DP>(g_s, gb, q0, lq, d);
    if (threadIdx.x < FA_T) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < lq ? lse[bh * lq + row] : 0.0f;
      dl_s[threadIdx.x] = row < lq ? delta[bh * lq + row] : 0.0f;
    }
    __syncthreads();
    // transposed scores: rows are keys (ty + 16 i), columns queries
    float s[4][4], dp[4][4];
    tile_abT<DP>(k_s, q_s, ty, tx, s);
    tile_abT<DP>(v_s, g_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const bool ok = live(q0 + qc, k0 + kr, lq, lk, causal);
        const float p = ok ? expf(s[i][j] * scale - lse_s[qc]) : 0.0f;
        const float ds = p * (dp[i][j] - dl_s[qc]) * scale;
        p_s[kr * FA_PS + qc] = as_operand<T>(p);
        ds_s[kr * FA_PS + qc] = as_operand<T>(ds);
      }
    }
    __syncthreads();
    tile_pv<DP>(p_s, g_s, ty, tx, adv);
    tile_pv<DP>(ds_s, q_s, ty, tx, adk);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= lk) continue;
    T* krow = dk + (bh * lk + row) * d;
    T* vrow = dv + (bh * lk + row) * d;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = 64 * (c / 4) + 4 * tx + (c % 4);
      if (col < d) {
        krow[col] = from_f32<T>(adk[i][c]);
        vrow[col] = from_f32<T>(adv[i][c]);
      }
    }
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

template <typename T, int DP>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* g, const void* lse, void* dq, void* delta, int bh,
           int lq, int lk, int d, int causal, float scale, cudaStream_t s) {
  const size_t smem =
      (4 * tile_floats(DP) + FA_T * FA_PS + 2 * FA_T) * sizeof(float);
  auto kern = flash_bwd_dq_kernel<T, DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((lq + FA_T - 1) / FA_T, bh);
  kern<<<grid, FA_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), lq, lk, d, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int bwd_dkv(const void* q, const void* k, const void* v, const void* g,
            const void* lse, const void* delta, void* dk, void* dv, int bh,
            int lq, int lk, int d, int causal, float scale, cudaStream_t s) {
  const size_t smem =
      (4 * tile_floats(DP) + 2 * FA_T * FA_PS + 2 * FA_T) * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((lk + FA_T - 1) / FA_T, bh);
  kern<<<grid, FA_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), lq, lk, d, causal, scale);
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

extern "C" int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* g, const void* lse,
                                void* dq, void* delta, int bh, int lq, int lk,
                                int d, int causal, float scale, int dtype,
                                void* stream) {
  if (bad_shape(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(bwd_dq, q, k, v, o, g, lse, dq, delta, bh, lq, lk, d, causal,
              scale, s)
}

extern "C" int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int lq, int lk, int d, int causal,
                                 float scale, int dtype, void* stream) {
  if (bad_shape(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(bwd_dkv, q, k, v, g, lse, delta, dk, dv, bh, lq, lk, d, causal,
              scale, s)
}
