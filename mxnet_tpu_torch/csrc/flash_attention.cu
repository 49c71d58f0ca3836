// K1 — flash attention forward on Hopper's tensor cores. Its FA2 backward
// (K1c, K1d) is in flash_attention_bwd.cu; the two share flash_mma.cuh.
//
// Replaces two TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py:
// `_flash_kernel` (K1a, :70) and `_flash_kernel_resident` (K1b, :144),
// both reached through `_flash_forward` (:264). The two TPU bodies
// compute the same function and differ only in how K/V reach VMEM
// (streamed per grid step, or the whole head resident). On Hopper one
// kernel serves both: K/V tiles stream through shared memory by a loop
// inside the block, whatever the length.
//
// Layout (B*H, L, D), contiguous, f32 or bf16, 1 <= D <= 128. The mask is
// bottom-right causal, k <= q + (Lk - Lq), with the finite -1e30 of the
// TPU kernels; rows and keys past the ragged edge are masked here (the
// TPU padded to a block). A row with no live key gives out = 0 and
// lse = -1e30 (the `l == 0` guard), as K1a does; lse = m + log(l).
//
// Bound on this card, f32 at B8 H12 L1024 D64 causal: operations. The
// forward does 2 products over the causal half (12.9 GFLOP) and moves
// about 0.1 GB (0.03 ms). On the FMA units (67 TFLOP/s f32) that is
// 0.19 ms, where the previous design of this kernel ran; on the tensor
// cores in three TF32 passes (495 TFLOP/s each) 0.078 ms. In the one
// pass of the default matmul policy the operations take 0.026 ms and the
// bytes bound it, at 0.030 ms.
//
// Design: the dQ kernel of the backward with an online softmax in place
// of its dS step.
// - A block owns 64 q rows (4 warps x 16). K and V stream in
//   Tile<DP>::N-row tiles through the two-stage `cp.async` ring of
//   `stage_rows`, so tile t + 1 loads while tile t multiplies.
// - S = Q.K^T by `mma.sync`: f32 in three TF32 passes (hi.hi + hi.lo +
//   lo.hi, `OpsF32`) under the `high`/`highest` matmul policy, in one
//   (`OpsTF32`, each operand rounded by `cvt.rna`) under `default`; bf16
//   in one m16n8k16 pass. Q's A fragments are
//   loaded from shared memory (and split) per tile: a first build that
//   kept them in registers across the K loop ran 7% slower in f32.
// - The online softmax runs on the accumulator in registers. Thread (g, t)
//   holds rows g and g + 8 of its warp's 16: the row max is two quad
//   shuffles, the row sum is kept per thread and summed over the quad
//   once at the end. Scores are taken in units of log2 (scale folded with
//   log2 e) and exponentiated by the SFU (`exp2_approx`). The accumulator
//   is rescaled by alpha once per tile.
// - O += P.V by `c_times_tile`: p becomes the A operand in place
//   (`a_from_c`, rounded to bf16 first in bf16, as the TPU kernels round
//   p), V is read column-wise (`load_b_col`, `ldmatrix.trans` in bf16),
//   and each pair of k-steps is added by a rounding FADD (`mma_into`).
// - Heads are the fast grid axis and each head's longest causal tile
//   starts first; tiles wholly above the diagonal are not visited. No
//   atomics: each output element is summed by one thread in a fixed
//   order, so results are bitwise repeatable.
#include "flash_mma.cuh"

namespace {

// width of the streamed K/V tiles
template <int DP> constexpr int FWD_N = Tile<DP>::N;

constexpr float LN2 = 0.6931471805599453f;

template <typename T, int DP, bool ONE_PASS>
__global__ void __launch_bounds__(FA_THREADS, Tile<DP>::MIN_BLOCKS)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, int lq, int lk, int d,
                    int causal, float scale, int vec) {
  using Ops = typename OpsOf<T, ONE_PASS>::type;
  constexpr int LD = DP + Ops::PAD, BN = FWD_N<DP>, NT = BN / 8;
  constexpr int NS = Tile<DP>::STAGES, KSTEPS = DP / Ops::KS;
  extern __shared__ float4 fwd_smem[];
  T* q_s = reinterpret_cast<T*>(fwd_smem);
  T* kv_s = q_s + FA_ROWS * LD;  // [stage][K, V][BN][LD]
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5);
  const int n_q = (lq + FA_ROWS - 1) / FA_ROWS;
  // blocks start in order of blockIdx.x, then .y: every head's longest
  // causal tile goes first and the shortest last
  const int q0 = (n_q - 1 - (int)blockIdx.y) * FA_ROWS;
  const int64_t bh = blockIdx.x;
  const T* kb = k + bh * lk * d;
  const T* vb = v + bh * lk * d;
  if (d < DP) {  // pad columns read as zeros
    const int n16 = (FA_ROWS + 2 * NS * BN) * LD * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += FA_THREADS)
      fwd_smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
  int n_k = (lk + BN - 1) / BN;
  if (causal) {
    const int last = min(q0 + FA_ROWS, lq) - 1 + (lk - lq);
    n_k = last < 0 ? 0 : min(n_k, last / BN + 1);
  }
  stage_rows<T, DP, LD>(q_s, q + bh * lq * d, q0, FA_ROWS, lq, d, vec);
  cp_async_commit();
  // the ring: K and V tile kt in slot kt % NS, NS - 1 tiles ahead
  auto stage = [&](int kt) {
    T* dst = kv_s + (kt % NS) * 2 * BN * LD;
    stage_rows<T, DP, LD>(dst, kb, kt * BN, BN, lk, d, vec);
    stage_rows<T, DP, LD>(dst + BN * LD, vb, kt * BN, BN, lk, d, vec);
  };
#pragma unroll
  for (int kt = 0; kt < NS - 1; ++kt) {
    if (kt < n_k) stage(kt);
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();  // Q is in
  __syncthreads();
  // scores in units of log2: x = s scale log2(e), p = 2^(x - m)
  const float scale2 = scale * LOG2E;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f};
  float acc[DP / 8][4];
  zero(acc);
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + NS - 1 < n_k) stage(kt + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // tile kt is in
    __syncthreads();
    const T* k_s = kv_s + (kt % NS) * 2 * BN * LD;
    const T* v_s = k_s + BN * LD;
    const int k0 = kt * BN;
    float s[NT][4];
    zero(s);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const auto a = Ops::template load_a<LD>(q_s, r0, ks * Ops::KS, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        typename Ops::B y0, y1;
        Ops::template load_b2<LD>(k_s, 8 * j, ks * Ops::KS, lane, y0, y1);
        Ops::mma(s[j], a, y0);
        Ops::mma(s[j + 1], a, y1);
      }
    }
    // every pair of this warp's 16 rows and the tile's keys is live
    const bool full = q0 + r0 + 16 <= lq && k0 + BN <= lk &&
                      (!causal || k0 + BN - 1 <= q0 + r0 + (lk - lq));
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qpos = q0 + r0 + (lane >> 2) + 8 * h;
        const int kpos = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        s[j][e] = full || live(qpos, kpos, lq, lk, causal)
                      ? s[j][e] * scale2
                      : NEG_BIG;
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2_approx(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        // masked keys give p = 0, also in a row that has seen no key
        const float p = s[j][e] > NEG_BIG ? exp2_approx(s[j][e] - m[h])
                                          : 0.0f;
        l[h] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] *= alpha[e >> 1];
    c_times_tile<Ops, DP, LD>(s, v_s, lane, acc);
    __syncthreads();  // every warp is done with this stage
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int row = q0 + r0 + (lane >> 2) + 8 * h;
      const int col = 8 * jd + 2 * (lane & 3) + (e & 1);
      const float denom = l[h] == 0.0f ? 1.0f : l[h];
      if (row < lq && col < d)
        out[(bh * lq + row) * d + col] = from_f32<T>(acc[jd][e] / denom);
    }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + (lane >> 2) + 8 * h;
      if (row < lq)
        lse[bh * lq + row] =
            l[h] == 0.0f ? NEG_BIG : m[h] * LN2 + logf(l[h]);
    }
  }
}

// shared bytes: the block's 64 q rows and the ring's stages of K and V
template <typename T, int DP, bool ONE_PASS>
constexpr size_t fwd_smem_bytes() {
  using Ops = typename OpsOf<T, ONE_PASS>::type;
  constexpr int LD = DP + Ops::PAD;
  return (size_t)(FA_ROWS + 2 * Tile<DP>::STAGES * FWD_N<DP>) * LD *
         sizeof(T);
}

template <typename T, int DP, bool ONE_PASS>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int bh, int lq, int lk, int d, int causal, float scale,
        cudaStream_t s) {
  const size_t smem = fwd_smem_bytes<T, DP, ONE_PASS>();
  auto kern = flash_fwd_tc_kernel<T, DP, ONE_PASS>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bh, (lq + FA_ROWS - 1) / FA_ROWS);
  kern<<<grid, FA_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), lq, lk, d, causal, scale,
      (int)rows_vec<T>(d, {q, k, v}));
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry takes its DP (64 or 128) from d; d <= 64 zero-pads to 64.
// f32 multiplies in one TF32 pass when one_pass is set (the default
// policy), else in three; bf16 ignores it.
#define FA_DISPATCH(FN, ...)                                            \
  switch (dtype) {                                                      \
    case kF32:                                                          \
      if (one_pass)                                                     \
        return d <= 64 ? FN<float, 64, true>(__VA_ARGS__)               \
                       : FN<float, 128, true>(__VA_ARGS__);             \
      return d <= 64 ? FN<float, 64, false>(__VA_ARGS__)                \
                     : FN<float, 128, false>(__VA_ARGS__);              \
    case kBF16:                                                         \
      return d <= 64 ? FN<__nv_bfloat16, 64, false>(__VA_ARGS__)        \
                     : FN<__nv_bfloat16, 128, false>(__VA_ARGS__);      \
    default: return (int)cudaErrorInvalidValue;                         \
  }

extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int lq, int lk,
                             int d, int causal, float scale, int dtype,
                             int one_pass, void* stream) {
  if (bad_shape(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(fwd, q, k, v, out, lse, bh, lq, lk, d, causal, scale, s)
}
