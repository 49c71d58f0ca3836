// K1c and K1d — the FA2 backward of flash attention (dQ, then dK/dV) on
// Hopper's tensor cores.
//
// Replaces two TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py,
// both reached through `_flash_bwd_pallas` (:490):
// - `_bwd_dq_kernel` (K1c, :379): dQ, and D = rowsum(dO * O), which
//   this kernel also writes out for the next one;
// - `_bwd_dkv_kernel` (K1d, :432): dK and dV, reading that D (K1d
//   recomputed it per block).
//
// Layout (B*H, L, D), contiguous, f32 or bf16, 1 <= D <= 128; the mask
// is bottom-right causal, k <= q + (Lk - Lq), rows and keys past the
// ragged edge are masked here, and a row that sees no key (lse = -1e30)
// gets p = 0. dS = p * (dP - D) * scale, as `pair_grads` (:730) forms it.
//
// Bound on this card at the train step's (8, 12, 1024, 64) causal f32:
// operations. dQ does 3 products over the causal half (19.3 GFLOP), dK/dV
// 4 (25.8 GFLOP); each moves about 0.15 GB (0.045 ms at 3.35 TB/s). On
// the FMA units (67 TFLOP/s f32) that is 0.289 + 0.385 ms; the kernels of
// the previous design ran there. On the tensor cores in three TF32
// passes (495 TFLOP/s each) it is 0.117 + 0.156 ms.
//
// Two f32 routes, chosen per launch by the matmul policy (the wrapper
// reads torch's live CUDA matmul switch, as the reference's
// `_matmul_precision`, :39, reads the ambient JAX precision): one TF32
// pass under `default` (each operand rounded to nearest by `cvt.rna`,
// as cuBLAS rounds; there dQ's 0.039 ms of operations fall under its
// 0.045 ms of bytes, and dK/dV's bound is 0.052 ms of operations), three
// under `high`/`highest`.
//
// Why 3xTF32 under `highest`. There the port is held to its plain f32
// version to 1e-5 of the largest magnitude. One TF32 pass keeps 10
// mantissa bits (about 1e-3 relative) and fails that. Each f32 operand x splits in registers into
// hi = x with its low 13 bits cleared (a TF32 value) and lo = x - hi,
// exact in f32, whose top 11 bits the tensor core reads. a * b =
// hi.hi + hi.lo + lo.hi drops lo.lo and lo's cut bits, about 2^-20 of
// the product: 2e-7 to 4e-6 of the largest magnitude on the card's
// checks. PyTorch's f32 efficient-attention kernels take the same road
// (CUTLASS's OpMultiplyAddFastF32). bf16 operands go to `m16n8k16 .bf16`
// in one pass; p and dS are rounded to bf16 before their products, as
// the TPU kernels round them, and every sum is f32. The tensor core adds
// to its f32 accumulator by truncating: over a 1024-row contraction that
// error grows one way (1.4e-5 of dK/dV's largest value in a first build),
// so the dQ, dK and dV products are summed per two k-steps from zero and
// added to the running sum by a rounding FADD.
//
// Design.
// - `mma.sync` (m16n8k8 .tf32, m16n8k16 .bf16), not `wgmma`: its
//   fragments load from shared memory in any pattern, so the three
//   products that contract over the sequence axis (dQ = dS.K,
//   dK = dS^T.Q, dV = P^T.dO) read K, Q and dO where they lie, with no
//   transposed copy; TF32 `wgmma` takes only K-major operands and would
//   need transposed hi/lo tiles in shared memory.
// - A block owns 64 rows (4 warps x 16): q rows in K1c, key rows in
//   K1d. The other side streams in 32-row tiles through a two-stage ring
//   of 16-byte `cp.async` copies (lse and D by 4-byte ones), so tile t+1
//   loads while tile t multiplies. 32-row tiles keep a block at 70 KB of
//   shared memory and about 168 registers a thread, so three blocks
//   (12 warps) share an SM at D <= 64. In trial builds 64-row tiles (two
//   blocks), a third stage, rounding hi to nearest instead of cutting
//   it, and splitting each streamed tile once per block into hi and lo
//   planes in shared memory (two blocks per SM) were all slower.
// - The scores stay in registers. K1d computes them transposed
//   (S^T = K.Q^T, rows are keys), so in both kernels the score rows are
//   the rows of the next product's A operand, which the accumulator
//   becomes in place (`a_from_c`; the column order and the bank-free
//   tile strides are described in flash_mma.cuh, shared with K1's
//   forward).
// - Blocks start in order of blockIdx.x, then .y: x is the head, y the
//   tile, longest causal tile first, so every head's long tiles go first
//   and the short ones fill the tail (a fifth faster than heads first).
// - Rows whose byte width is no multiple of 16 (bf16 D = 36, f32 D = 33)
//   are staged by plain loads in the same kernel; pad columns are zeroed
//   once. Causal tiles wholly above the diagonal are not visited. No
//   atomics: every output element is summed by one thread in a fixed
//   order, so results are bitwise repeatable.
#include "flash_mma.cuh"

namespace {

// The two score products of a tile, both contracting over all DP columns:
// c1[j] += a1[r0 .. r0 + 15] . b1[8 j .. 8 j + 7]^T, and c2 from a2, b2
template <typename Ops, int DP, int LD, int N>
__device__ __forceinline__ void score_pair(
    const typename Ops::T* a1, const typename Ops::T* b1,
    const typename Ops::T* a2, const typename Ops::T* b2, int r0, int lane,
    float (&c1)[N][4], float (&c2)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < DP; kk += Ops::KS) {
    const auto x1 = Ops::template load_a<LD>(a1, r0, kk, lane);
    const auto x2 = Ops::template load_a<LD>(a2, r0, kk, lane);
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      typename Ops::B y0, y1;
      Ops::template load_b2<LD>(b1, 8 * j, kk, lane, y0, y1);
      Ops::mma(c1[j], x1, y0);
      Ops::mma(c1[j + 1], x1, y1);
      Ops::template load_b2<LD>(b2, 8 * j, kk, lane, y0, y1);
      Ops::mma(c2[j], x2, y0);
      Ops::mma(c2[j + 1], x2, y1);
    }
  }
}

template <typename T, int DP, bool ONE_PASS>
__global__ void __launch_bounds__(FA_THREADS, Tile<DP>::MIN_BLOCKS)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const T* __restrict__ g, const float* __restrict__ lse,
                       T* __restrict__ dq, float* __restrict__ delta, int lq,
                       int lk, int d, int causal, float scale, int vec) {
  using Ops = typename OpsOf<T, ONE_PASS>::type;
  constexpr int LD = DP + Ops::PAD, BN = Tile<DP>::N, NT = BN / 8;
  constexpr int NS = Tile<DP>::STAGES;
  extern __shared__ float4 bwd_smem[];
  T* q_s = reinterpret_cast<T*>(bwd_smem);
  T* g_s = q_s + FA_ROWS * LD;
  T* kv_s = g_s + FA_ROWS * LD;  // [stage][K, V][BN][LD]
  float* dl_s = reinterpret_cast<float*>(kv_s + 2 * NS * BN * LD);
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5);
  const int n_q = (lq + FA_ROWS - 1) / FA_ROWS;
  // blocks start in order of blockIdx.x, then .y: every head's longest
  // causal tile goes first and the shortest last
  const int q0 = (n_q - 1 - (int)blockIdx.y) * FA_ROWS;
  const int64_t bh = blockIdx.x;
  const T* kb = k + bh * lk * d;
  const T* vb = v + bh * lk * d;
  if (d < DP) {  // pad columns read as zeros
    const int n16 = (2 * FA_ROWS + 2 * NS * BN) * LD * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += FA_THREADS)
      bwd_smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
  int n_k = (lk + BN - 1) / BN;
  if (causal) {
    const int last = min(q0 + FA_ROWS, lq) - 1 + (lk - lq);
    n_k = last < 0 ? 0 : min(n_k, last / BN + 1);
  }
  stage_rows<T, DP, LD>(q_s, q + bh * lq * d, q0, FA_ROWS, lq, d, vec);
  stage_rows<T, DP, LD>(g_s, g + bh * lq * d, q0, FA_ROWS, lq, d, vec);
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
  cp_async_wait<NS - 1>();  // Q and dO are in
  __syncthreads();
  {
    // D = rowsum(dO * O) in f32, two threads per row
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = q0 + r;
    float sum = 0.0f;
    if (row < lq) {
      const T* orow = o + (bh * lq + row) * d;
      for (int c = half; c < d; c += 2)
        sum = fmaf(to_f32(g_s[r * LD + c]), to_f32(orow[c]), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      dl_s[r] = sum;
      if (row < lq) delta[bh * lq + row] = sum;
    }
  }
  __syncthreads();
  // p = exp(s scale - lse) = exp2(s scale log2e - lse log2e)
  const float scale2 = scale * LOG2E;
  float row_lse[2], row_dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (lane >> 2) + 8 * h;
    row_dl[h] = dl_s[r];
    row_lse[h] = q0 + r < lq ? lse[bh * lq + q0 + r] * LOG2E : 0.0f;
  }
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
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    score_pair<Ops, DP, LD>(q_s, k_s, g_s, v_s, r0, lane, s, dp);
    // every pair of this warp's 16 rows and the tile's keys is live
    const bool full = q0 + r0 + 16 <= lq && k0 + BN <= lk &&
                      (!causal || k0 + BN - 1 <= q0 + r0 + (lk - lq));
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qpos = q0 + r0 + (lane >> 2) + 8 * h;
        const int kpos = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        const float p = full || live(qpos, kpos, lq, lk, causal)
                            ? exp2_approx(fmaf(s[j][e], scale2, -row_lse[h]))
                            : 0.0f;
        s[j][e] = p * (dp[j][e] - row_dl[h]) * scale;  // dS
      }
    c_times_tile<Ops, DP, LD>(s, k_s, lane, acc);
    __syncthreads();  // every warp is done with this stage
  }
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + r0 + (lane >> 2) + 8 * (e >> 1);
      const int col = 8 * jd + 2 * (lane & 3) + (e & 1);
      if (row < lq && col < d)
        dq[(bh * lq + row) * d + col] = from_f32<T>(acc[jd][e]);
    }
}

template <typename T, int DP, bool ONE_PASS>
__global__ void __launch_bounds__(FA_THREADS, Tile<DP>::MIN_BLOCKS)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int lq, int lk, int d,
                        int causal, float scale, int vec) {
  using Ops = typename OpsOf<T, ONE_PASS>::type;
  constexpr int LD = DP + Ops::PAD, BN = Tile<DP>::N, NT = BN / 8;
  constexpr int NS = Tile<DP>::STAGES;
  extern __shared__ float4 bwd_smem[];
  T* k_s = reinterpret_cast<T*>(bwd_smem);
  T* v_s = k_s + FA_ROWS * LD;
  T* qg_s = v_s + FA_ROWS * LD;  // [stage][Q, dO][BN][LD]
  // [stage][lse, D][BN]
  float* vec_s = reinterpret_cast<float*>(qg_s + 2 * NS * BN * LD);
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5);
  // causal: early k tiles are longest, and start first for every head
  const int k0 = blockIdx.y * FA_ROWS;
  const int64_t bh = blockIdx.x;
  const T* qb = q + bh * lq * d;
  const T* gb = g + bh * lq * d;
  const float* lb = lse + bh * lq;
  const float* db = delta + bh * lq;
  if (d < DP) {
    const int n16 = (2 * FA_ROWS + 2 * NS * BN) * LD * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += FA_THREADS)
      bwd_smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
  // causal: the first q tile holding a row that sees key k0
  int qt0 = 0;
  if (causal) {
    const int first = k0 - (lk - lq);
    qt0 = first > 0 ? first / BN : 0;
  }
  const int n_q = (lq + BN - 1) / BN;
  const float scale2 = scale * LOG2E;  // p = exp2(s scale2 - lse log2e)
  // the ring: Q, dO, lse and D of q tile qt in slot qt % NS, NS - 1
  // tiles ahead (rows past lq read as 0)
  auto stage = [&](int qt) {
    T* dst = qg_s + (qt % NS) * 2 * BN * LD;
    stage_rows<T, DP, LD>(dst, qb, qt * BN, BN, lq, d, vec);
    stage_rows<T, DP, LD>(dst + BN * LD, gb, qt * BN, BN, lq, d, vec);
    float* vs = vec_s + (qt % NS) * 2 * BN;
    for (int i = threadIdx.x; i < 2 * BN; i += FA_THREADS) {
      const int row = qt * BN + (i % BN);
      const float* src = i < BN ? lb : db;
      cp_async4(vs + i, src + (row < lq ? row : 0), row < lq ? 4 : 0);
    }
  };
  stage_rows<T, DP, LD>(k_s, k + bh * lk * d, k0, FA_ROWS, lk, d, vec);
  stage_rows<T, DP, LD>(v_s, v + bh * lk * d, k0, FA_ROWS, lk, d, vec);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (qt0 + i < n_q) stage(qt0 + i);
    cp_async_commit();
  }
  float adk[DP / 8][4], adv[DP / 8][4];
  zero(adk);
  zero(adv);
  for (int qt = qt0; qt < n_q; ++qt) {
    if (qt + NS - 1 < n_q) stage(qt + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // K, V and tile qt are in
    __syncthreads();
    const T* q_s = qg_s + (qt % NS) * 2 * BN * LD;
    const T* g_s = q_s + BN * LD;
    const float* l_s = vec_s + (qt % NS) * 2 * BN;
    const float* dl_s = l_s + BN;
    const int q0 = qt * BN;
    // transposed scores: rows are this warp's 16 keys, columns queries
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    score_pair<Ops, DP, LD>(k_s, q_s, v_s, g_s, r0, lane, s, dp);
    // every pair of the tile's queries and this warp's 16 keys is live
    const bool full = q0 + BN <= lq && k0 + r0 + 16 <= lk &&
                      (!causal || k0 + r0 + 15 <= q0 + (lk - lq));
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * (lane & 3) + (e & 1);
        const int kpos = k0 + r0 + (lane >> 2) + 8 * (e >> 1);
        const float p = full || live(q0 + qc, kpos, lq, lk, causal)
                            ? exp2_approx(fmaf(s[j][e], scale2,
                                         -l_s[qc] * LOG2E))
                            : 0.0f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl_s[qc]) * scale;  // dS^T
      }
    c_times_tile<Ops, DP, LD>(s, g_s, lane, adv);   // dV += P^T dO
    c_times_tile<Ops, DP, LD>(dp, q_s, lane, adk);  // dK += dS^T Q
    __syncthreads();
  }
  cp_async_wait<0>();  // no copy outlives the block (no q tile to visit)
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + r0 + (lane >> 2) + 8 * (e >> 1);
      const int col = 8 * jd + 2 * (lane & 3) + (e & 1);
      if (row < lk && col < d) {
        dk[(bh * lk + row) * d + col] = from_f32<T>(adk[jd][e]);
        dv[(bh * lk + row) * d + col] = from_f32<T>(adv[jd][e]);
      }
    }
}

// shared bytes: the block's two 64-row tiles, the ring's 2 stages of two
// tiles, and the f32 vectors (K1c: D of its 64 rows; K1d: lse and D of
// each stage)
template <typename T, int DP, bool ONE_PASS>
constexpr size_t bwd_smem_bytes(bool dkv) {
  using Ops = typename OpsOf<T, ONE_PASS>::type;
  constexpr int LD = DP + Ops::PAD, BN = Tile<DP>::N, NS = Tile<DP>::STAGES;
  return (size_t)(2 * FA_ROWS + 2 * NS * BN) * LD * sizeof(T) +
         (dkv ? 2 * NS * BN : FA_ROWS) * sizeof(float);
}

template <typename T, int DP, bool ONE_PASS>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* g, const void* lse, void* dq, void* delta, int bh,
           int lq, int lk, int d, int causal, float scale, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<T, DP, ONE_PASS>(false);
  auto kern = flash_bwd_dq_tc_kernel<T, DP, ONE_PASS>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bh, (lq + FA_ROWS - 1) / FA_ROWS);
  kern<<<grid, FA_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), lq, lk, d, causal,
      scale, (int)rows_vec<T>(d, {q, k, v, g}));
  return (int)cudaGetLastError();
}

template <typename T, int DP, bool ONE_PASS>
int bwd_dkv(const void* q, const void* k, const void* v, const void* g,
            const void* lse, const void* delta, void* dk, void* dv, int bh,
            int lq, int lk, int d, int causal, float scale, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<T, DP, ONE_PASS>(true);
  auto kern = flash_bwd_dkv_tc_kernel<T, DP, ONE_PASS>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bh, (lk + FA_ROWS - 1) / FA_ROWS);
  kern<<<grid, FA_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), lq, lk, d, causal, scale,
      (int)rows_vec<T>(d, {q, k, v, g}));
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry takes its DP (64 or 128) from d; d <= 64 zero-pads to 64.
// f32 multiplies in one TF32 pass when one_pass is set (the default
// policy), else in three; bf16 ignores it.
#define BWD_DISPATCH(FN, ...)                                           \
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

extern "C" int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* g, const void* lse,
                                void* dq, void* delta, int bh, int lq, int lk,
                                int d, int causal, float scale, int dtype,
                                int one_pass, void* stream) {
  if (bad_shape(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BWD_DISPATCH(bwd_dq, q, k, v, o, g, lse, dq, delta, bh, lq, lk, d, causal,
               scale, s)
}

extern "C" int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int lq, int lk, int d, int causal,
                                 float scale, int dtype, int one_pass,
                                 void* stream) {
  if (bad_shape(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BWD_DISPATCH(bwd_dkv, q, k, v, g, lse, delta, dk, dv, bh, lq, lk, d,
               causal, scale, s)
}
