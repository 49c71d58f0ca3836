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
// Why 3xTF32. The port is held to its plain f32 version to 1e-5 of the
// largest magnitude. One TF32 pass keeps 10 mantissa bits (about 1e-3
// relative) and fails that. Each f32 operand x splits in registers into
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
//   the rows of the next product's A operand. The accumulator layout of
//   m16n8 is not the A layout of m16n8k8, but it is one up to an order of
//   the contraction index: thread (g, t) holds columns 2t and 2t + 1, and
//   the A fragment wants columns t and t + 4. The kernels take logical
//   column t to be key 2t and t + 4 to be key 2t + 1, and load the B
//   operand in the same order, so p and dS become A operands in place,
//   with no shuffle and no trip through shared memory. (For bf16's
//   m16n8k16 the two layouts agree as they are.)
// - Shared tiles keep a row stride of D + 4 floats (D + 8 bf16 values):
//   4 words mod 32, so `ldmatrix` of the row-wise operands and the
//   column-wise loads (rows 2t and 2t + 1, column g) are both free of
//   bank conflicts. bf16's column-wise operand comes from
//   `ldmatrix.trans`.
// - Blocks start in order of blockIdx.x, then .y: x is the head, y the
//   tile, longest causal tile first, so every head's long tiles go first
//   and the short ones fill the tail (a fifth faster than heads first).
// - Rows whose byte width is no multiple of 16 (bf16 D = 36, f32 D = 33)
//   are staged by plain loads in the same kernel; pad columns are zeroed
//   once. Causal tiles wholly above the diagonal are not visited. No
//   atomics: every output element is summed by one thread in a fixed
//   order, so results are bitwise repeatable.
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int BWD_ROWS = 64;       // rows a block owns: 4 warps x 16
constexpr int BWD_THREADS = 128;

__device__ __forceinline__ bool live(int qpos, int kpos, int lq, int lk,
                                     int causal) {
  return qpos < lq && kpos < lk && (!causal || kpos <= qpos + (lk - lq));
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

// Stage rows [r0, r0 + n) of a (rows, d) matrix, d <= DP, into an n x LD
// tile of T:
// 16-byte cp.async copies when a row is a whole number of 16-byte chunks
// (rows past `rows` zero-filled), else plain loads. Columns >= d are left
// as they are (zeroed once at the start).
template <typename T, int DP, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int r0, int n, int rows, int d,
                                           bool vec) {
  constexpr int PER = 16 / sizeof(T);
  if (vec && d == DP) {
    // rows of the full width: chunk index arithmetic by shifts (a merged
    // loop that skips chunks past d spilled registers in K1d, 5% slower)
    constexpr int CPR = DP / PER;
#pragma unroll 4
    for (int i = threadIdx.x; i < n * CPR; i += BWD_THREADS) {
      const int r = i / CPR, c = (i % CPR) * PER;
      const bool ok = r0 + r < rows;
      cp_async16(dst + r * LD + c, src + (ok ? (int64_t)(r0 + r) * d + c : 0),
                 ok ? 16 : 0);
    }
  } else if (vec) {
    const int cpr = d / PER;  // chunks per row
    for (int i = threadIdx.x; i < n * cpr; i += BWD_THREADS) {
      const int r = i / cpr, c = (i - r * cpr) * PER;
      const bool ok = r0 + r < rows;
      cp_async16(dst + r * LD + c, src + (ok ? (int64_t)(r0 + r) * d + c : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n * d; i += BWD_THREADS) {
      const int r = i / d, c = i - r * d;
      dst[r * LD + c] = r0 + r < rows ? src[(int64_t)(r0 + r) * d + c]
                                      : from_f32<T>(0.0f);
    }
  }
}

// ---- tensor-core fragments ------------------------------------------------
//
// Lane = 4 g + t. An m16n8 accumulator c[4] holds rows (g, g, g+8, g+8)
// and columns (2t, 2t+1, 2t, 2t+1) of its 16 x 8 tile. Each Ops type
// loads the A operand (16 rows x KS of a row-major tile) and the B
// operand of two n-tiles from a row-major [n][k] tile, both with
// `ldmatrix` (a 32-bit value is two 16-bit halves of one row), the B
// operand from a row-major [k][n] tile in the contraction order of
// a_from_c, and multiplies.

// four 8 x 16-byte matrices; lane L gives the address of row L % 8 of
// matrix L / 8
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// rows r0 .. r0 + 15, 16 bytes from column k0 (H = 16 bytes in elements):
// matrices (rows +0, cols +0), (+8, +0), (+0, +H), (+8, +H)
template <typename T, int LD>
__device__ __forceinline__ const T* a_addr(const T* s, int r0, int k0,
                                           int lane) {
  constexpr int H = 16 / sizeof(T);
  return s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + k0 +
         (lane >> 4) * H;
}
// rows n0 .. n0 + 15 (two n-tiles): matrices (+0, +0), (+0, +H), (+8, +0),
// (+8, +H), so registers 0, 1 are the first n-tile's b0, b1
template <typename T, int LD>
__device__ __forceinline__ const T* b2_addr(const T* s, int n0, int k0,
                                            int lane) {
  constexpr int H = 16 / sizeof(T);
  return s + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
         ((lane >> 3) & 1) * H;
}

struct OpsF32 {
  using T = float;
  static constexpr int KS = 8;
  static constexpr int PAD = 4;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  // hi = x with the low 13 bits cleared; lo = x - hi is exact in f32 and
  // the tensor core reads its top 11 bits
  static __device__ __forceinline__ void split(uint32_t x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = x & 0xffffe000u;
    lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
  }
  template <int LD>
  static __device__ __forceinline__ A load_a(const float* s, int r0, int k0,
                                             int lane) {
    uint32_t r[4];
    ldsm_x4(a_addr<float, LD>(s, r0, k0, lane), r);
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(r[i], a.hi[i], a.lo[i]);
    return a;
  }
  template <int LD>
  static __device__ __forceinline__ void load_b2(const float* s, int n0,
                                                 int k0, int lane, B& b0,
                                                 B& b1) {
    uint32_t r[4];
    ldsm_x4(b2_addr<float, LD>(s, n0, k0, lane), r);
    split(r[0], b0.hi[0], b0.lo[0]);
    split(r[1], b0.hi[1], b0.lo[1]);
    split(r[2], b1.hi[0], b1.lo[0]);
    split(r[3], b1.hi[1], b1.lo[1]);
  }
  // logical k index t is row k0 + 2t, t + 4 is row k0 + 2t + 1
  template <int LD>
  static __device__ __forceinline__ B load_b_col(const float* s, int k0,
                                                 int n0, int lane) {
    const float* p = s + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
    B b;
    split(__float_as_uint(p[0]), b.hi[0], b.lo[0]);
    split(__float_as_uint(p[LD]), b.hi[1], b.lo[1]);
    return b;
  }
  // accumulator tile ks (columns 8 ks .. 8 ks + 7) as the A operand of a
  // product contracting over those columns, in load_b_col's order
  template <int N>
  static __device__ __forceinline__ A a_from_c(const float (&c)[N][4],
                                               int ks) {
    A a;
    split(__float_as_uint(c[ks][0]), a.hi[0], a.lo[0]);
    split(__float_as_uint(c[ks][2]), a.hi[1], a.lo[1]);
    split(__float_as_uint(c[ks][1]), a.hi[2], a.lo[2]);
    split(__float_as_uint(c[ks][3]), a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ void mma1(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
  // 3xTF32: the two small cross terms first, then hi.hi
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma1(c, a.lo, b.hi);
    mma1(c, a.hi, b.lo);
    mma1(c, a.hi, b.hi);
  }
  // Two k-steps into a long-running sum. The tensor core adds to its f32
  // accumulator by truncating, so over the 384 products of a 1024-row
  // contraction the error would grow one way; each pair of k-steps is
  // summed from zero and then added with a rounding FADD.
  static __device__ __forceinline__ void mma_into(float (&c)[4], const A& a0,
                                                  const B& b0, const A& a1,
                                                  const B& b1) {
    float t[4];
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
        : "r"(a0.lo[0]), "r"(a0.lo[1]), "r"(a0.lo[2]), "r"(a0.lo[3]),
          "r"(b0.hi[0]), "r"(b0.hi[1]), "f"(0.0f));
    mma1(t, a0.hi, b0.lo);
    mma1(t, a0.hi, b0.hi);
    mma(t, a1, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += t[e];
  }
};

struct OpsBF16 {
  using T = __nv_bfloat16;
  static constexpr int KS = 16;
  static constexpr int PAD = 8;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // nearest even
    return *reinterpret_cast<uint32_t*>(&v);
  }
  template <int LD>
  static __device__ __forceinline__ A load_a(const T* s, int r0, int k0,
                                             int lane) {
    A a;
    ldsm_x4(a_addr<T, LD>(s, r0, k0, lane), a.r);
    return a;
  }
  template <int LD>
  static __device__ __forceinline__ void load_b2(const T* s, int n0, int k0,
                                                 int lane, B& b0, B& b1) {
    uint32_t r[4];
    ldsm_x4(b2_addr<T, LD>(s, n0, k0, lane), r);
    b0 = {{r[0], r[1]}};
    b1 = {{r[2], r[3]}};
  }
  // rows k0 .. k0 + 15, columns n0 .. n0 + 7: two 8 x 8 matrices read
  // transposed; lanes 0-15 give the row addresses
  template <int LD>
  static __device__ __forceinline__ B load_b_col(const T* s, int k0, int n0,
                                                 int lane) {
    const unsigned addr = static_cast<unsigned>(
        __cvta_generic_to_shared(s + (k0 + (lane & 15)) * LD + n0));
    B b;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(b.r[0]), "=r"(b.r[1])
        : "r"(addr));
    return b;
  }
  // accumulator tiles 2 ks and 2 ks + 1 as one k16 A operand, each value
  // rounded to bf16 as the TPU kernels round p and dS
  template <int N>
  static __device__ __forceinline__ A a_from_c(const float (&c)[N][4],
                                               int ks) {
    return {{pack(c[2 * ks][0], c[2 * ks][1]),
             pack(c[2 * ks][2], c[2 * ks][3]),
             pack(c[2 * ks + 1][0], c[2 * ks + 1][1]),
             pack(c[2 * ks + 1][2], c[2 * ks + 1][3])}};
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]),
          "r"(b.r[0]), "r"(b.r[1]));
  }
  // bf16's tolerance leaves room for the truncating accumulator
  static __device__ __forceinline__ void mma_into(float (&c)[4], const A& a0,
                                                  const B& b0, const A& a1,
                                                  const B& b1) {
    mma(c, a0, b0);
    mma(c, a1, b1);
  }
};

template <typename T> struct OpsOf;
template <> struct OpsOf<float> { using type = OpsF32; };
template <> struct OpsOf<__nv_bfloat16> { using type = OpsBF16; };

// width of the streamed tiles, depth of their ring, and blocks per SM
// (shared memory and registers allow 3 at D <= 64, 1 at D <= 128)
template <int DP> struct Tile {
  static constexpr int N = 32;
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = DP <= 64 ? 3 : 1;
};

constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the SFU alone (relative error about 2^-22; results below 2^-126
// flush to 0): 3% faster in f32 and 9% in bf16 than exp2f, same errors
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
}

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

// acc[jd] += C (16 x 8N, in registers) . X (8N x DP, row-major tile x_s)
template <typename Ops, int DP, int LD, int N>
__device__ __forceinline__ void c_times_tile(const float (&c)[N][4],
                                             const typename Ops::T* x_s,
                                             int lane,
                                             float (&acc)[DP / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < 8 * N / Ops::KS; ks += 2) {
    const auto a0 = Ops::a_from_c(c, ks);
    const auto a1 = Ops::a_from_c(c, ks + 1);
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd)
      Ops::mma_into(
          acc[jd], a0,
          Ops::template load_b_col<LD>(x_s, ks * Ops::KS, 8 * jd, lane), a1,
          Ops::template load_b_col<LD>(x_s, (ks + 1) * Ops::KS, 8 * jd,
                                       lane));
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(BWD_THREADS, Tile<DP>::MIN_BLOCKS)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const T* __restrict__ g, const float* __restrict__ lse,
                       T* __restrict__ dq, float* __restrict__ delta, int lq,
                       int lk, int d, int causal, float scale, int vec) {
  using Ops = typename OpsOf<T>::type;
  constexpr int LD = DP + Ops::PAD, BN = Tile<DP>::N, NT = BN / 8;
  constexpr int NS = Tile<DP>::STAGES;
  extern __shared__ float4 bwd_smem[];
  T* q_s = reinterpret_cast<T*>(bwd_smem);
  T* g_s = q_s + BWD_ROWS * LD;
  T* kv_s = g_s + BWD_ROWS * LD;  // [stage][K, V][BN][LD]
  float* dl_s = reinterpret_cast<float*>(kv_s + 2 * NS * BN * LD);
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5);
  const int n_q = (lq + BWD_ROWS - 1) / BWD_ROWS;
  // blocks start in order of blockIdx.x, then .y: every head's longest
  // causal tile goes first and the shortest last
  const int q0 = (n_q - 1 - (int)blockIdx.y) * BWD_ROWS;
  const int64_t bh = blockIdx.x;
  const T* kb = k + bh * lk * d;
  const T* vb = v + bh * lk * d;
  if (d < DP) {  // pad columns read as zeros
    const int n16 = (2 * BWD_ROWS + 2 * NS * BN) * LD * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += BWD_THREADS)
      bwd_smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
  int n_k = (lk + BN - 1) / BN;
  if (causal) {
    const int last = min(q0 + BWD_ROWS, lq) - 1 + (lk - lq);
    n_k = last < 0 ? 0 : min(n_k, last / BN + 1);
  }
  stage_rows<T, DP, LD>(q_s, q + bh * lq * d, q0, BWD_ROWS, lq, d, vec);
  stage_rows<T, DP, LD>(g_s, g + bh * lq * d, q0, BWD_ROWS, lq, d, vec);
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

template <typename T, int DP>
__global__ void __launch_bounds__(BWD_THREADS, Tile<DP>::MIN_BLOCKS)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int lq, int lk, int d,
                        int causal, float scale, int vec) {
  using Ops = typename OpsOf<T>::type;
  constexpr int LD = DP + Ops::PAD, BN = Tile<DP>::N, NT = BN / 8;
  constexpr int NS = Tile<DP>::STAGES;
  extern __shared__ float4 bwd_smem[];
  T* k_s = reinterpret_cast<T*>(bwd_smem);
  T* v_s = k_s + BWD_ROWS * LD;
  T* qg_s = v_s + BWD_ROWS * LD;  // [stage][Q, dO][BN][LD]
  // [stage][lse, D][BN]
  float* vec_s = reinterpret_cast<float*>(qg_s + 2 * NS * BN * LD);
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5);
  // causal: early k tiles are longest, and start first for every head
  const int k0 = blockIdx.y * BWD_ROWS;
  const int64_t bh = blockIdx.x;
  const T* qb = q + bh * lq * d;
  const T* gb = g + bh * lq * d;
  const float* lb = lse + bh * lq;
  const float* db = delta + bh * lq;
  if (d < DP) {
    const int n16 = (2 * BWD_ROWS + 2 * NS * BN) * LD * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += BWD_THREADS)
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
    for (int i = threadIdx.x; i < 2 * BN; i += BWD_THREADS) {
      const int row = qt * BN + (i % BN);
      const float* src = i < BN ? lb : db;
      cp_async4(vs + i, src + (row < lq ? row : 0), row < lq ? 4 : 0);
    }
  };
  stage_rows<T, DP, LD>(k_s, k + bh * lk * d, k0, BWD_ROWS, lk, d, vec);
  stage_rows<T, DP, LD>(v_s, v + bh * lk * d, k0, BWD_ROWS, lk, d, vec);
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
template <typename T, int DP>
constexpr size_t bwd_smem_bytes(bool dkv) {
  using Ops = typename OpsOf<T>::type;
  constexpr int LD = DP + Ops::PAD, BN = Tile<DP>::N, NS = Tile<DP>::STAGES;
  return (size_t)(2 * BWD_ROWS + 2 * NS * BN) * LD * sizeof(T) +
         (dkv ? 2 * NS * BN : BWD_ROWS) * sizeof(float);
}

// rows go by 16-byte cp.async when each is a whole number of 16-byte
// chunks and every staged matrix starts on a 16-byte boundary
template <typename T>
bool rows_vec(int d, std::initializer_list<const void*> ptrs) {
  bool ok = (d * sizeof(T)) % 16 == 0;
  for (const void* p : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return ok;
}

template <typename K>
cudaError_t prepare(K kern, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int DP>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* g, const void* lse, void* dq, void* delta, int bh,
           int lq, int lk, int d, int causal, float scale, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<T, DP>(false);
  auto kern = flash_bwd_dq_tc_kernel<T, DP>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bh, (lq + BWD_ROWS - 1) / BWD_ROWS);
  kern<<<grid, BWD_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), lq, lk, d, causal,
      scale, (int)rows_vec<T>(d, {q, k, v, g}));
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int bwd_dkv(const void* q, const void* k, const void* v, const void* g,
            const void* lse, const void* delta, void* dk, void* dv, int bh,
            int lq, int lk, int d, int causal, float scale, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<T, DP>(true);
  auto kern = flash_bwd_dkv_tc_kernel<T, DP>;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bh, (lk + BWD_ROWS - 1) / BWD_ROWS);
  kern<<<grid, BWD_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), lq, lk, d, causal, scale,
      (int)rows_vec<T>(d, {q, k, v, g}));
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int lq, int lk, int d) {
  return bh < 1 || bh > 65535 || lq < 1 || lk < 1 || d < 1 || d > 128;
}

}  // namespace

// Each entry takes its DP (64 or 128) from d; d <= 64 zero-pads to 64.
#define BWD_DISPATCH(FN, ...)                                           \
  switch (dtype) {                                                      \
    case kF32:                                                          \
      return d <= 64 ? FN<float, 64>(__VA_ARGS__)                       \
                     : FN<float, 128>(__VA_ARGS__);                     \
    case kBF16:                                                         \
      return d <= 64 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)               \
                     : FN<__nv_bfloat16, 128>(__VA_ARGS__);             \
    default: return (int)cudaErrorInvalidValue;                         \
  }

extern "C" int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* g, const void* lse,
                                void* dq, void* delta, int bh, int lq, int lk,
                                int d, int causal, float scale, int dtype,
                                void* stream) {
  if (bad_shape(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BWD_DISPATCH(bwd_dq, q, k, v, o, g, lse, dq, delta, bh, lq, lk, d, causal,
               scale, s)
}

extern "C" int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int lq, int lk, int d, int causal,
                                 float scale, int dtype, void* stream) {
  if (bad_shape(bh, lq, lk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BWD_DISPATCH(bwd_dkv, q, k, v, g, lse, delta, dk, dv, bh, lq, lk, d,
               causal, scale, s)
}
