// Building blocks of the flash-attention kernels on Hopper's tensor
// cores, shared by the forward (K1a/K1b, flash_attention.cu) and the
// FA2 backward (K1c/K1d, flash_attention_bwd.cu).
//
// - A block has FA_THREADS = 128 threads, 4 warps, and owns FA_ROWS = 64
//   rows, 16 a warp; the other side streams through shared memory in
//   Tile<DP>::N-row tiles, a two-stage ring of 16-byte `cp.async` copies
//   (`stage_rows`), so tile t + 1 loads while tile t multiplies.
// - Products are `mma.sync` m16n8k8 TF32 or m16n8k16 bf16 (`OpsF32`,
//   `OpsTF32`, `OpsBF16`). Under the full-f32 policy an f32 operand x
//   splits in registers into hi = x with its low 13 bits cleared (a TF32
//   value) and lo = x - hi (exact), and a * b = hi.hi + hi.lo + lo.hi
//   (3xTF32, `OpsF32`), about 2^-20 of the product off. Under the
//   default policy (one pass, as the reference's kernel dots run at
//   DEFAULT) each f32 operand is rounded once to TF32 by `cvt.rna`, as
//   cuBLAS rounds, and multiplied in one pass (`OpsTF32`), about 2^-11
//   of the product off.
// - The m16n8 accumulator layout is the m16n8k8 A layout up to an order
//   of the contraction index: thread (g, t) (lane 4 g + t) holds columns
//   2t and 2t + 1, and the A fragment wants columns t and t + 4. Logical
//   column t is taken to be key 2t and t + 4 key 2t + 1, and the B
//   operand is loaded in that order (`load_b_col`), so a score tile in
//   registers becomes an A operand in place (`a_from_c`). For bf16's
//   m16n8k16 the two layouts agree as they are.
// - The tensor core adds to its f32 accumulator by truncating, so a sum
//   over a long contraction drifts one way: `mma_into` sums each pair of
//   k-steps from zero and adds it to the running sum with a rounding FADD.
// - Shared tiles keep a row stride of D + 4 floats (D + 8 bf16 values):
//   `ldmatrix` of row-wise operands and the column-wise loads are both
//   free of bank conflicts.
#pragma once

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int FA_ROWS = 64;       // rows a block owns: 4 warps x 16
constexpr int FA_THREADS = 128;
constexpr float NEG_BIG = -1e30f; // finite: -inf breaks the online carry

__device__ __forceinline__ bool live(int qpos, int kpos, int lq, int lk,
                                     int causal) {
  return qpos < lq && kpos < lk && (!causal || kpos <= qpos + (lk - lq));
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
    for (int i = threadIdx.x; i < n * CPR; i += FA_THREADS) {
      const int r = i / CPR, c = (i % CPR) * PER;
      const bool ok = r0 + r < rows;
      cp_async16(dst + r * LD + c, src + (ok ? (int64_t)(r0 + r) * d + c : 0),
                 ok ? 16 : 0);
    }
  } else if (vec) {
    const int cpr = d / PER;  // chunks per row
    for (int i = threadIdx.x; i < n * cpr; i += FA_THREADS) {
      const int r = i / cpr, c = (i - r * cpr) * PER;
      const bool ok = r0 + r < rows;
      cp_async16(dst + r * LD + c, src + (ok ? (int64_t)(r0 + r) * d + c : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n * d; i += FA_THREADS) {
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

// One TF32 pass: each f32 operand rounded to nearest (ties away from
// zero) to TF32, one m16n8k8 per product
struct OpsTF32 {
  using T = float;
  static constexpr int KS = 8;
  static constexpr int PAD = 4;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  static __device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t y;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
    return y;
  }
  static __device__ __forceinline__ uint32_t tf32(uint32_t x) {
    return tf32(__uint_as_float(x));
  }
  template <int LD>
  static __device__ __forceinline__ A load_a(const float* s, int r0, int k0,
                                             int lane) {
    A a;
    ldsm_x4(a_addr<float, LD>(s, r0, k0, lane), a.r);
#pragma unroll
    for (int i = 0; i < 4; ++i) a.r[i] = tf32(a.r[i]);
    return a;
  }
  template <int LD>
  static __device__ __forceinline__ void load_b2(const float* s, int n0,
                                                 int k0, int lane, B& b0,
                                                 B& b1) {
    uint32_t r[4];
    ldsm_x4(b2_addr<float, LD>(s, n0, k0, lane), r);
    b0 = {{tf32(r[0]), tf32(r[1])}};
    b1 = {{tf32(r[2]), tf32(r[3])}};
  }
  // logical k index t is row k0 + 2t, t + 4 is row k0 + 2t + 1
  template <int LD>
  static __device__ __forceinline__ B load_b_col(const float* s, int k0,
                                                 int n0, int lane) {
    const float* p = s + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
    return {{tf32(p[0]), tf32(p[LD])}};
  }
  template <int N>
  static __device__ __forceinline__ A a_from_c(const float (&c)[N][4],
                                               int ks) {
    return {{tf32(c[ks][0]), tf32(c[ks][2]), tf32(c[ks][1]),
             tf32(c[ks][3])}};
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    OpsF32::mma1(c, a.r, b.r);
  }
  // the truncating accumulator does not depend on the pass count: each
  // pair of k-steps is summed from zero and added with a rounding FADD
  static __device__ __forceinline__ void mma_into(float (&c)[4], const A& a0,
                                                  const B& b0, const A& a1,
                                                  const B& b1) {
    float t[4];
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
        : "r"(a0.r[0]), "r"(a0.r[1]), "r"(a0.r[2]), "r"(a0.r[3]),
          "r"(b0.r[0]), "r"(b0.r[1]), "f"(0.0f));
    OpsF32::mma1(t, a1.r, b1.r);
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

// the products of a kernel instantiation: T's, with ONE_PASS picking one
// TF32 pass over 3xTF32 for f32 (the default policy's route)
template <typename T, bool ONE_PASS> struct OpsOf;
template <> struct OpsOf<float, false> { using type = OpsF32; };
template <> struct OpsOf<float, true> { using type = OpsTF32; };
template <> struct OpsOf<__nv_bfloat16, false> { using type = OpsBF16; };

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

bool bad_shape(int bh, int lq, int lk, int d) {
  return bh < 1 || bh > 65535 || lq < 1 || lk < 1 || d < 1 || d > 128;
}

}  // namespace
