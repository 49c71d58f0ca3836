// K4 — paged decode attention for Hopper, split over positions.
//
// Replaces `_paged_kernel` (mxnet_tpu/ops/pallas/paged_attention.py:49,
// reached through paged_attention_kernel). One query token per
// (lane, head) attends over its KV history, which lives in fixed-size
// blocks of a shared pool addressed through the lane's block-table row;
// int8 pools are dequantized in the kernel ([D int8 | 4-byte f32 scale]
// rows, ops/nn.py kv_cache_quantize layout). The mask is the finite
// -1e30 of the TPU kernel with a max(l, 1e-30) denominator; positions at
// or past MB * bs never count, as on the TPU, whose grid visits MB blocks.
//
// Bound on this card: bytes, each live K/V row read once
// (2 * length * H * (D + 4) bytes for int8 pools: 8.1 MB, 2.4 us, at the
// decode step's mid-decode lengths, R 8, H 12, D 64).
//
// Design.
// - The grid is (R * H, S): block (rh, s) owns the span of PA_SPAN pool
//   blocks s * PA_SPAN .. of lane r's table row, so a long lane is spread
//   over many SMs instead of walking its history in one block. Blocks
//   whose span starts at or past the lane's length return at once: no
//   length is read on the host.
// - One (pool block, head) slice is bs x D' contiguous elements (16 x 68
//   bytes for int8 at D 64, a multiple of 16 that starts 16-byte
//   aligned). The span's K slices, then its V slices, stream through a
//   two-stage ring of shared memory by 16-byte `cp.async` copies,
//   neighbouring threads on neighbouring addresses, up to PA_ITEM_BYTES a
//   stage (the whole span of an int8 pool at D 64: K and V are in flight
//   together). Slices that are no multiple of 16 bytes go by plain loads.
// - Scores: a warp per position, its lanes over the features, a shuffle
//   sum. The span's softmax is exact (all its scores are known before
//   P.V). P.V: a warp per position again, each lane accumulating its
//   features in registers, and the four warps' sums added in shared
//   memory in a fixed order.
// - Merge: a lane whose live positions fit one span writes `out` directly.
//   Otherwise each span writes its partial (m, l, acc[D]) to a workspace;
//   the last block of a (lane, head) to finish (a counter, after
//   __threadfence) merges them in span order and resets the counter. So
//   results are bitwise repeatable and each call is one launch.
#include "common.cuh"

namespace {

constexpr int PA_SPAN = 8;        // pool blocks a block owns
constexpr int PA_THREADS = 128;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_MAX_D = 256;
constexpr int PA_STAGES = 2;
constexpr int PA_ITEM_BYTES = 16384;  // K or V bytes a ring stage holds
constexpr int PA_MAX_SMEM = 227 * 1024;
constexpr float NEG_BIG = -1e30f;

// one pool element as f32 (int8 values before their scale)
template <typename TP>
__device__ __forceinline__ float pool_f32(TP v) { return to_f32(v); }
template <>
__device__ __forceinline__ float pool_f32<int8_t>(int8_t v) {
  return (float)v;
}

// NF = features a lane holds: D <= 32 NF
template <typename TQ, typename TP, bool QUANT, typename TO, int NF>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TP* __restrict__ kpool,
                       const TP* __restrict__ vpool,
                       const int* __restrict__ block_table,
                       const int* __restrict__ lengths, TO* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ counters,
                       int heads, int bs, int d, int dp, int mb, int chunk,
                       int stage_bytes, int vec, float sm_scale) {
  extern __shared__ float4 pa_smem[];
  __shared__ int is_last;
  const int rh = blockIdx.x, sp = blockIdx.y, n_span = gridDim.y;
  const int r = rh / heads, h = rh % heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span_pos = PA_SPAN * bs;
  const int length = min(lengths[r], mb * bs);
  const int n_split = length > 0 ? (length + span_pos - 1) / span_pos : 0;
  if (sp >= n_split) {
    // a lane of length 0 sees no key: out = acc / max(l, 1e-30) = 0
    if (sp == 0)
      for (int i = tid; i < d; i += PA_THREADS)
        out[(int64_t)rh * d + i] = from_f32<TO>(0.0f);
    return;
  }
  const int p0 = sp * span_pos;
  const int n_pos = min(span_pos, length - p0);
  const int n_blk = (n_pos + bs - 1) / bs;
  const int n_items = (n_blk + chunk - 1) / chunk;  // of K, and of V
  const int slice = bs * dp;  // elements of one (pool block, head) slice
  char* ring = reinterpret_cast<char*>(pa_smem);
  float* s_s = reinterpret_cast<float*>(ring + PA_STAGES * stage_bytes);
  float* red_acc = s_s + span_pos;            // [PA_WARPS][d]
  float* red_l = red_acc + PA_WARPS * d;      // [PA_WARPS]
  float* red_m = red_l + PA_WARPS;            // [PA_WARPS]
  const int* bt = block_table + (int64_t)r * mb + sp * PA_SPAN;

  // ring item i: K slices [i * chunk, ...) of the span for i < n_items,
  // else the V slices of item i - n_items
  auto stage = [&](int i) {
    const bool is_v = i >= n_items;
    const int c0 = (is_v ? i - n_items : i) * chunk;
    const int nb = min(chunk, n_blk - c0);
    const TP* pool = is_v ? vpool : kpool;
    char* dst = ring + (i % PA_STAGES) * stage_bytes;
    if (vec) {
      const int cps = slice * (int)sizeof(TP) / 16;  // 16-byte chunks
      for (int c = tid; c < nb * cps; c += PA_THREADS) {
        const int jj = c / cps, w = c - jj * cps;
        const TP* src = pool + ((int64_t)bt[c0 + jj] * heads + h) * slice;
        cp_async16(dst + (int64_t)jj * slice * sizeof(TP) + 16 * w,
                   reinterpret_cast<const char*>(src) + 16 * w, 16);
      }
    } else {
      TP* dst_t = reinterpret_cast<TP*>(dst);
      for (int e = tid; e < nb * slice; e += PA_THREADS) {
        const int jj = e / slice;
        dst_t[e] = pool[((int64_t)bt[c0 + jj] * heads + h) * slice +
                        (e - jj * slice)];
      }
    }
  };
  const int total = 2 * n_items;
#pragma unroll
  for (int i = 0; i < PA_STAGES - 1; ++i) {
    if (i < total) stage(i);
    cp_async_commit();
  }
  float qf[NF], acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = lane + 32 * i;
    qf[i] = f < d ? to_f32(q[(int64_t)rh * d + f]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m_warp = NEG_BIG, l_warp = 0.0f, m = NEG_BIG;
  for (int i = 0; i < total; ++i) {
    if (i + PA_STAGES - 1 < total) stage(i + PA_STAGES - 1);
    cp_async_commit();
    cp_async_wait<PA_STAGES - 1>();  // item i is in
    __syncthreads();
    const TP* buf =
        reinterpret_cast<const TP*>(ring + (i % PA_STAGES) * stage_bytes);
    const bool is_v = i >= n_items;
    const int pos0 = (is_v ? i - n_items : i) * chunk * bs;
    const int np = min(chunk * bs, n_pos - pos0);
    // rows of an item are contiguous: position t's row is buf + t * dp
    if (!is_v) {
      for (int t = warp; t < np; t += PA_WARPS) {
        const TP* row = buf + t * dp;
        float dot = 0.0f;
#pragma unroll
        for (int k = 0; k < NF; ++k) {
          const int f = lane + 32 * k;
          if (f < d) dot = fmaf(qf[k], pool_f32<TP>(row[f]), dot);
        }
        dot = warp_sum(dot);
        if constexpr (QUANT)
          dot *= *reinterpret_cast<const float*>(row + d);
        const float sc = dot * sm_scale;
        if (lane == 0) s_s[pos0 + t] = sc;
        m_warp = fmaxf(m_warp, sc);
      }
      if (i == n_items - 1) {  // every score is in: the span's max, p
        if (lane == 0) red_m[warp] = m_warp;
        __syncthreads();
#pragma unroll
        for (int w = 0; w < PA_WARPS; ++w) m = fmaxf(m, red_m[w]);
        for (int t = tid; t < n_pos; t += PA_THREADS)
          s_s[t] = expf(s_s[t] - m);
      }
    } else {
      for (int t = warp; t < np; t += PA_WARPS) {
        const TP* row = buf + t * dp;
        const float p = s_s[pos0 + t];
        l_warp += p;
        float pw = p;
        if constexpr (QUANT) pw *= *reinterpret_cast<const float*>(row + d);
#pragma unroll
        for (int k = 0; k < NF; ++k) {
          const int f = lane + 32 * k;
          if (f < d) acc[k] = fmaf(pw, pool_f32<TP>(row[f]), acc[k]);
        }
      }
    }
    __syncthreads();  // stage i % PA_STAGES is free, s_s written
  }
  // the four warps' sums, added in a fixed order
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    const int f = lane + 32 * k;
    if (f < d) red_acc[warp * d + f] = acc[k];
  }
  if (lane == 0) red_l[warp] = l_warp;
  __syncthreads();
  float l = 0.0f;
#pragma unroll
  for (int w = 0; w < PA_WARPS; ++w) l += red_l[w];
  if (n_split == 1) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    for (int f = tid; f < d; f += PA_THREADS) {
      float a = 0.0f;
#pragma unroll
      for (int w = 0; w < PA_WARPS; ++w) a += red_acc[w * d + f];
      out[(int64_t)rh * d + f] = from_f32<TO>(a * inv);
    }
    return;
  }
  // the span's partial into the workspace: acc [R*H][S][d], then (m, l)
  // [R*H][S][2]
  float* ws_acc = ws + (int64_t)rh * n_span * d;
  float* ws_ml =
      ws + (int64_t)gridDim.x * n_span * d + (int64_t)rh * n_span * 2;
  for (int f = tid; f < d; f += PA_THREADS) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < PA_WARPS; ++w) a += red_acc[w * d + f];
    ws_acc[(int64_t)sp * d + f] = a;
  }
  if (tid == 0) {
    ws_ml[2 * sp] = m;
    ws_ml[2 * sp + 1] = l;
  }
  __threadfence();  // the partial is visible before the count
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[rh], 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last span to finish merges all n_split partials in span order
  float m_all = NEG_BIG;
  for (int s = 0; s < n_split; ++s)
    m_all = fmaxf(m_all, __ldcg(ws_ml + 2 * s));
  float l_all = 0.0f;
  for (int s = 0; s < n_split; ++s)
    l_all += __ldcg(ws_ml + 2 * s + 1) * expf(__ldcg(ws_ml + 2 * s) - m_all);
  const float inv = 1.0f / fmaxf(l_all, 1e-30f);
  for (int f = tid; f < d; f += PA_THREADS) {
    float a = 0.0f;
    for (int s = 0; s < n_split; ++s)
      a += __ldcg(ws_acc + (int64_t)s * d + f) *
           expf(__ldcg(ws_ml + 2 * s) - m_all);
    out[(int64_t)rh * d + f] = from_f32<TO>(a * inv);
  }
  if (tid == 0) counters[rh] = 0;  // ready for the next call
}

template <typename TQ, typename TP, bool QUANT, typename TO, int NF>
int launch_nf(const void* q, const void* kp, const void* vp, const int* bt,
              const int* lens, void* out, float* ws, int* counters, int rows,
              int heads, int bs, int d, int dp, int mb, float sm_scale,
              cudaStream_t stream) {
  const size_t slice_bytes = (size_t)bs * dp * sizeof(TP);
  // whole slices a ring stage holds: at least one, at most the span
  size_t fit = PA_ITEM_BYTES / slice_bytes;
  const int chunk = fit < 1 ? 1 : fit > PA_SPAN ? PA_SPAN : (int)fit;
  const size_t stage_bytes = (chunk * slice_bytes + 15) / 16 * 16;
  const size_t smem = PA_STAGES * stage_bytes +
                      (size_t)(PA_SPAN * bs + PA_WARPS * d + 2 * PA_WARPS) *
                          sizeof(float);
  if (smem > PA_MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = paged_attention_kernel<TQ, TP, QUANT, TO, NF>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = slice_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  dim3 grid(rows, (mb + PA_SPAN - 1) / PA_SPAN);
  kern<<<grid, PA_THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), bt, lens, static_cast<TO*>(out), ws,
      counters, heads, bs, d, dp, mb, chunk, (int)stage_bytes, (int)vec,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TP, bool QUANT, typename TO>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* lens, void* out, float* ws, int* counters, int rows,
           int heads, int bs, int d, int dp, int mb, float sm_scale,
           cudaStream_t s) {
  if (d <= 64)
    return launch_nf<TQ, TP, QUANT, TO, 2>(q, kp, vp, bt, lens, out, ws,
                                           counters, rows, heads, bs, d, dp,
                                           mb, sm_scale, s);
  if (d <= 128)
    return launch_nf<TQ, TP, QUANT, TO, 4>(q, kp, vp, bt, lens, out, ws,
                                           counters, rows, heads, bs, d, dp,
                                           mb, sm_scale, s);
  return launch_nf<TQ, TP, QUANT, TO, 8>(q, kp, vp, bt, lens, out, ws,
                                         counters, rows, heads, bs, d, dp, mb,
                                         sm_scale, s);
}

template <typename TQ>
int dispatch_pool(int pool_dtype, const void* q, const void* kp,
                  const void* vp, const int* bt, const int* lens, void* out,
                  float* ws, int* counters, int rows, int heads, int bs, int d,
                  int dp, int mb, float sm_scale, cudaStream_t s) {
  switch (pool_dtype) {
    // int8 pools: output in q's dtype; float pools: in the pool's dtype
    case kI8:
      return launch<TQ, int8_t, true, TQ>(q, kp, vp, bt, lens, out, ws,
                                          counters, rows, heads, bs, d, dp,
                                          mb, sm_scale, s);
    case kF32:
      return launch<TQ, float, false, float>(q, kp, vp, bt, lens, out, ws,
                                             counters, rows, heads, bs, d, dp,
                                             mb, sm_scale, s);
    case kBF16:
      return launch<TQ, __nv_bfloat16, false, __nv_bfloat16>(
          q, kp, vp, bt, lens, out, ws, counters, rows, heads, bs, d, dp, mb,
          sm_scale, s);
    case kF16:
      return launch<TQ, __half, false, __half>(q, kp, vp, bt, lens, out, ws,
                                               counters, rows, heads, bs, d,
                                               dp, mb, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The pool blocks one block of the kernel owns: the caller sizes the
// workspace, R * H * S * (D + 2) floats with S = ceil(MB / span), and
// R * H int32 counters that start at 0, from it.
extern "C" int mxt_paged_attention_span(int* span) {
  *span = PA_SPAN;
  return 0;
}

extern "C" int mxt_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* block_table,
                                   const void* lengths, void* out,
                                   void* workspace, void* counters, int r,
                                   int heads, int bs, int d, int dp, int mb,
                                   float sm_scale, int q_dtype,
                                   int pool_dtype, void* stream) {
  if (r <= 0 || heads <= 0) return 0;
  if (d < 1 || d > PA_MAX_D || bs < 1 || mb < 1 ||
      (pool_dtype == kI8 && (d % 4 || dp != d + 4)))
    return (int)cudaErrorInvalidValue;
  const int rows = r * heads;
  const int* bt = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return dispatch_pool<float>(pool_dtype, q, k_pool, v_pool, bt, lens, out,
                                  ws, cnt, rows, heads, bs, d, dp, mb,
                                  sm_scale, s);
    case kBF16:
      return dispatch_pool<__nv_bfloat16>(pool_dtype, q, k_pool, v_pool, bt,
                                          lens, out, ws, cnt, rows, heads, bs,
                                          d, dp, mb, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
