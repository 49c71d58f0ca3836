// K4 — paged decode attention for Hopper.
//
// Replaces `_paged_kernel` (mxnet_tpu/ops/pallas/paged_attention.py:49,
// reached through paged_attention_kernel). One query token per
// (lane, head) attends over its KV history, which lives in fixed-size
// blocks of a shared pool addressed through the lane's block-table row;
// int8 pools are dequantized in the kernel ([D int8 | 4-byte f32 scale]
// rows, ops/nn.py kv_cache_quantize layout). The mask is the finite
// -1e30 of the TPU kernel with an online softmax and a max(l, 1e-30)
// denominator.
//
// Bound on this card: bytes — each live K/V row is read once
// (2 * length * H * (D + 4) bytes for int8 pools). Design:
// - one block per (lane, head); the block reads its own table row and
//   length (the TPU kernel scalar-prefetched them);
// - a loop over chunks of PA_THREADS positions inside the block replaces
//   the sequential `j` grid axis whose VMEM scratch carried m / l / acc
//   across grid steps (dimension_semantics ("parallel", "arbitrary"));
//   here m and l live in registers of every thread and acc in the
//   registers of the thread that owns each feature;
// - the loop stops at `length` instead of visiting all MB blocks: for a
//   lane with length >= 1 a fully masked block contributes
//   exp(-1e30 - m) = 0 with alpha = 1, so the result is the same;
// - an int8 row is 68 bytes at D = 64, which is not 16-byte aligned:
//   the score pass reads each row with 4-byte loads (D % 4 == 0 is
//   required), and every row starts at a multiple of 4 bytes.
#include "common.cuh"

namespace {

constexpr int PA_THREADS = 128;  // positions per chunk, one per thread
constexpr int PA_MAX_D = 256;
constexpr int PA_ACC = PA_MAX_D / PA_THREADS;  // features per thread
constexpr float NEG_BIG = -1e30f;  // finite: -inf breaks the online carry

template <typename TQ, typename TP, bool QUANT, typename TO>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TP* __restrict__ kpool,
                       const TP* __restrict__ vpool,
                       const int* __restrict__ block_table,
                       const int* __restrict__ lengths, TO* __restrict__ out,
                       int heads, int bs, int d, int dp, int mb,
                       float sm_scale) {
  __shared__ float q_s[PA_MAX_D];
  __shared__ float p_s[PA_THREADS];
  __shared__ float vscale_s[PA_THREADS];
  __shared__ int64_t vrow_s[PA_THREADS];
  __shared__ float scratch[32];

  const int rh = blockIdx.x;
  const int r = rh / heads, h = rh % heads;
  const int tid = threadIdx.x;
  // the TPU kernel visits MB blocks: positions past MB * bs never count
  const int cap = mb * bs;
  int length = lengths[r];
  if (length > cap) length = cap;
  for (int i = tid; i < d; i += PA_THREADS) q_s[i] = to_f32(q[(int64_t)rh * d + i]);
  __syncthreads();

  float m = NEG_BIG, l = 0.0f;
  float acc[PA_ACC];
#pragma unroll
  for (int k = 0; k < PA_ACC; ++k) acc[k] = 0.0f;

  for (int c0 = 0; c0 < length; c0 += PA_THREADS) {
    const int pos = c0 + tid;
    float s = NEG_BIG;
    if (pos < length) {
      const int blk = block_table[(int64_t)r * mb + pos / bs];
      const int64_t row = ((int64_t)blk * heads + h) * bs + pos % bs;
      const TP* krow = kpool + row * dp;
      float dot = 0.0f;
      if constexpr (QUANT) {
        // 4-byte loads: [D int8 values | bitcast f32 scale]
        const int32_t* kw = reinterpret_cast<const int32_t*>(krow);
        const float kscale = __int_as_float(kw[d / 4]);
        for (int w = 0; w < d / 4; ++w) {
          const int32_t packed = kw[w];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float kv = (float)(int8_t)((packed >> (8 * j)) & 0xff);
            dot += q_s[4 * w + j] * (kv * kscale);
          }
        }
        const int32_t* vw = reinterpret_cast<const int32_t*>(vpool + row * dp);
        vscale_s[tid] = __int_as_float(vw[d / 4]);
      } else {
        for (int i = 0; i < d; ++i) dot += q_s[i] * to_f32(krow[i]);
        vscale_s[tid] = 1.0f;
      }
      s = dot * sm_scale;
      vrow_s[tid] = row;
    }
    const float m_new = fmaxf(m, block_reduce(s, scratch, true));
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);  // 0 for masked positions
    p_s[tid] = p;
    l = l * alpha + block_reduce(p, scratch, false);  // syncs p_s too
    const int n_live = min(PA_THREADS, length - c0);
#pragma unroll
    for (int k = 0; k < PA_ACC; ++k) {
      const int i = tid + k * PA_THREADS;
      if (i < d) {
        float a = acc[k] * alpha;
#pragma unroll 4
        for (int t = 0; t < n_live; ++t) {
          const TP* vrow = vpool + vrow_s[t] * dp;
          float vv;
          if constexpr (QUANT) {
            vv = (float)(int8_t)vrow[i] * vscale_s[t];
          } else {
            vv = to_f32(vrow[i]);
          }
          a += p_s[t] * vv;
        }
        acc[k] = a;
      }
    }
    m = m_new;
    __syncthreads();  // p_s / vrow_s are rewritten by the next chunk
  }
  const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int k = 0; k < PA_ACC; ++k) {
    const int i = tid + k * PA_THREADS;
    if (i < d) out[(int64_t)rh * d + i] = from_f32<TO>(acc[k] * inv);
  }
}

template <typename TQ, typename TP, bool QUANT, typename TO>
void launch(const void* q, const void* kp, const void* vp, const int* bt,
            const int* lens, void* out, int rows, int heads, int bs, int d,
            int dp, int mb, float sm_scale, cudaStream_t stream) {
  paged_attention_kernel<TQ, TP, QUANT, TO><<<rows, PA_THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), bt, lens, static_cast<TO*>(out), heads, bs,
      d, dp, mb, sm_scale);
}

template <typename TQ>
int dispatch_pool(int pool_dtype, const void* q, const void* kp,
                  const void* vp, const int* bt, const int* lens, void* out,
                  int rows, int heads, int bs, int d, int dp, int mb,
                  float sm_scale, cudaStream_t s) {
  switch (pool_dtype) {
    // int8 pools: output in q's dtype; float pools: in the pool's dtype
    case kI8:
      launch<TQ, int8_t, true, TQ>(q, kp, vp, bt, lens, out, rows, heads, bs,
                                   d, dp, mb, sm_scale, s);
      break;
    case kF32:
      launch<TQ, float, false, float>(q, kp, vp, bt, lens, out, rows, heads,
                                      bs, d, dp, mb, sm_scale, s);
      break;
    case kBF16:
      launch<TQ, __nv_bfloat16, false, __nv_bfloat16>(
          q, kp, vp, bt, lens, out, rows, heads, bs, d, dp, mb, sm_scale, s);
      break;
    case kF16:
      launch<TQ, __half, false, __half>(q, kp, vp, bt, lens, out, rows, heads,
                                        bs, d, dp, mb, sm_scale, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" int mxt_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* block_table,
                                   const void* lengths, void* out, int r,
                                   int heads, int bs, int d, int dp, int mb,
                                   float sm_scale, int q_dtype,
                                   int pool_dtype, void* stream) {
  if (r <= 0 || heads <= 0) return 0;
  if (d < 1 || d > PA_MAX_D || (pool_dtype == kI8 && (d % 4 || dp != d + 4)))
    return (int)cudaErrorInvalidValue;
  const int rows = r * heads;
  const int* bt = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (q_dtype) {
    case kF32:
      err = dispatch_pool<float>(pool_dtype, q, k_pool, v_pool, bt, lens, out,
                                 rows, heads, bs, d, dp, mb, sm_scale, s);
      break;
    case kBF16:
      err = dispatch_pool<__nv_bfloat16>(pool_dtype, q, k_pool, v_pool, bt,
                                         lens, out, rows, heads, bs, d, dp, mb,
                                         sm_scale, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
