// K5a / K5b — the fused decode-step projections for Hopper.
//
// K5a replaces `_qkv_kernel` (mxnet_tpu/ops/pallas/fused_decode.py:92,
// reached through fused_qkv_project): x . W_qkv^T + b, split by head,
// and for int8 pools the per-(token, head) quantization of K and V
// straight into the pool row layout [D int8 values | 4 bytes of the f32
// scale, little-endian] (ops/nn.py kv_cache_quantize). A float store
// dtype is a cast instead.
// K5b replaces `_out_kernel` (fused_decode.py:120, reached through
// fused_out_project): a . W_out^T + b, summed in f32 and rounded once to
// the activations' dtype.
//
// Bound on this card: bytes. At decode (N = 8 tokens) the products are
// rank-8 updates whose cost is reading the weights once: 7.08 MB of f32
// W_qkv and 2.36 MB of W_out per layer at units 768. W_qkv (3U, U) is
// read row-major as it is — output feature h*D + d of Q/K/V is row
// {0, U, 2U} + h*D + d — with no per-step transposed copy (the TPU
// wrapper re-slabs w.T on every call). units * itemsize % 16 == 0 is
// required.
//
// K5a, the cluster route (qkv_cluster_kernel). The D weight rows of one
// (Q|K|V, head) are contiguous, so a thread-block cluster of C blocks
// owns them, each block about D/C rows (D 64, C 3: 108 blocks, at most
// one an SM, of 21 or 22 rows, 66 KB of f32). One thread brings the chunk of up to 8 tokens of
// x into shared memory by a bulk copy (TMA without a tensor map; an L2
// hit: every block reads it), then the block's slab by bulk copies in up
// to four chunks of whole row groups, each on an mbarrier of its own.
// The products are f32 FMA from shared memory: a warp multiplies 4 rows
// by 8 tokens over a share of U and sums its 32 accumulators across the
// lanes in 31 shuffles; the shares of a row are added in shared memory in
// a fixed order, so two runs give the same bits. For int8 stores each block takes its partial amax per token over
// its rows and writes it into its slot of every block of the cluster
// through distributed shared memory; after one cluster barrier every
// block takes the max of the C partials (max is order-free: the scale is
// the same bits for the same y whatever C), quantizes its own features,
// and rank 0 writes the scale's bytes. Every remote access is a write
// made before that barrier, so no second barrier is needed before a
// block exits; the partials are double-buffered by token chunk. Q
// clusters and float stores need no barrier. Any N runs in chunks of 8
// tokens: the slab stays resident and only x is copied again, its
// mbarrier's phase advancing once a chunk. Rounding follows jnp.round
// (half to even, rintf) on t / scale — a divide, never a multiply by
// the reciprocal of the scale.
//
// K5a, the head route (qkv_head_kernel): where a cluster's slab and x
// chunk do not fit in shared memory even at C 8 (f32 U 4096 at D 128,
// for example), one block per (Q|K|V, head) streams the weight rows from
// device memory, a warp per output feature.
//
// K5b, the ring route (out_ring_kernel). Bound by bytes: 2.36 MB of f32
// W_out at U 768 against 8 tokens, so the design is about bringing the
// rows in from every SM at once. Block b owns the OUT_ROWS (R) contiguous
// weight rows from R*b; rows are contiguous in (U_out, U_in) row-major,
// so a block's slab is one span, with no transposed copy. R 6 gives 128
// blocks at U_out 768, one an SM of the 132. One thread brings the chunk
// of up to 8 tokens of activations into shared memory by bulk copies (L2
// hits: every block reads the same lines, so each block takes the
// OUT_X_COPIES pieces in an order rotated by its index) and the slab
// through a ring of at most OUT_STAGES stages of whole groups of RW rows,
// each stage one bulk copy on a "full" mbarrier. Where the slab and the
// chunk fit (f32 up to U 4096), the ring holds the whole slab, filled
// once for all token chunks, so the weights are read once for any N; one
// stage is the fastest at U 768, since every copy is asked for at once
// and lands at about the same time. Where they do not fit (f32 U_in
// 4608), the ring walks the rows: every warp releases a stage on its
// "empty" mbarrier, the thread that issues the copies refills it, and the
// rows stream again for each token chunk. Warp w multiplies every row of
// a stage by the 8 tokens over its share of U_in (16-byte vectors j with
// (j / 32) % OUT_WARPS == w) from shared memory, one load of each
// activation vector serving all the stage's rows, and sums each group's
// 32 accumulators across its lanes with transpose_sum; the warps' sums of
// a row are added in shared memory in warp order, so two runs give the
// same bits. Each block writes its (8, R) outputs row by row,
// neighbouring threads on neighbouring addresses.
//
// K5b, the row route (out_kernel): where a token chunk and one group of
// rows do not fit in shared memory (f32 U_in above about 4800), a warp
// per output feature streams its weight row from device memory with
// 16-byte loads.
// out_geometry chooses the route before the launch; mxt_out_geometry
// reports it.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NC = 8;            // tokens per pass
constexpr int QKV_THREADS = 512;
constexpr int OUT_THREADS = 256;
constexpr int MAX_D = 256;

// the cluster route
constexpr int QKV_CLUSTER = 3;   // blocks per (Q|K|V, head); raised to fit
constexpr int CL_THREADS = 384;
constexpr int CL_WARPS = CL_THREADS / 32;
constexpr int RW = 4;            // rows a warp multiplies at once
constexpr int RMAX = 64;         // rows a block may own
constexpr int W_CHUNKS = 4;      // bulk copies (and mbarriers) of the slab
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int SMEM_LIMIT = 232448;  // shared memory an H100 block may use
// shared memory before the slab: W_CHUNKS + 1 mbarriers (64 B), the
// per-token scale (NC floats, 64 B with padding), the bias (RMAX floats),
// the cluster's per-token amax partials (2 x MAX_CLUSTER x NC floats), y
// (NC x RMAX floats) and the warps' partial sums (at most RMAX x NC)
constexpr int CL_FIXED = 128 + RMAX * 4 + 2 * MAX_CLUSTER * NC * 4 +
                         2 * NC * RMAX * 4;
static_assert(RW * NC == 32, "a warp's accumulators are one per lane");
static_assert(CL_WARPS >= NC, "a warp per token takes the amax");
static_assert(W_CHUNKS * 8 + 8 <= 64, "the mbarriers fit in 64 bytes");
static_assert(CL_FIXED % 16 == 0, "the slab starts 16-byte aligned");

// K5b's ring route
constexpr int OUT_ROWS = 6;          // rows a block owns (R)
constexpr int OUT_STAGES = 1;        // bulk copies of a block's slab (S)
constexpr int OUT_RING_THREADS = 256;
constexpr int OUT_X_COPIES = 4;      // bulk copies of the activations
constexpr int OUT_WARPS = OUT_RING_THREADS / 32;
constexpr int OUT_GROUPS = (OUT_ROWS + RW - 1) / RW;  // of RW rows a block
// shared memory before the warps' partial sums: the mbarriers (full and
// empty per stage, then x's) in 128 bytes, the bias (OUT_ROWS floats)
constexpr int OUT_FIXED = 128 + (OUT_ROWS * 4 + 15) / 16 * 16;
static_assert(OUT_ROWS <= OUT_RING_THREADS, "a thread per row loads the bias");
static_assert((2 * OUT_STAGES + 1) * 8 <= 128, "the mbarriers fit");
static_assert(OUT_FIXED % 16 == 0, "the activations start 16-byte aligned");

// How K5b runs a shape: the ring route (route 1) with its stages, or the
// row route (route 0).
struct OutGeo {
  int route;
  int rows;          // rows a block owns (the last block may own fewer)
  int stage_groups;  // row groups of RW rows in a stage
  int stages;        // stages of a whole block's slab
  int slots;         // stages the ring holds; fewer than stages: it walks
  int blocks;
  int smem;          // dynamic shared memory, bytes
};

// The ring route where a token chunk and the ring fit in shared memory:
// the slab resident in OUT_STAGES copies of whole row groups where it
// fits, else as many slots as fit walking the rows (a stage of one row
// group if need be); the row route where not even one such stage fits.
OutGeo out_geometry(int u_in, int u_out, int itemsize) {
  OutGeo g = {};
  g.rows = u_out < OUT_ROWS ? u_out : OUT_ROWS;
  g.blocks = (u_out + g.rows - 1) / g.rows;
  const int groups = (g.rows + RW - 1) / RW;
  const long long row_bytes = (long long)u_in * itemsize;
  // the warps' partial sums and the activations before the ring
  const long long base =
      OUT_FIXED + (long long)OUT_WARPS * g.rows * NC * 4 + NC * row_bytes;
  for (int cg = (groups + OUT_STAGES - 1) / OUT_STAGES;; cg = 1) {
    const int stages = (groups + cg - 1) / cg;
    const int stage_rows = cg * RW < g.rows ? cg * RW : g.rows;
    const long long stage_bytes = stage_rows * row_bytes;
    long long fit = base < SMEM_LIMIT ? (SMEM_LIMIT - base) / stage_bytes : 0;
    if (fit > OUT_STAGES) fit = OUT_STAGES;   // an mbarrier pair a slot
    if (fit >= 1) {
      g.route = 1;
      g.stage_groups = cg;
      g.stages = stages;
      g.slots = (int)(fit < stages ? fit : stages);
      g.smem = (int)(base + g.slots * stage_bytes);
      return g;
    }
    if (cg == 1) return g;
  }
}

// The cluster size of the cluster route for (D, U, itemsize), or 0 where
// the head route takes the shape: QKV_CLUSTER (at most D), doubled up to
// 8 until a block owns at most RMAX rows and its slab and x chunk fit.
int cluster_blocks(int d, int u, int itemsize) {
  int c = QKV_CLUSTER < d ? QKV_CLUSTER : d;
  for (;;) {
    const int rows = (d + c - 1) / c;
    const long long smem = CL_FIXED + (long long)(rows + NC) * u * itemsize;
    if (rows <= RMAX && smem <= SMEM_LIMIT) return c;
    if (c >= MAX_CLUSTER || c >= d) return 0;
    c = 2 * c < d ? 2 * c : d;
    if (c > MAX_CLUSTER) c = MAX_CLUSTER;
  }
}

// One step of transpose_sum: lanes with bit O set keep a[O..2O), the
// others a[0..O), each adding the partner lane's copy (a template, so
// that every index is a constant and `a` stays in registers)
template <int O>
__device__ __forceinline__ void transpose_step(float (&a)[32], int lane) {
  const bool hi = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = hi ? a[i] : a[i + O];
    const float keep = hi ? a[i + O] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// a[i] summed over the warp; lane L gets the sum of a[L]. Each step keeps
// half of the values and adds the partner lane's copy of them: 31
// shuffles in place of 32 butterfly sums (160).
__device__ __forceinline__ float transpose_sum(float (&a)[32], int lane) {
  transpose_step<16>(a, lane);
  transpose_step<8>(a, lane);
  transpose_step<4>(a, lane);
  transpose_step<2>(a, lane);
  transpose_step<1>(a, lane);
  return a[0];
}

template <typename T, typename S, bool QUANT>
__global__ void __launch_bounds__(CL_THREADS, 1)
qkv_cluster_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ q_out,
                   S* __restrict__ k_out, S* __restrict__ v_out, int n_tok,
                   int u, int heads, int d, int dp) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  float* scale_s = reinterpret_cast<float*>(smem + 64);   // [NC]
  float* bias_s = reinterpret_cast<float*>(smem + 128);   // [RMAX]
  float* amax_s = bias_s + RMAX;                  // [2][MAX_CLUSTER][NC]
  float* y_s = amax_s + 2 * MAX_CLUSTER * NC;             // [NC][RMAX]
  float* part_s = y_s + NC * RMAX;                        // [parts*rows][NC]
  T* w_s = reinterpret_cast<T*>(smem + CL_FIXED);         // [rows][u]

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int grp = blockIdx.x / c;          // the same for the whole cluster
  const int which = grp / heads;           // 0 = Q, 1 = K, 2 = V
  const int h = grp % heads;
  const int f0 = rank * d / c;             // this block's first feature
  const int rows = (rank + 1) * d / c - f0;
  T* x_s = w_s + (size_t)rows * u;         // [NC][u]
  const int64_t o0 = (int64_t)which * u + (int64_t)h * d + f0;  // W row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = u / V;                  // 16-byte vectors a row
  const int groups = (rows + RW - 1) / RW;
  // warps that split one row group's U-sum (each warp one unit of work)
  const int parts = groups >= CL_WARPS ? 1 : CL_WARPS / groups;
  // the slab is copied in chunks of whole row groups, one mbarrier each
  const int chunk_groups = (groups + W_CHUNKS - 1) / W_CHUNKS;
  const int n_chunks = (groups + chunk_groups - 1) / chunk_groups;
  const uint32_t bar0 = smem_u32(smem);    // W chunk k at bar0 + 8k
  const uint32_t xbar = bar0 + 8 * W_CHUNKS;
  // the bias of row threadIdx.x, loaded now and used after the products
  const float bias_r = bias && (int)threadIdx.x < rows
                           ? to_f32(bias[o0 + threadIdx.x]) : 0.0f;

  if (threadIdx.x == 0) {
    for (int k = 0; k <= W_CHUNKS; ++k) mbar_init(bar0 + 8 * k, 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int n0 = 0, it = 0; n0 < n_tok; n0 += NC, ++it) {
    const int nc = min(NC, n_tok - n0);
    if (threadIdx.x == 0) {
      // the chunk of x, then (the first chunk) the slab in row chunks
      fence_proxy_async_smem();   // the last chunk's reads of x_s come first
      const uint32_t bytes = (uint32_t)((size_t)nc * u * sizeof(T));
      mbar_expect_tx(xbar, bytes);
      bulk_g2s(x_s, x + (int64_t)n0 * u, bytes, xbar);
      for (int k = 0; it == 0 && k < n_chunks; ++k) {
        const int r0 = k * chunk_groups * RW;
        const int r1 = min(rows, r0 + chunk_groups * RW);
        const uint32_t wb = (uint32_t)((size_t)(r1 - r0) * u * sizeof(T));
        mbar_expect_tx(bar0 + 8 * k, wb);
        bulk_g2s(w_s + (size_t)r0 * u, w + (o0 + r0) * u, wb, bar0 + 8 * k);
      }
    }
    mbar_wait(xbar, it & 1);
    for (int unit = warp; unit < groups * parts; unit += CL_WARPS) {
      const int g = unit / parts, p = unit % parts;
      const int r0 = g * RW;
      float acc[RW * NC];
#pragma unroll
      for (int i = 0; i < RW * NC; ++i) acc[i] = 0.0f;
      mbar_wait(bar0 + 8 * (g / chunk_groups), 0);
      for (int j = lane + 32 * p; j < nvec; j += 32 * parts) {
        float wv[RW][V];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          if (r0 + r < rows) {
            load16(w_s + (size_t)(r0 + r) * u + j * V, wv[r]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) wv[r][e] = 0.0f;
          }
        }
        // every token's vector first, so that the loads issue together
        float xv[NC][V];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          if (n < nc) {
            load16(x_s + (size_t)n * u + j * V, xv[n]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) xv[n][e] = 0.0f;
          }
        }
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int r = 0; r < RW; ++r)
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[r * NC + n] = fmaf(xv[n][e], wv[r][e], acc[r * NC + n]);
      }
      const float sum = transpose_sum(acc, lane);  // row lane / NC, token lane % NC
      const int r = r0 + lane / NC, n = lane % NC;
      if (r < rows && n < nc) part_s[(p * rows + r) * NC + n] = sum;
    }
    if ((int)threadIdx.x < rows) bias_s[threadIdx.x] = bias_r;
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * nc; idx += CL_THREADS) {
      const int r = idx / nc, n = idx % nc;
      float s = 0.0f;
      for (int p = 0; p < parts; ++p) s += part_s[(p * rows + r) * NC + n];
      y_s[n * RMAX + r] = s + bias_s[r];
    }
    __syncthreads();
    if (which == 0) {
      for (int idx = threadIdx.x; idx < nc * rows; idx += CL_THREADS) {
        const int n = idx / rows, r = idx % rows;
        q_out[((int64_t)(n0 + n) * heads + h) * d + f0 + r] =
            from_f32<T>(y_s[n * RMAX + r]);
      }
    } else {
      S* dst = which == 1 ? k_out : v_out;
      if constexpr (QUANT) {
        // this chunk's partials, in the buffer of its parity: a block
        // reads buffer it & 1 before it reaches the next chunk's cluster
        // barrier, and no block writes it again before that barrier
        float* amax_it = amax_s + (it & 1) * MAX_CLUSTER * NC;
        if (warp < nc) {
          // this block's amax of token `warp`, into slot `rank` of every
          // block of the cluster (distributed shared memory)
          float m = 0.0f;
          for (int r = lane; r < rows; r += 32)
            m = fmaxf(m, fabsf(y_s[warp * RMAX + r]));
          m = warp_max(m);
          if (lane < c)
            *cluster.map_shared_rank(amax_it + rank * NC + warp, lane) = m;
        }
        // every partial has arrived in every block; the remote writes are
        // done before any block passes, so any block may then exit
        cluster.sync();
        if (warp < nc) {
          float m = lane < c ? amax_it[lane * NC + warp] : 0.0f;
          m = warp_max(m);
          // amax * f32(1/127): the reference runs compiled, where XLA
          // folds its divide by the constant 127 into this multiply
          if (lane == 0) scale_s[warp] = fmaxf(m, 1e-6f) * (1.0f / 127.0f);
        }
        __syncthreads();
        for (int idx = threadIdx.x; idx < nc * rows; idx += CL_THREADS) {
          const int n = idx / rows, r = idx % rows;
          int8_t* row = reinterpret_cast<int8_t*>(dst) +
                        ((int64_t)(n0 + n) * heads + h) * dp;
          const float qv = fminf(
              fmaxf(rintf(y_s[n * RMAX + r] / scale_s[n]), -127.0f), 127.0f);
          row[f0 + r] = (int8_t)qv;
        }
        if (rank == 0 && threadIdx.x < 4 * nc) {
          // bitcast of the f32 scale, byte b of its little-endian form
          const int n = threadIdx.x / 4, b = threadIdx.x % 4;
          const unsigned int bits = __float_as_uint(scale_s[n]);
          reinterpret_cast<int8_t*>(dst)[((int64_t)(n0 + n) * heads + h) * dp
                                         + d + b] =
              (int8_t)((bits >> (8 * b)) & 0xffu);
        }
      } else {
        for (int idx = threadIdx.x; idx < nc * rows; idx += CL_THREADS) {
          const int n = idx / rows, r = idx % rows;
          dst[((int64_t)(n0 + n) * heads + h) * dp + f0 + r] =
              from_f32<S>(y_s[n * RMAX + r]);
        }
      }
    }
    __syncthreads();  // x_s, part_s, y_s and scale_s are rewritten next chunk
  }
}

// One warp: acc[n] = sum_i x[n, i] * w_row[i] for n < nc; every lane ends
// with every sum.
template <typename T>
__device__ __forceinline__ void warp_row_dot(const T* __restrict__ w_row,
                                             const T* __restrict__ x0, int u,
                                             int nc, float (&acc)[NC]) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = 0.0f;
#pragma unroll 2
  for (int i = lane * V; i < u; i += 32 * V) {
    float w[V];
    load16(w_row + i, w);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if (n < nc) {
        float xv[V];
        load16(x0 + (int64_t)n * u + i, xv);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[n] = fmaf(xv[j], w[j], acc[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = warp_sum(acc[n]);
}

// acc[lane] without indexing a register array by a run-time value
__device__ __forceinline__ float pick_lane(const float (&acc)[NC], int lane) {
  float v = 0.0f;
#pragma unroll
  for (int n = 0; n < NC; ++n) v = (n == lane) ? acc[n] : v;
  return v;
}

template <typename T, typename S, bool QUANT>
__global__ void __launch_bounds__(QKV_THREADS)
qkv_head_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ q_out,
                S* __restrict__ k_out, S* __restrict__ v_out, int n_tok,
                int u, int heads, int d, int dp) {
  __shared__ float y_s[NC][MAX_D];
  const int which = blockIdx.x / heads;  // 0 = Q, 1 = K, 2 = V
  const int h = blockIdx.x % heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int n0 = 0; n0 < n_tok; n0 += NC) {
    const int nc = min(NC, n_tok - n0);
    for (int f = warp; f < d; f += nwarps) {
      const int64_t o = (int64_t)which * u + (int64_t)h * d + f;
      float acc[NC];
      warp_row_dot(w + o * u, x + (int64_t)n0 * u, u, nc, acc);
      if (lane < nc)
        y_s[lane][f] = pick_lane(acc, lane) + (bias ? to_f32(bias[o]) : 0.0f);
    }
    __syncthreads();
    if (which == 0) {
      for (int idx = threadIdx.x; idx < nc * d; idx += blockDim.x) {
        const int n = idx / d, f = idx % d;
        q_out[((int64_t)(n0 + n) * heads + h) * d + f] = from_f32<T>(y_s[n][f]);
      }
    } else {
      S* dst = which == 1 ? k_out : v_out;
      if constexpr (QUANT) {
        for (int n = warp; n < nc; n += nwarps) {
          float amax = 0.0f;
          for (int f = lane; f < d; f += 32) amax = fmaxf(amax, fabsf(y_s[n][f]));
          amax = warp_max(amax);
          // amax * f32(1/127), as the cluster route
          const float scale = fmaxf(amax, 1e-6f) * (1.0f / 127.0f);
          int8_t* row = reinterpret_cast<int8_t*>(dst) +
                        ((int64_t)(n0 + n) * heads + h) * dp;
          for (int f = lane; f < d; f += 32) {
            const float qv = fminf(fmaxf(rintf(y_s[n][f] / scale), -127.0f), 127.0f);
            row[f] = (int8_t)qv;
          }
          if (lane < 4) {
            // bitcast of the f32 scale, byte `lane` of its little-endian form
            const unsigned int bits = __float_as_uint(scale);
            row[d + lane] = (int8_t)((bits >> (8 * lane)) & 0xffu);
          }
        }
      } else {
        for (int idx = threadIdx.x; idx < nc * d; idx += blockDim.x) {
          const int n = idx / d, f = idx % d;
          dst[((int64_t)(n0 + n) * heads + h) * dp + f] = from_f32<S>(y_s[n][f]);
        }
      }
    }
    __syncthreads();  // y_s is rewritten by the next pass
  }
}

template <typename T>
__global__ void __launch_bounds__(OUT_THREADS)
out_kernel(const T* __restrict__ a, const T* __restrict__ w,
           const T* __restrict__ bias, T* __restrict__ out, int n_tok,
           int u_in, int u_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int o = blockIdx.x * nwarps + warp;  // one output feature per warp
  if (o >= u_out) return;
  const float b = bias ? to_f32(bias[o]) : 0.0f;
  for (int n0 = 0; n0 < n_tok; n0 += NC) {
    const int nc = min(NC, n_tok - n0);
    float acc[NC];
    warp_row_dot(w + (int64_t)o * u_in, a + (int64_t)n0 * u_in, u_in, nc, acc);
    if (lane < nc)
      out[(int64_t)(n0 + lane) * u_out + o] = from_f32<T>(pick_lane(acc, lane) + b);
  }
}

template <typename T>
__global__ void __launch_bounds__(OUT_RING_THREADS)
out_ring_kernel(const T* __restrict__ a, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ out, int n_tok,
                int u_in, int u_out, OutGeo geo) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  float* bias_s = reinterpret_cast<float*>(smem + 128);        // [OUT_ROWS]
  float* part_s = reinterpret_cast<float*>(smem + OUT_FIXED);  // [warps][rows][NC]
  T* x_s = reinterpret_cast<T*>(smem + OUT_FIXED +
                                OUT_WARPS * geo.rows * NC * 4);  // [NC][u_in]
  const int cg = geo.stage_groups, slots = geo.slots;
  const int stage_rows = min(cg * RW, geo.rows);
  T* ring = x_s + (size_t)NC * u_in;            // [slots][stage_rows][u_in]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = blockIdx.x * geo.rows;         // this block's first row
  const int rows = min(geo.rows, u_out - o0);
  const int groups = (rows + RW - 1) / RW;
  const int stages = (groups + cg - 1) / cg;    // of this block's slab
  const bool walk = slots < stages;
  // stage copies over the whole launch: once, or once a token chunk
  const int total = walk ? (n_tok + NC - 1) / NC * stages : stages;
  const int nvec = u_in / V;                    // 16-byte vectors a row
  const uint32_t bar0 = smem_u32(smem);         // full[k] at bar0 + 8k
  const uint32_t empty0 = bar0 + 8 * OUT_STAGES;
  const uint32_t xbar = bar0 + 16 * OUT_STAGES;
  // the bias of row threadIdx.x, loaded now and used after the products
  const float bias_r =
      bias && (int)threadIdx.x < rows ? to_f32(bias[o0 + threadIdx.x]) : 0.0f;

  // the activations of the chunk from token n0, in OUT_X_COPIES pieces
  // taken in an order rotated by the block, so that the blocks do not all
  // ask L2 for the same lines at once
  auto issue_x = [&](int n0) {
    const int nc = min(NC, n_tok - n0);
    const uint32_t bytes = (uint32_t)((size_t)nc * u_in * sizeof(T));
    mbar_expect_tx(xbar, bytes);
    const uint32_t v16 = bytes / 16;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(a + (int64_t)n0 * u_in);
    for (int k = 0; k < OUT_X_COPIES; ++k) {
      const uint32_t q = (k + blockIdx.x) % OUT_X_COPIES;
      const uint32_t b0 = q * v16 / OUT_X_COPIES * 16;
      const uint32_t b1 = (q + 1) * v16 / OUT_X_COPIES * 16;
      if (b1 > b0)
        bulk_g2s(reinterpret_cast<unsigned char*>(x_s) + b0, src + b0,
                 b1 - b0, xbar);
    }
  };
  // stage copy `seq` (stage seq % stages) into slot seq % slots
  auto issue = [&](int seq) {
    const int slot = seq % slots, r0 = seq % stages * cg * RW;
    const int r1 = min(rows, r0 + cg * RW);
    const uint32_t bytes = (uint32_t)((size_t)(r1 - r0) * u_in * sizeof(T));
    mbar_expect_tx(bar0 + 8 * slot, bytes);
    bulk_g2s(ring + (size_t)slot * stage_rows * u_in,
             w + (int64_t)(o0 + r0) * u_in, bytes, bar0 + 8 * slot);
  };

  if (threadIdx.x == 0) {
    for (int k = 0; k < OUT_STAGES; ++k) {
      mbar_init(bar0 + 8 * k, 1);
      mbar_init(empty0 + 8 * k, OUT_WARPS);
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
    // the first chunk's activations and the ring's first stages, before
    // the block's first barrier
    issue_x(0);
    for (int seq = 0; seq < slots && seq < total; ++seq) issue(seq);
  }
  __syncthreads();
  for (int n0 = 0, it = 0; n0 < n_tok; n0 += NC, ++it) {
    const int nc = min(NC, n_tok - n0);
    if (threadIdx.x == 0 && it > 0) {
      fence_proxy_async_smem();   // the last chunk's reads of x_s come first
      issue_x(n0);
    }
    mbar_wait(xbar, it & 1);
    // warp w sums the 16-byte vectors j of its share, (j / 32) % OUT_WARPS
    // == w, over every row of a stage: one load of each activation vector
    // serves all the stage's rows
    for (int s = 0; s < stages; ++s) {
      const int seq = walk ? it * stages + s : s;
      const int slot = seq % slots;
      const int g0 = s * cg, ng = min(cg, groups - g0);  // the stage's groups
      // every warp waits, walking before it releases the stage, so that no
      // release can count towards the slot's previous use
      mbar_wait(bar0 + 8 * slot, (seq / slots) & 1);
      const T* w_slot = ring + (size_t)slot * stage_rows * u_in;
      float acc[OUT_GROUPS][RW * NC];
#pragma unroll
      for (int g = 0; g < OUT_GROUPS; ++g)
#pragma unroll
        for (int i = 0; i < RW * NC; ++i) acc[g][i] = 0.0f;
      for (int j = lane + 32 * warp; j < nvec; j += 32 * OUT_WARPS) {
        // every token's vector first, so that the loads issue together
        float xv[NC][V];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          if (n < nc) {
            load16(x_s + (size_t)n * u_in + j * V, xv[n]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) xv[n][e] = 0.0f;
          }
        }
#pragma unroll
        for (int g = 0; g < OUT_GROUPS; ++g) {
          if (g >= ng) continue;
          float wv[RW][V];
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            if ((g0 + g) * RW + r < rows) {
              load16(w_slot + (size_t)(g * RW + r) * u_in + j * V, wv[r]);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) wv[r][e] = 0.0f;
            }
          }
#pragma unroll
          for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int r = 0; r < RW; ++r)
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[g][r * NC + n] =
                    fmaf(xv[n][e], wv[r][e], acc[g][r * NC + n]);
        }
      }
#pragma unroll
      for (int g = 0; g < OUT_GROUPS; ++g) {
        if (g >= ng) continue;
        // row (g0 + g) * RW + lane / NC, token lane % NC
        const float sum = transpose_sum(acc[g], lane);
        const int r = (g0 + g) * RW + lane / NC, n = lane % NC;
        if (r < rows && n < nc) part_s[(warp * rows + r) * NC + n] = sum;
      }
      if (walk) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * slot);
        if (threadIdx.x == 0 && seq + slots < total) {
          // every warp has released the slot: refill it
          mbar_wait(empty0 + 8 * slot, (seq / slots) & 1);
          fence_proxy_async_smem();
          issue(seq + slots);
        }
        __syncwarp();
      }
    }
    if ((int)threadIdx.x < rows) bias_s[threadIdx.x] = bias_r;
    __syncthreads();
    // the shares of each row in a fixed order, then the bias; token n's
    // rows are neighbouring addresses
    for (int idx = threadIdx.x; idx < nc * rows; idx += OUT_RING_THREADS) {
      const int n = idx / rows, r = idx % rows;
      float v = 0.0f;
      for (int p = 0; p < OUT_WARPS; ++p) v += part_s[(p * rows + r) * NC + n];
      out[(int64_t)(n0 + n) * u_out + o0 + r] = from_f32<T>(v + bias_s[r]);
    }
    __syncthreads();  // x_s and part_s are rewritten next chunk
  }
}

template <typename T>
cudaError_t launch_out(const void* a, const void* w, const void* b,
                       void* out, int n, int u_in, int u_out,
                       cudaStream_t s) {
  const T* at = static_cast<const T*>(a);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  const OutGeo geo = out_geometry(u_in, u_out, (int)sizeof(T));
  if (geo.route == 0) {
    const int warps = OUT_THREADS / 32;
    out_kernel<T><<<(u_out + warps - 1) / warps, OUT_THREADS, 0, s>>>(
        at, wt, bt, ot, n, u_in, u_out);
    return cudaGetLastError();
  }
  auto kernel = out_ring_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (err != cudaSuccess) return err;
  kernel<<<geo.blocks, OUT_RING_THREADS, geo.smem, s>>>(at, wt, bt, ot, n,
                                                        u_in, u_out, geo);
  return cudaGetLastError();
}

template <typename T, typename S, bool QUANT>
cudaError_t launch_qkv(const void* x, const void* w, const void* b, void* q,
                       void* k, void* v, int n, int u, int heads, int d,
                       int dp, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* qt = static_cast<T*>(q);
  S* kt = static_cast<S*>(k);
  S* vt = static_cast<S*>(v);
  const int c = cluster_blocks(d, u, (int)sizeof(T));
  if (c == 0) {
    qkv_head_kernel<T, S, QUANT><<<3 * heads, QKV_THREADS, 0, s>>>(
        xt, wt, bt, qt, kt, vt, n, u, heads, d, dp);
    return cudaGetLastError();
  }
  auto kernel = qkv_cluster_kernel<T, S, QUANT>;
  const size_t smem =
      CL_FIXED + (size_t)((d + c - 1) / c + NC) * u * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(3 * heads * c);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xt, wt, bt, qt, kt, vt, n, u, heads,
                           d, dp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int dispatch_store(int store_dtype, const void* x, const void* w,
                   const void* b, void* q, void* k, void* v, int n, int u,
                   int heads, int d, int dp, cudaStream_t s) {
  switch (store_dtype) {
    case kI8:
      return (int)launch_qkv<T, int8_t, true>(x, w, b, q, k, v, n, u, heads,
                                              d, dp, s);
    case kF32:
      return (int)launch_qkv<T, float, false>(x, w, b, q, k, v, n, u, heads,
                                              d, dp, s);
    case kBF16:
      return (int)launch_qkv<T, __nv_bfloat16, false>(x, w, b, q, k, v, n, u,
                                                      heads, d, dp, s);
    case kF16:
      return (int)launch_qkv<T, __half, false>(x, w, b, q, k, v, n, u, heads,
                                               d, dp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int itemsize(int dtype) {
  return dtype == kF32 ? 4 : (dtype == kBF16 || dtype == kF16) ? 2 : 0;
}

}  // namespace

// K5a's cluster size for (units, heads, activation dtype): C of the
// cluster route, 0 where the head route takes the shape, -1 for a shape
// the entry refuses.
extern "C" int mxt_qkv_cluster(int u, int heads, int dtype) {
  if (heads <= 0 || u % heads || u / heads > MAX_D || itemsize(dtype) == 0)
    return -1;
  return cluster_blocks(u / heads, u, itemsize(dtype));
}

extern "C" int mxt_qkv_project(const void* x, const void* w_qkv,
                               const void* b_qkv, void* q, void* k_store,
                               void* v_store, int n, int u, int heads,
                               int dtype, int store_dtype, void* stream) {
  if (n <= 0) return 0;
  const int d = heads > 0 ? u / heads : 0;
  if (heads <= 0 || u % heads || d > MAX_D) return (int)cudaErrorInvalidValue;
  const int dp = store_dtype == kI8 ? d + 4 : d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_store<float>(store_dtype, x, w_qkv, b_qkv, q, k_store,
                                   v_store, n, u, heads, d, dp, s);
    case kBF16:
      return dispatch_store<__nv_bfloat16>(store_dtype, x, w_qkv, b_qkv, q,
                                           k_store, v_store, n, u, heads, d,
                                           dp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5b's shape for (U_in, U_out, activation dtype), written to geo[0..8]:
// route (1 the ring, 0 the row route), rows a block owns, row groups a
// stage, stages, ring slots, blocks, dynamic shared memory bytes and
// threads. Returns -1 for a shape the entry refuses.
extern "C" int mxt_out_geometry(int u_in, int u_out, int dtype, int* geo) {
  if ((dtype != kF32 && dtype != kBF16) || u_in <= 0 || u_out <= 0 ||
      (u_in * itemsize(dtype)) % 16)
    return -1;
  const OutGeo g = out_geometry(u_in, u_out, itemsize(dtype));
  const int v[8] = {g.route, g.rows, g.stage_groups, g.stages, g.slots,
                    g.blocks, g.smem, g.route ? OUT_RING_THREADS : OUT_THREADS};
  for (int i = 0; i < 8; ++i) geo[i] = v[i];
  return 0;
}

extern "C" int mxt_out_project(const void* a, const void* w_out,
                               const void* b_out, void* out, int n, int u_in,
                               int u_out, int dtype, void* stream) {
  if (n <= 0 || u_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)launch_out<float>(a, w_out, b_out, out, n, u_in, u_out, s);
    case kBF16:
      return (int)launch_out<__nv_bfloat16>(a, w_out, b_out, out, n, u_in,
                                            u_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
