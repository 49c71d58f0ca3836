// K3 — row-wise logsumexp in one streaming pass, for Hopper.
//
// Replaces `_lse_kernel` (mxnet_tpu/ops/pallas/cross_entropy.py:34,
// reached through fused_lse :64 and cross_entropy_with_logits :105).
// Input (N, V) f32 or bf16 logits, output (N,) f32 lse = m + log(l) with
// the max m taken from the finite -1e30 up, the sum l of exp(x - m), and
// the `l == 0` guard of the TPU kernel. The V tail needs no padding: the
// loops stop at V (32000 is no power of two).
//
// Bound on this card: bytes. Every logit is read once and only N floats
// are written; at the LM head's (8184, 32000) f32 that is 1.05 GB, 0.31 ms
// at 3.35 TB/s. The exponentials (one per logit, plus one rescale per
// 16-byte chunk on the streaming routes) are far below the FMA and SFU
// rates. The TPU kernel's sequential V grid axis, whose VMEM scratch
// carried (m, l), becomes a loop inside a block, a warp or a thread.
//
// Four kernels, one launch a call each; ops/kernels/cross_entropy.py
// `lse_route` picks one from the row's width in bytes and the bytes of
// the whole input (the cuts come from `chip_smoke.py --k3`'s sweep):
// - "rows" (`row_lse_tile_kernel`), many narrow rows (SSD300's 21
//   classes): one thread per row, many rows a block. A tile of rows is
//   one contiguous run of bytes whatever V is, so one thread brings its
//   16-byte-aligned body into shared memory with a bulk copy
//   (`cp.async.bulk` on an mbarrier) and a few threads load the ragged
//   head and tail bytes with scalar loads. A persistent grid (two blocks
//   an SM) walks the tiles with two stages in flight: the next tile
//   arrives while this one is reduced. Each thread takes the max and then
//   the sum of its row out of shared memory, the exponential by the SFU
//   (`ex2.approx`, as K1 does): with expf the loop was bound by its
//   instructions. Where the row stride shares a factor with the 32 banks
//   (even V) each lane starts at a rotated column, so that a warp's reads
//   spread over the banks; lse is written coalesced.
// - "warp" (`row_lse_warp_kernel`), a few narrow rows (the NSP head's 2),
//   where the rows route's set-up costs more than its bytes: one warp
//   per row.
// - "wide" (`row_lse_wide_kernel`), every row wider than the rows
//   route's (ResNet-50's 1000 classes, the LM and MLM heads): one
//   256-thread block per row.
//   Both read a row as a scalar head up to its first 16-byte boundary,
//   a body of 16-byte chunks (4 f32 or 8 bf16 values; a warp reads 512
//   contiguous bytes a step) and a scalar tail, so rows that do not start
//   on a 16-byte boundary (BERT's 30522-float rows, every other one) take
//   the vector loads too. Each lane keeps its own online (m, l) and the
//   pairs are merged over the warp with shuffles (and over the block
//   through shared memory).
// - "block" (`row_lse_kernel`), the first design, kept for comparison: one
//   block per row with 16-byte loads only where every row is aligned
//   (`vec`), else a scalar loop. `lse_route` does not choose it.
// No kernel splits a row across blocks, allocates, synchronises the
// device or uses atomics: results are the same bits run to run.
#include "common.cuh"

namespace {

constexpr int LSE_THREADS = 256;
constexpr int ROWS_THREADS = 256;
// the "rows" route's tile and grid: at least ROWS_TILE_BYTES of rows a
// stage (whole passes of ROWS_THREADS rows), ROWS_PER_SM blocks an SM;
// the tiles are then evened out over the grid (PERF.md §6 has the sweep
// of tile and grid behind these two values)
constexpr int ROWS_TILE_BYTES = 16384;
constexpr int ROWS_PER_SM = 2;
constexpr int SMEM_MAX = 232448;
constexpr float NEG_BIG = -1e30f;

// 16 bytes -> 4 f32 or 8 bf16 values (bf16 to f32 is the top 16 bits)
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// merge the running pair (m, l) with (mo, lo)
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

// one 16-byte chunk into the running pair
template <int VEC>
__device__ __forceinline__ void add_chunk(const uint4& raw, float& m,
                                          float& l) {
  float f[VEC];
  unpack(raw, f);
  float cm = f[0];
#pragma unroll
  for (int e = 1; e < VEC; ++e) cm = fmaxf(cm, f[e]);
  const float mn = fmaxf(m, cm);
  float add = 0.0f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) add += expf(f[e] - mn);
  l = l * expf(m - mn) + add;
  m = mn;
}

// one value into the running pair
__device__ __forceinline__ void add_one(float xv, float& m, float& l) {
  const float mn = fmaxf(m, xv);
  l = l * expf(m - mn) + expf(xv - mn);
  m = mn;
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the SFU alone (relative error about 2^-22; results below 2^-126
// flush to 0, which a sum holding exp(0) = 1 does not see): the rows
// route's exponential, whose loop would otherwise be bound by the
// instructions of expf rather than by bytes
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float finish(float m, float l) {
  return m + logf(l == 0.0f ? 1.0f : l);
}

// thread t of NT adds its share of one row to (m, l): a scalar head up
// to the row's first 16-byte boundary, 16-byte chunks strided over the
// threads, and a scalar tail
template <int NT, typename T>
__device__ __forceinline__ void row_partial(const T* __restrict__ row,
                                            int64_t v, int t, float& m,
                                            float& l) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t mis = (int64_t)(reinterpret_cast<uintptr_t>(row) & 15);
  int64_t head = ((16 - mis) & 15) / (int64_t)sizeof(T);
  if (head > v) head = v;
  const int64_t nv = (v - head) / VEC;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
#pragma unroll 4
  for (int64_t c = t; c < nv; c += NT) add_chunk<VEC>(__ldg(body + c), m, l);
  const int64_t tail = head + nv * VEC;
  const int64_t scalars = head + (v - tail);  // at most 2 * (VEC - 1)
  for (int64_t j = t; j < scalars; j += NT)
    add_one(to_f32(row[j < head ? j : tail + (j - head)]), m, l);
}

__device__ __forceinline__ void warp_merge(float& m, float& l) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, mo, lo);
  }
}

// ---- "block": the first design ---------------------------------------------

template <typename T>
__global__ void __launch_bounds__(LSE_THREADS)
row_lse_kernel(const T* __restrict__ x, float* __restrict__ lse, int64_t v,
               int vec) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float m_s[LSE_THREADS / 32], l_s[LSE_THREADS / 32];
  const T* row = x + (int64_t)blockIdx.x * v;
  float m = NEG_BIG, l = 0.0f;
  int64_t tail = 0;
  if (vec) {  // the row starts on a 16-byte boundary
    const int64_t nv = v / VEC;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int64_t c = threadIdx.x; c < nv; c += LSE_THREADS)
      add_chunk<VEC>(__ldg(rv + c), m, l);
    tail = nv * VEC;
  }
  for (int64_t c = tail + threadIdx.x; c < v; c += LSE_THREADS)
    add_one(to_f32(row[c]), m, l);
  warp_merge(m, l);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = m_s[0];
    l = l_s[0];
    for (int w = 1; w < LSE_THREADS / 32; ++w) merge(m, l, m_s[w], l_s[w]);
    lse[blockIdx.x] = finish(m, l);
  }
}

// ---- "wide": one block per row, any alignment --------------------------------

template <typename T>
__global__ void __launch_bounds__(LSE_THREADS)
row_lse_wide_kernel(const T* __restrict__ x, float* __restrict__ lse,
                    int64_t v) {
  __shared__ float m_s[LSE_THREADS / 32], l_s[LSE_THREADS / 32];
  float m = NEG_BIG, l = 0.0f;
  row_partial<LSE_THREADS>(x + (int64_t)blockIdx.x * v, v, threadIdx.x, m, l);
  warp_merge(m, l);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = m_s[0];
    l = l_s[0];
    for (int w = 1; w < LSE_THREADS / 32; ++w) merge(m, l, m_s[w], l_s[w]);
    lse[blockIdx.x] = finish(m, l);
  }
}

// ---- "warp": one warp per row, the warps walking the rows --------------------

template <typename T>
__global__ void __launch_bounds__(LSE_THREADS)
row_lse_warp_kernel(const T* __restrict__ x, float* __restrict__ lse,
                    int64_t n, int64_t v) {
  constexpr int WARPS = LSE_THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int64_t step = (int64_t)gridDim.x * WARPS;
  for (int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5); r < n;
       r += step) {
    float m = NEG_BIG, l = 0.0f;
    row_partial<32>(x + r * v, v, lane, m, l);
    warp_merge(m, l);
    if (lane == 0) lse[r] = finish(m, l);
  }
}

// ---- "rows": tiles of narrow rows through shared memory ---------------------

struct RowsGeo {
  int tile_rows;    // rows a tile
  int grid;         // blocks
  int stage_bytes;  // one stage: the tile, 16 bytes before it, 16 after
  int smem;         // two stages and two mbarriers
  int rot_div;      // a lane's rotation: rot_epw * ((lane / rot_div) % rot_vw)
  int rot_vw;
  int rot_epw;
};

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// the tiles evened out so that every block walks the same number of
// them, give or take one
RowsGeo rows_geometry(int64_t n, int64_t v, int sz, int sms) {
  RowsGeo g{};
  const int64_t row_bytes = v * sz;
  const int64_t passes = ROWS_TILE_BYTES / (row_bytes * ROWS_THREADS);
  const int tile_rows = ROWS_THREADS * (int)(passes > 1 ? passes : 1);
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  const int64_t full = (int64_t)ROWS_PER_SM * sms;
  const int64_t grid = tiles < full ? tiles : full;
  const int64_t per_block = (tiles + grid - 1) / grid;
  g.tile_rows = (int)((n + grid * per_block - 1) / (grid * per_block));
  g.grid = (int)((n + g.tile_rows - 1) / g.tile_rows);
  if (g.grid > grid) g.grid = (int)grid;
  const int64_t stage = ((g.tile_rows * row_bytes + 15) / 16) * 16 + 32;
  g.stage_bytes = stage > SMEM_MAX ? SMEM_MAX : (int)stage;
  g.smem = stage > SMEM_MAX ? SMEM_MAX + 1 : 2 * g.stage_bytes + 16;
  // a row stride of vw words sharing the factor f with the 32 banks puts
  // lanes 32/f apart on one bank: those lanes start f words apart
  g.rot_div = 32;
  g.rot_vw = 1;
  g.rot_epw = 1;
  if (row_bytes % 4 == 0) {
    const int vw = (int)(row_bytes / 4 < (1 << 30) ? row_bytes / 4 : 1);
    const int f = gcd(vw, 32);
    if (f > 1) {
      g.rot_div = 32 / f;
      g.rot_vw = vw;
      g.rot_epw = 4 / sz;
    }
  }
  return g;
}

template <typename T>
__global__ void __launch_bounds__(ROWS_THREADS)
row_lse_tile_kernel(const T* __restrict__ x, float* __restrict__ lse,
                    int64_t n, int v, RowsGeo geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int SZ = sizeof(T);
  const int tid = threadIdx.x;
  const int64_t row_bytes = (int64_t)v * SZ;
  const int64_t tiles = (n + geo.tile_rows - 1) / geo.tile_rows;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * geo.stage_bytes);
  int64_t k = blockIdx.x;
  if (k >= tiles) return;
  if (tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    mbar_fence_init();
  }
  __syncthreads();

  // tile kk's bytes [s, e): the body [a0, a1) on 16-byte boundaries, the
  // head [s, a0) and the tail [a1, e) of fewer than 16 bytes each. Byte
  // s lands at offset (s & 15) of its stage, so the body lands aligned.
  auto span = [&](int64_t kk, uintptr_t& s, uintptr_t& a0, uintptr_t& a1,
                  uintptr_t& e) {
    const int64_t r0 = kk * geo.tile_rows;
    const int64_t rows = n - r0 < geo.tile_rows ? n - r0 : geo.tile_rows;
    s = base + (uintptr_t)(r0 * row_bytes);
    e = s + (uintptr_t)(rows * row_bytes);
    a0 = (s + 15) & ~(uintptr_t)15;
    if (a0 > e) a0 = e;
    a1 = e & ~(uintptr_t)15;
    if (a1 < a0) a1 = a0;
  };
  // thread 0: the body's bulk copy into stage `st`
  auto issue = [&](int64_t kk, int st) {
    uintptr_t s, a0, a1, e;
    span(kk, s, a0, a1, e);
    unsigned char* dst = smem + st * geo.stage_bytes + (s & 15) + (a0 - s);
    const uint32_t bar = smem_u32(&bars[st]);
    if (a1 > a0) {
      mbar_expect_tx(bar, (uint32_t)(a1 - a0));
      bulk_g2s(dst, reinterpret_cast<const void*>(a0), (uint32_t)(a1 - a0),
               bar);
    } else {
      mbar_arrive(bar);
    }
  };
  // threads 32..: one head or tail value each, loaded into a register;
  // `off` is its offset in the stage, -1 for none
  constexpr int SCALAR0 = 32;
  auto load_scalar = [&](int64_t kk, T& val, int& off) {
    off = -1;
    const int j = tid - SCALAR0;
    if (j < 0 || j >= 2 * (16 / SZ)) return;
    uintptr_t s, a0, a1, e;
    span(kk, s, a0, a1, e);
    const int head = (int)((a0 - s) / SZ), tail = (int)((e - a1) / SZ);
    uintptr_t at;
    if (j < head)
      at = s + (uintptr_t)j * SZ;
    else if (j - head < tail)
      at = a1 + (uintptr_t)(j - head) * SZ;
    else
      return;
    val = __ldg(reinterpret_cast<const T*>(at));
    off = (int)((s & 15) + (at - s));
  };

  // the first two tiles: bodies into stages 0 and 1, the first one's
  // scalars stored, the second one's kept in a register (`pend`) until
  // the pass that reads stage 0; every later tile is issued two passes
  // ahead into the stage just read, its scalars stored a pass later
  T val = T(), pend = T();
  int off, pend_off = -1;
  if (tid == 0) {
    issue(k, 0);
    if (k + gridDim.x < tiles) issue(k + gridDim.x, 1);
  }
  load_scalar(k, val, off);
  if (k + gridDim.x < tiles) load_scalar(k + gridDim.x, pend, pend_off);
  if (off >= 0) {
    *reinterpret_cast<T*>(smem + off) = val;
    fence_proxy_async_smem();  // before a later bulk copy over it
  }
  __syncthreads();

  const int lane = tid & 31;
  const int rot = geo.rot_epw * ((lane / geo.rot_div) % geo.rot_vw);
  for (int it = 0; k < tiles; ++it, k += gridDim.x) {
    const int st = it & 1;
    mbar_wait(smem_u32(&bars[st]), (uint32_t)((it >> 1) & 1));
    const int64_t r0 = k * geo.tile_rows;
    const int rows = (int)(n - r0 < geo.tile_rows ? n - r0 : geo.tile_rows);
    const unsigned char* tile =
        smem + st * geo.stage_bytes + ((base + r0 * row_bytes) & 15);
    for (int r = tid; r < rows; r += ROWS_THREADS) {
      const T* row = reinterpret_cast<const T*>(tile + r * row_bytes);
      float m = NEG_BIG, l = 0.0f;
      if (geo.rot_div == 32) {  // no rotation: plain loops
        for (int c = 0; c < v; ++c) m = fmaxf(m, to_f32(row[c]));
        const float mb = m * LOG2E;
        for (int c = 0; c < v; ++c)
          l += exp2_approx(fmaf(to_f32(row[c]), LOG2E, -mb));
      } else {  // one trip count for every lane: the column wraps at V
        for (int i = 0, c = rot; i < v; ++i, c = c + 1 == v ? 0 : c + 1)
          m = fmaxf(m, to_f32(row[c]));
        const float mb = m * LOG2E;
        for (int i = 0, c = rot; i < v; ++i, c = c + 1 == v ? 0 : c + 1)
          l += exp2_approx(fmaf(to_f32(row[c]), LOG2E, -mb));
      }
      lse[r0 + r] = finish(m, l);
    }
    // the next tile's scalars into stage st ^ 1, which this pass did not
    // read; then the scalars of the tile two passes ahead into `pend`
    if (pend_off >= 0) {
      *reinterpret_cast<T*>(smem + (st ^ 1) * geo.stage_bytes + pend_off) =
          pend;
      fence_proxy_async_smem();  // before a later bulk copy over it
    }
    const int64_t k2 = k + 2 * (int64_t)gridDim.x;
    pend_off = -1;
    if (k2 < tiles) load_scalar(k2, pend, pend_off);
    __syncthreads();  // stage st read by every thread
    if (k2 < tiles && tid == 0) {
      fence_proxy_async_smem();
      issue(k2, st);
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

template <typename T>
int launch_rows(const void* x, void* lse, int64_t n, int64_t v,
                const RowsGeo& geo, cudaStream_t s) {
  auto kernel = row_lse_tile_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<geo.grid, ROWS_THREADS, geo.smem, s>>>(
      static_cast<const T*>(x), static_cast<float*>(lse), n, (int)v, geo);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp(const void* x, void* lse, int64_t n, int64_t v,
                cudaStream_t s) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const int warps = LSE_THREADS / 32;
  const int64_t want = (n + warps - 1) / warps;
  const int64_t full = (int64_t)sms * (2048 / LSE_THREADS);
  row_lse_warp_kernel<T><<<(unsigned)(want < full ? want : full),
                           LSE_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(lse), n, v);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mxt_row_lse(const void* x, void* lse, int64_t n, int64_t v,
                           int vec, int dtype, void* stream) {
  if (n <= 0) return 0;
  if (v < 1 || n > 2147483647) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      row_lse_kernel<float><<<(unsigned)n, LSE_THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(lse), v, vec);
      break;
    case kBF16:
      row_lse_kernel<__nv_bfloat16><<<(unsigned)n, LSE_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<float*>(lse), v,
          vec);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int mxt_lse_wide(const void* x, void* lse, int64_t n, int64_t v,
                            int dtype, void* stream) {
  if (n <= 0) return 0;
  if (v < 1 || n > 2147483647) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      row_lse_wide_kernel<float><<<(unsigned)n, LSE_THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(lse), v);
      break;
    case kBF16:
      row_lse_wide_kernel<__nv_bfloat16><<<(unsigned)n, LSE_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<float*>(lse), v);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int mxt_lse_warp(const void* x, void* lse, int64_t n, int64_t v,
                            int dtype, void* stream) {
  if (n <= 0) return 0;
  if (v < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_warp<float>(x, lse, n, v, s);
    case kBF16: return launch_warp<__nv_bfloat16>(x, lse, n, v, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mxt_lse_rows(const void* x, void* lse, int64_t n, int64_t v,
                            int dtype, void* stream) {
  if (n <= 0) return 0;
  if (v < 1 || v > 65536) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const int sz = dtype == kF32 ? 4 : 2;
  const RowsGeo g = rows_geometry(n, v, sz, sms);
  if (g.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_rows<float>(x, lse, n, v, g, s);
    case kBF16: return launch_rows<__nv_bfloat16>(x, lse, n, v, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
