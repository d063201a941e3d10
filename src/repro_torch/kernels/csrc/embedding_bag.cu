// EmbeddingBag (fused row gather + weighted sum) for Hopper (sm_90a),
// float32.
//
// embedding_bag_f32 replaces the Pallas kernel embedding_bag of
//   src/repro/kernels/embedding_bag.py:49 (body _kernel :28, pallas_call
//   :63): out[b] = sum over l of table[ids[b, l]] * w[b, l], ids -1 (any
//   negative id) a pad that adds nothing, the sum in float32 and
//   sequential over l: acc = acc + row * w, rounded after the product and
//   after the sum (__fmul_rn / __fadd_rn, no FMA contraction), which is
//   the Pallas kernel's order and the plain version's (kernels/ref.py
//   embedding_bag), so kernel and plain version agree bit for bit.  A pad
//   is skipped, not multiplied by 0: acc starts at +0 and a round-to-
//   nearest sum is -0 only when both terms are, so acc + (+-0) == acc.
//
// Bound on this card: device-memory bytes.  A bag of L ids reads L rows of
// d floats once (50 x 1 KB for the two-tower user history) and writes one
// row; no arithmetic to speak of (2 flops a float read).  At B = 1 the
// 51 KB take 0.015 us at 3.35 TB/s, so latency sets the time: the rows
// wait on the ids, and rows loaded a few at a time wait on each other.
//
// What the design does about it: two kernels, chosen by B
// (tiling.plan_embedding_bag, the threshold tiling.BAG_ROWS_MAX_B from
// chip_smoke.py --bag-times).
//  * bag_rows_kernel, small B (the served user tower is B = 1): one warp
//    a block, one block per (bag, slice of SLICE = 32 columns: one
//    128-byte line of a row), so a bag's bytes spread over ceil(d / 32)
//    SMs (8 at d = 256).  The warp loads the ids and weights of up to
//    ROWS_CHUNK rows into shared memory, then issues every real row's
//    slice of that chunk at once as cp.async copies into shared memory
//    (16 bytes each; 4 when the table is not 16-byte aligned or d is not
//    a multiple of 4) behind one wait: two memory round trips for the
//    served L = 50, where a warp-a-bag loop takes eight.  Lane c then
//    sums column c of the slice from shared memory in bag order (a pad's
//    slice staged as zeros with weight 0: no branch in the sum);
//  * embedding_bag_kernel, large B: one warp per bag, 4 bags (128
//    threads) per block, bags on grid x (the 262,144 bags of serve_bulk
//    exceed a grid's y extent); a warp first loads up to 32 of its bag's
//    ids and weights, one per lane, then broadcasts them by shuffle; the
//    row loads of UNROLL ids are issued before their sums, so a warp
//    keeps UNROLL rows in flight while the sum stays in l order; a row of
//    d = 256 floats is read as 64 float4 (2 per lane, coalesced); wider
//    rows go in chunks of COLS float4 a lane; rows that are not 16-byte
//    aligned take a scalar path of the same order.  With thousands of
//    bags in flight the card's bandwidth, not a bag's latency, is the
//    limit, and it reads each row once with no shared-memory staging;
//  * a pad row is never read;
//  * row offsets are 64-bit: the two-tower table (3,145,728 x 256 f32) is
//    3.22 GB, past 2^31 bytes.
//
// Plain C interface (bound with ctypes): returns a cudaError_t as int, 0
// when the launch was accepted.  Ids must be < the table's rows: nothing
// here checks, so ids are checked where they come in from the host
// (models/recsys.py).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fused_common.cuh"

namespace {

using fused_common::cp_async16;
using fused_common::cp_async4;
using fused_common::cp_async_wait_all;

constexpr int WARPS = 4;    // bags per block
constexpr int UNROLL = 8;   // rows in flight per warp
constexpr int COLS = 2;     // float4 (or float) columns per lane per chunk
// bag_rows_kernel: columns of a slice (a lane each) and rows staged at
// once (tiling.BAG_SLICE, BAG_ROWS_CHUNK)
constexpr int SLICE = 32;
constexpr int ROWS_CHUNK = 64;

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 add_scaled(float4 acc, float4 x, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(x.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(x.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(x.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(x.w, w));
  return acc;
}

__device__ __forceinline__ float add_scaled(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float4 zero<float4>() { return zero4(); }
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

// grid (ceil(B / WARPS)).  Warp w of block x sums bag x*WARPS + w.  The
// table and the output are rows of `width` elements of V (float4 or
// float).
template <typename V>
__global__ void __launch_bounds__(WARPS * 32)
embedding_bag_kernel(const V* __restrict__ table, int width,
                     const int* __restrict__ ids,
                     const float* __restrict__ weights, int B, int L,
                     V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (bag >= B) return;  // warp-uniform
  const int* bag_ids = ids + (size_t)bag * L;
  const float* bag_w =
      weights == nullptr ? nullptr : weights + (size_t)bag * L;
  for (int c0 = 0; c0 < width; c0 += 32 * COLS) {
    V acc[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[j] = zero<V>();
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int n = min(32, L - l0);
      const int my_id = lane < n ? __ldg(bag_ids + l0 + lane) : -1;
      const float my_w =
          lane < n && bag_w != nullptr ? __ldg(bag_w + l0 + lane) : 1.f;
      for (int u0 = 0; u0 < n; u0 += UNROLL) {
        V x[UNROLL][COLS];
        int id[UNROLL];
        float w[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          id[u] = __shfl_sync(0xffffffffu, my_id, (u0 + u) & 31);
          w[u] = __shfl_sync(0xffffffffu, my_w, (u0 + u) & 31);
          if (u0 + u >= n) id[u] = -1;
          const V* row = table + (size_t)(id[u] < 0 ? 0 : id[u]) * width;
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            const int c = c0 + j * 32 + lane;
            x[u][j] = id[u] >= 0 && c < width ? __ldg(row + c) : zero<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (id[u] < 0) continue;  // pad: warp-uniform, never read
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            acc[j] = add_scaled(acc[j], x[u][j], w[u]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = c0 + j * 32 + lane;
      if (c < width) out[(size_t)bag * width + c] = acc[j];
    }
  }
}

// grid (B, ceil(d / SLICE)), one warp.  Block (b, s) sums columns
// [s*SLICE, s*SLICE + SLICE) of bag b: per chunk of ROWS_CHUNK ids, the
// ids and weights into shared memory, every real row's slice copied in
// by cp.async (VEC: 16-byte pieces, the table 16-byte aligned and d a
// multiple of 4; else 4-byte ones), one wait, then lane c adds column c
// of the rows in bag order.
template <bool VEC>
__global__ void __launch_bounds__(32)
bag_rows_kernel(const float* __restrict__ table, int d,
                const int* __restrict__ ids,
                const float* __restrict__ weights, int L,
                float* __restrict__ out) {
  __shared__ __align__(16) float rows[ROWS_CHUNK][SLICE];
  __shared__ int sid[ROWS_CHUNK];
  __shared__ float sw[ROWS_CHUNK];
  const int lane = threadIdx.x;
  const int bag = blockIdx.x;
  const int c0 = blockIdx.y * SLICE;
  const int ncols = min(SLICE, d - c0);
  constexpr int PIECE = VEC ? 4 : 1;      // floats a copy
  constexpr int PIECES = SLICE / PIECE;   // copies a row of a whole slice
  constexpr int LOG_PIECES = VEC ? 3 : 5;
  static_assert(PIECES == 1 << LOG_PIECES, "a slice is 32 floats");
  const int* bag_ids = ids + (size_t)bag * L;
  const float* bag_w =
      weights == nullptr ? nullptr : weights + (size_t)bag * L;
  float acc = 0.f;
  for (int l0 = 0; l0 < L; l0 += ROWS_CHUNK) {
    const int n = min(ROWS_CHUNK, L - l0);
    // every id and weight of the chunk in flight before the first store
    int my_id[ROWS_CHUNK / 32];
    float my_w[ROWS_CHUNK / 32];
#pragma unroll
    for (int k = 0; k < ROWS_CHUNK / 32; ++k) {
      const int t = k * 32 + lane;
      my_id[k] = t < n ? __ldg(bag_ids + l0 + t) : -1;
      my_w[k] = t < n && bag_w != nullptr ? __ldg(bag_w + l0 + t) : 1.f;
      if (my_id[k] < 0) my_w[k] = 0.f;  // a pad adds 0 * 0 (below)
    }
#pragma unroll
    for (int k = 0; k < ROWS_CHUNK / 32; ++k) {
      sid[k * 32 + lane] = my_id[k];
      sw[k * 32 + lane] = my_w[k];
    }
    __syncwarp();
    for (int x = lane; x < (n << LOG_PIECES); x += 32) {
      const int r = x >> LOG_PIECES;
      const int c = (x & (PIECES - 1)) * PIECE;
      if (c >= ncols) continue;
      const int id = sid[r];
      if (id < 0) {  // a pad row is never read: its slice is zeros
        if constexpr (VEC)
          *reinterpret_cast<float4*>(&rows[r][c]) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        else
          rows[r][c] = 0.f;
        continue;
      }
      const float* src = table + (size_t)id * d + c0 + c;
      if constexpr (VEC)
        cp_async16(&rows[r][c], src);
      else
        cp_async4(&rows[r][c], src);
    }
    cp_async_wait_all();
    __syncwarp();
    // a pad's +0 * 0 leaves acc as it is: acc starts at +0 and a
    // round-to-nearest sum is -0 only when both terms are, so acc is
    // never -0 and acc + (+0) == acc; the sum needs no branch
    if (lane < ncols) {
#pragma unroll 8
      for (int r = 0; r < n; ++r)
        acc = __fadd_rn(acc, __fmul_rn(rows[r][lane], sw[r]));
    }
    __syncwarp();  // the next chunk's ids and rows overwrite these
  }
  if (lane < ncols) out[(size_t)bag * d + c0 + lane] = acc;
}

}  // namespace

extern "C" {

// table (V, d) f32; ids (B, L) int32, negative = pad; weights (B, L) f32
// or null (all 1); out (B, d) f32.  rows_kernel != 0: bag_rows_kernel
// (small B), else embedding_bag_kernel.  Rows are read in 16-byte pieces
// when d is a multiple of 4 and the table (and, for embedding_bag_kernel,
// out) is 16-byte aligned.
int embedding_bag_f32(const float* table, int d, const int* ids,
                      const float* weights, int B, int L, float* out,
                      int rows_kernel, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_kernel) {
    const dim3 grid(B, (d + SLICE - 1) / SLICE);
    const bool vec = d % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(table) & 15) == 0;
    if (vec)
      bag_rows_kernel<true><<<grid, 32, 0, st>>>(table, d, ids, weights, L,
                                                  out);
    else
      bag_rows_kernel<false><<<grid, 32, 0, st>>>(table, d, ids, weights, L,
                                                   out);
    return (int)cudaGetLastError();
  }
  const dim3 grid((B + WARPS - 1) / WARPS);
  const bool vec4 = d % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(table) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (vec4)
    embedding_bag_kernel<float4><<<grid, WARPS * 32, 0, st>>>(
        reinterpret_cast<const float4*>(table), d / 4, ids, weights, B, L,
        reinterpret_cast<float4*>(out));
  else
    embedding_bag_kernel<float><<<grid, WARPS * 32, 0, st>>>(
        table, d, ids, weights, B, L, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
