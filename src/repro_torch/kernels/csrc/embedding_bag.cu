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
// 51 KB take 0.015 us at 3.35 TB/s, so latency sets the time: L dependent
// row loads would take L memory round trips.
//
// What the design does about it:
//  * one warp per bag, 4 bags (128 threads) per block, bags on grid x (the
//    262,144 bags of serve_bulk exceed a grid's y extent);
//  * a warp first loads up to 32 of its bag's ids and weights, one per
//    lane, then broadcasts them by shuffle, so no row load waits on an id
//    load; the row loads of UNROLL ids are issued before their sums, so a
//    warp keeps UNROLL rows in flight while the sum stays in l order;
//  * a row of d = 256 floats is read once, as 64 float4 (2 per lane,
//    coalesced), and summed in f32 registers; wider rows go in chunks of
//    COLS float4 a lane; rows that are not 16-byte aligned take a scalar
//    path of the same order;
//  * a pad row is never read;
//  * row offsets are 64-bit: the two-tower table (3,145,728 x 256 f32) is
//    3.22 GB, past 2^31 bytes.
// Simple first: no TMA, no cp.async pipelining, no split of a bag's
// columns across warps at small B.
//
// Plain C interface (bound with ctypes): returns a cudaError_t as int, 0
// when the launch was accepted.  Ids must be < the table's rows: nothing
// here checks, so ids are checked where they come in from the host
// (models/recsys.py).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARPS = 4;    // bags per block
constexpr int UNROLL = 8;   // rows in flight per warp
constexpr int COLS = 2;     // float4 (or float) columns per lane per chunk

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

}  // namespace

extern "C" {

// table (V, d) f32; ids (B, L) int32, negative = pad; weights (B, L) f32
// or null (all 1); out (B, d) f32.  Rows are read as float4 when d is a
// multiple of 4 and table and out are 16-byte aligned.
int embedding_bag_f32(const float* table, int d, const int* ids,
                      const float* weights, int B, int L, float* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
