// Centroid top-k for Hopper (sm_90a): float32 or bfloat16 operands.
//
// centroid_topk replaces the Pallas kernel centroid_topk of
//   src/repro/kernels/centroid_topk.py:66 (body _kernel :40, pallas_call
//   :82) and its wrapper src/repro/kernels/ops.py:49-67: scores a query
//   batch (B, d) against p centroids (p, d) in float32 (bf16 operands
//   widened first, as the kernel's `.astype(jnp.float32)`) and keeps each
//   query's top kp as (score, centroid index), ordered by (score desc,
//   index asc): lax.top_k's order over the exact scores, the reference's
//   "ref" mode.  Centroids past p are never scored, so they never compete;
//   the reference's wrapper instead pads p with zero rows and masks ids >=
//   p after its top-kp, where zero pads can outrank real negative scores.
//
// Bound on this card: device-memory bytes.  The centroid table is read
// once (16,384 x 768 x 4 B = 50.3 MB at the smoke's index, 15 us at 3.35
// TB/s); 2 FLOP a query per 4 B read stays below the f32 ridge (~20
// FLOP/B) up to B = 40.  The (B, kp) outputs are small.
//
// What the design does about it: it is stage 1 of the fused IVF turn
// (ivf_stages.cuh centroid_chunk_kernel, merge_topk_f32 of fused_turn.cu).
// One block per (128-centroid chunk, tile of queries) stages the tile's
// queries in dynamic shared memory and reads each centroid row once for
// all of them: tiles of 8 queries at B <= 8 and of 32 above, so the table
// is read once per call up to B = 32.  A warp loads 4 centroid rows at
// once, and each staged query value it reads serves the 4 rows.  Warp t
// then sorts the 128 scores of queries t, t + 8, ... in registers
// (topk_tie::warp_sort, no barrier), or at one query the block counts
// each score's rank, and writes each query's best min(kp, 128): a chunk
// holds no more.
// At B = 1 and kp <= 128 the chunk launch folds the query's chunk lists
// itself (tiling.select_fold: arrival counters, groups of 16 chunks, then
// the groups, each by topk_tie::merge_warps).  Otherwise merge_kernel
// folds them, one block per query: at kp <= 128 by warps in registers,
// then pairwise (merge_warps); the top-h cache's lists of 128 grow to kp
// = 1,024 in groups of 16 on 8 blocks a query, then one block folds the 8
// (tiling.merge_plan).  The
// float32 path runs the same code in the same order as the fused turn's
// stage 1, so its scores and ids are those of fused_turn_ivf's sel bit
// for bit.  Simple first: CUDA-core FMAs, no TMA, no tensor cores.
//
// Plain C interface (bound with ctypes): returns a cudaError_t as int, 0
// when every launch was accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_common.cuh"
#include "ivf_stages.cuh"
#include "topk_tie.cuh"

namespace {

template <typename T>
int centroid_topk_t(const T* q, const T* cents, int p, int B, int d, int kp,
                    float* s1_v, int* s1_i, int* counters, float* out_v,
                    int* out_i, cudaStream_t st) {
  const int nchunks = (p + CENTROID_CHUNK - 1) / CENTROID_CHUNK;
  const int w1 = min(kp, CENTROID_CHUNK);
  const cudaError_t err = launch_chunks<fused_common::P_F32>(
      q, cents, B, p, d, kp, 1, (const int*)nullptr, s1_v, s1_i, counters,
      out_v, out_i, st);
  if (err != cudaSuccess || counters != nullptr) return (int)err;
  return merge_topk_f32(s1_v, s1_i, s1_i, nullptr, B, nchunks, w1, kp,
                        topk_tie::PAD_POS, out_v, out_i, nullptr, st);
}

}  // namespace

extern "C" {

// q (B, d) and cents (p, d), both float32 (dtype 0) or bfloat16 (dtype 1);
// scratch s1_* holds B * ceil(p / 128) * min(kp, 128) entries and what
// merge_topk_f32 adds past them (tiling.merge_scratch); out_v / out_i
// (B, kp) receive each query's top kp scores and centroid indices (kp a
// power of two <= 2,048; slots past p are (-inf, INT_MAX)).
int centroid_topk(const void* q, const void* cents, int dtype, int p, int B,
                  int d, int kp, float* s1_v, int* s1_i, int* counters,
                  float* out_v, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return centroid_topk_t(static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(cents), p, B, d,
                           kp, s1_v, s1_i, counters, out_v, out_i, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return centroid_topk_t(static_cast<const float*>(q),
                         static_cast<const float*>(cents), p, B, d, kp, s1_v,
                         s1_i, counters, out_v, out_i, st);
}

}  // extern "C"
