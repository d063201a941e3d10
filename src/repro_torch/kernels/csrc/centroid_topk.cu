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
// (ivf_stages.cuh centroid_chunk_kernel, merge_topk_f32 of fused_turn.cu):
// one 256-thread block per (128-centroid chunk, 8 queries) reads each
// centroid row once for its 8 queries, a warp a row (float4 loads, or 16
// bytes = 8 bf16 values), so p = 16,384 puts 128 blocks on the 132 SMs at
// B <= 8; each block's sorted top min(kp, 128) leaves the SM and the merge
// kernel folds a query's 128 lists, in as many passes as
// tiling.merge_plan gives (top-h = 1,024: three passes).  The float32
// path runs the same code in the same order as the fused turn's stage 1,
// so its scores and ids are those of fused_turn_ivf's sel bit for bit.
// Simple first: CUDA-core FMAs, no TMA, no tensor cores.
//
// Plain C interface (bound with ctypes): returns a cudaError_t as int, 0
// when every launch was accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_common.cuh"
#include "ivf_stages.cuh"

namespace {

template <typename T>
int centroid_topk_t(const T* q, const T* cents, int p, int B, int d, int kp,
                    int group, float* s1_v, int* s1_i, float* out_v,
                    int* out_i, cudaStream_t st) {
  const int nchunks = (p + CENTROID_CHUNK - 1) / CENTROID_CHUNK;
  const cudaError_t err = fused_common::launch(
      centroid_chunk_kernel<fused_common::P_F32, T>,
      dim3(nchunks, (B + QTILE - 1) / QTILE), ROW_THREADS,
      QTILE * d * (int)sizeof(float), st, q, cents, B, p, d, kp, 1,
      (const int*)nullptr, s1_v, s1_i);
  if (err != cudaSuccess) return (int)err;
  return merge_topk_f32(s1_v, s1_i, s1_i, B, nchunks, kp, group, out_v, out_i,
                        nullptr, st);
}

}  // namespace

extern "C" {

// q (B, d) and cents (p, d), both float32 (dtype 0) or bfloat16 (dtype 1);
// scratch s1_* holds B * ceil(p / 128) * kp entries, merged `group` lists a
// merge block (tiling.merge_group(kp)); out_v / out_i (B, kp) receive each
// query's top kp scores and centroid indices (kp a power of two <= 2,048;
// slots past p are (-inf, INT_MAX)).
int centroid_topk(const void* q, const void* cents, int dtype, int p, int B,
                  int d, int kp, int group, float* s1_v, int* s1_i,
                  float* out_v, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return centroid_topk_t(static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(cents), p, B, d,
                           kp, group, s1_v, s1_i, out_v, out_i, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return centroid_topk_t(static_cast<const float*>(q),
                         static_cast<const float*>(cents), p, B, d, kp, group,
                         s1_v, s1_i, out_v, out_i, st);
}

}  // extern "C"
