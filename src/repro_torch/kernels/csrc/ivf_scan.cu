// Probed posting-list scan for Hopper (sm_90a): float32 or bfloat16 lists.
//
// ivf_scan replaces the Pallas kernel ivf_scan of
//   src/repro/kernels/ivf_scan.py:64 (body _kernel :37, pallas_call :94)
//   and its wrapper src/repro/kernels/ops.py:74-88: for each query, the
//   rows of the nprobe lists sel[b] are scored in float32 against it (bf16
//   operands widened first), rows whose id is < 0 are pads, and the top kp
//   are kept as (score, doc id) in lax.top_k's order over the gathered
//   lists: (score desc, flat position probe*lmax + offset asc), the order
//   of the reference's "ref" mode (src/repro/kernels/ref.py:38-56).  (The
//   Pallas kernel folds with the non-tie-aware networks keyed by doc id,
//   so on exact ties its "interpret" mode may order otherwise.)  Fewer
//   than kp real rows leave (-inf, -1) pads.
//
// Bound on this card: device-memory bytes.  A query reads the real rows of
// its probed lists once (64 x 702 x 768 x 4 B = 138 MB at most at the
// smoke's index, 41 us at 3.35 TB/s), their ids, and 2 FLOP per 4 B read,
// far below the f32 ridge (~20 FLOP/B).
//
// What the design does about it: it is the f32 scan of the fused IVF turn
// (ivf_stages.cuh scan_lists_kernel) without the `own` mask: one
// 256-thread block per (query, probed list, 128-row slice), 64 x 6 = 384
// blocks for one query at the smoke's shape; the slice's ids are read
// first, empty slices write only a count, pad rows are never loaded, and
// a warp loads 4 real rows at once (float4 loads, or 16 bytes = 8 bf16
// values); one warp sorts the block's entries in registers and writes its
// real ones, and at kp <= 128 the launch folds them itself (the last
// slice of a list merges the list, the last list the query), else the
// merge kernel folds them in the passes of tiling.merge_plan.  The
// float32 path runs the same code in the same order as fused_scan_ivf, so
// on the fused turn's own selection it gives that turn's values and ids
// bit for bit.
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
int ivf_scan_t(const T* q, const T* list_vecs, const int* list_ids, int p,
               const int* sel, int B, int nprobe, int lmax, int d, int kp,
               float* cand_v, int* cand_i, int* cand_p, int* cand_n,
               int* counters, float* out_v, int* out_i, cudaStream_t st) {
  const int nsplit = (lmax + SCAN_ROWS - 1) / SCAN_ROWS;
  const int w = min(kp, SCAN_ROWS);
  if (counters != nullptr && w != kp) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_scan<fused_common::P_F32>(
      q, list_vecs, list_ids, p, sel, nprobe, (const int*)nullptr, B, nprobe,
      lmax, d, w, 1, 1, (const int*)nullptr, cand_v, cand_i, cand_p, cand_n,
      counters, 0, kp, out_v, out_i, (int*)nullptr, false, st);
  if (err != cudaSuccess || counters != nullptr) return (int)err;
  return merge_topk_f32(cand_v, cand_i, cand_p, cand_n, B, nprobe * nsplit,
                        w, kp, -1, out_v, out_i, nullptr, st);
}

}  // namespace

extern "C" {

// q (B, d) and list_vecs (p, lmax, d), both float32 (dtype 0) or bfloat16
// (dtype 1); list_ids (p, lmax) int32, < 0 for a pad; sel (B, nprobe)
// int32 (a list outside [0, p) scans as empty).  Scratch cand_* holds
// B * nprobe * ceil(lmax / 128) * min(kp, 128) entries and what
// merge_topk_f32 adds past them, cand_n one count a slice; with counters
// (B * nprobe + B zeroed ints, kp <= 128) the scan launch folds the
// lists itself.  out_v / out_i (B, kp) receive each query's top kp
// scores and doc ids.
int ivf_scan(const void* q, const void* list_vecs, int dtype,
             const int* list_ids, int p, const int* sel, int B, int nprobe,
             int lmax, int d, int kp, float* cand_v, int* cand_i,
             int* cand_p, int* cand_n, int* counters, float* out_v,
             int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return ivf_scan_t(static_cast<const __nv_bfloat16*>(q),
                      static_cast<const __nv_bfloat16*>(list_vecs), list_ids,
                      p, sel, B, nprobe, lmax, d, kp, cand_v, cand_i, cand_p,
                      cand_n, counters, out_v, out_i, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return ivf_scan_t(static_cast<const float*>(q),
                    static_cast<const float*>(list_vecs), list_ids, p, sel,
                    B, nprobe, lmax, d, kp, cand_v, cand_i, cand_p, cand_n,
                    counters, out_v, out_i, st);
}

}  // extern "C"
