// Device and host pieces shared by the port's CUDA sources.
//
// warp_row_dots: the fixed-order row scoring of the fused IVF kernels
//   (fused_turn.cu) that the IVF-PQ exact re-rank (pq_adc.cu) reuses, so
//   a row scores the same bits in every kernel and at any batch size.
// merge_topk_f32 / select_probes_f32: the candidate merge and the
//   centroid stage (stage 1) of fused_turn.cu, exported with C linkage
//   so pq_adc.cu launches the same kernels inside the one library.
#pragma once

#include <cuda_runtime.h>

namespace fused_common {

constexpr int UNROLL = 8;  // float4 loads in flight per lane

// Scores one row against nq <= NQ queries staged in shared memory (query t
// at qs4 + t * d4), by one warp, in a fixed order: per lane, FMAs over the
// float4 columns lane, lane + 32, ... in ascending order, then an
// xor-shuffle tree.  The order for a (row, query) pair depends on neither
// NQ nor nq.  All 32 lanes must call it and all end with the scores.
template <int NQ>
__device__ __forceinline__ void warp_row_dots(const float4* __restrict__ row,
                                              const float4* qs4, int d4,
                                              int nq, float (&out)[NQ]) {
  const int lane = threadIdx.x & 31;
  float acc[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) acc[t] = 0.f;
  for (int base = 0; base < d4; base += 32 * UNROLL) {
    float4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + u * 32 + lane;
      x[u] = c < d4 ? __ldg(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      if (t < nq) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = base + u * 32 + lane;
          if (c < d4) {
            const float4 y = qs4[t * d4 + c];
            acc[t] = fmaf(x[u].x, y.x, acc[t]);
            acc[t] = fmaf(x[u].y, y.y, acc[t]);
            acc[t] = fmaf(x[u].z, y.z, acc[t]);
            acc[t] = fmaf(x[u].w, y.w, acc[t]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
    out[t] = acc[t];
  }
}

}  // namespace fused_common

extern "C" {

// Merges each query's n_lists sorted lists of w candidates (cand_*, laid
// out (B, n_lists, w)) into its best w (out_*, (B, w)) under (value desc,
// position asc).  cand_p may alias cand_i; out_p may be null.
int merge_topk_f32(const float* cand_v, const int* cand_i, const int* cand_p,
                   int B, int n_lists, int w, float* out_v, int* out_i,
                   int* out_p, cudaStream_t stream);

// Stage 1: scores the p centroids (p, d) against q (B, d) and writes each
// query's tie-aware top np_pad to sel_v / sel (B, np_pad), through the
// scratch s1_* of B * ceil(p / 128) * np_pad entries.
int select_probes_f32(const float* q, const float* cents, int p, int B,
                      int d, int np_pad, float* s1_v, int* s1_i,
                      float* sel_v, int* sel, cudaStream_t stream);

}  // extern "C"
