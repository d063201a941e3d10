// The two scoring stages of the IVF kernels, shared by fused_turn.cu (the
// fused turn and scan at f32 / bf16 / int8), centroid_topk.cu and
// ivf_scan.cu (the standalone centroid top-k and list scan).
//
// centroid_chunk_kernel: stage 1, one block per (128-centroid chunk, 8
//   queries), each block's sorted top min(np_pad, 128) by (score desc,
//   centroid index asc); centroids past p are never scored.
// scan_lists_kernel: one block per (query, probed list, 128-row slice),
//   each block's sorted top min(r_pad, 128) by (score desc, flat position
//   probe*lmax + offset asc); pad rows (id -1) are never loaded.
// merge_topk_f32 (fused_turn.cu) folds the blocks' lists into a query's
// top np_pad / r_pad.
//
// Template arguments: the precision P of the fused turn (fused_common.cuh),
// and the storage type T of the queries and the scored rows, float or
// __nv_bfloat16.  bf16 storage is widened to float32 as it loads (exact)
// and scored in float32 (P == P_F32 only), as the Pallas kernels'
// `.astype(jnp.float32)` does; its rows load 16 bytes (8 values) a lane.
// A row's score is reduced in one fixed order for each T that does not
// depend on the batch, the grid or the slice a row falls in, so float32
// rows score the same bits here as in every kernel that shares
// warp_row_dots.
//
// Internal linkage: each source that includes this header gets its own
// instances of these kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

#include "fused_common.cuh"
#include "topk_tie.cuh"

namespace {

constexpr int SCAN_ROWS = 128;       // rows of a probed list per block
constexpr int CENTROID_CHUNK = 128;  // centroids per stage-1 block
constexpr int QTILE = 8;             // queries per stage-1 block
constexpr int ROW_THREADS = 256;     // 8 warps, one row at a time each
static_assert(ROW_THREADS / 32 == QTILE, "stage 1: one warp per query");

// Scores one row (float32 at precision P, or bfloat16 widened) against
// nq <= NQ float32 queries staged in shared memory, by one warp.
template <int P, typename T, int NQ>
__device__ __forceinline__ void row_dots(const T* __restrict__ row,
                                         const float4* qs4, int d4, int nq,
                                         float (&out)[NQ]) {
  if constexpr (std::is_same<T, float>::value)
    fused_common::warp_row_dots<NQ, P == fused_common::P_BF16>(
        reinterpret_cast<const float4*>(row), qs4, d4, nq, out);
  else
    fused_common::warp_row_dots_bf16<NQ>(reinterpret_cast<const uint4*>(row),
                                         qs4, d4 >> 1, nq, out);
}

// Stages one query row of d4 groups of four values in shared memory for
// precision P: float32 as it is (bf16 storage widened), bf16 rounded, int8
// packed four values an int with its scale (returned; 0 otherwise).  All
// threads of the block call it.
template <int P, typename T>
__device__ __forceinline__ float stage_query(const T* __restrict__ q, int d4,
                                             float4* qs4, float* red) {
  using namespace fused_common;
  if constexpr (P == P_INT8) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float sq = int8_scale(block_amax(q, 4 * d4, red));
    int* qi = reinterpret_cast<int*>(qs4);
    for (int c = threadIdx.x; c < d4; c += blockDim.x) qi[c] = pack4(q4[c], sq);
    return sq;
  } else {
    for (int c = threadIdx.x; c < d4; c += blockDim.x)
      qs4[c] = P == P_BF16 ? bf16_round4(load4(q, c)) : load4(q, c);
    return 0.f;
  }
}

// grid (nprobe * nsplit, B).  Block (j, s) of query b scores rows
// [s*SCAN_ROWS, (s+1)*SCAN_ROWS) of list sel[b, j] at precision P and
// writes its top r_pad to cand[b, j*nsplit + s, :].  A list id outside
// [0, p) scans as an empty list.  int8 reads row r's group scale from
// amax[b, j, r / blk_l] (list_amax_kernel).
template <int P, typename T = float>
__global__ void __launch_bounds__(ROW_THREADS)
scan_lists_kernel(const T* __restrict__ q, const T* __restrict__ list_vecs,
                  const int* __restrict__ list_ids, int p,
                  const int* __restrict__ sel, int sel_stride,
                  const int* __restrict__ own, int nprobe, int lmax, int d,
                  int nsplit, int r_pad, int blk_l, int n_groups,
                  const int* __restrict__ amax, float* __restrict__ cand_v,
                  int* __restrict__ cand_i, int* __restrict__ cand_p) {
  using namespace fused_common;
  static_assert(P == P_F32 || std::is_same<T, float>::value,
                "bf16 storage is scored in float32");
  extern __shared__ float4 qs4[];
  __shared__ float sv[SCAN_ROWS];
  __shared__ int si[SCAN_ROWS];
  __shared__ int sp[SCAN_ROWS];
  __shared__ float red[32];

  const int b = blockIdx.y;
  const int j = blockIdx.x / nsplit;
  const int s = blockIdx.x % nsplit;
  const int d4 = d >> 2;
  const float sq = stage_query<P>(q + (size_t)b * d, d4, qs4, red);
  for (int t = threadIdx.x; t < SCAN_ROWS; t += blockDim.x) {
    sv[t] = -INFINITY;
    si[t] = -1;
    sp[t] = topk_tie::PAD_POS;
  }
  __syncthreads();

  const int list = sel[(size_t)b * sel_stride + j];
  const bool owned = list >= 0 && list < p &&
                     (own == nullptr || own[(size_t)b * nprobe + j] > 0);
  const int row0 = s * SCAN_ROWS;
  const int nrows = min(SCAN_ROWS, lmax - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (owned) {
    for (int r = warp; r < nrows; r += nwarps) {
      const size_t row = (size_t)list * lmax + row0 + r;
      const int id = list_ids[row];
      if (id < 0) continue;  // pad row: warp-uniform, never loaded
      float sc;
      if constexpr (P == P_INT8) {
        const float4* rp =
            reinterpret_cast<const float4*>(list_vecs + row * d);
        const float st = int8_scale(__int_as_float(
            amax[((size_t)b * nprobe + j) * n_groups + (row0 + r) / blk_l]));
        int acc[1];
        warp_row_dots_i8<1>(rp, st, reinterpret_cast<const int*>(qs4), d4, 1,
                            acc);
        sc = dequant(acc[0], sq, st);
      } else {
        float out[1];
        row_dots<P>(list_vecs + row * d, qs4, d4, 1, out);
        sc = out[0];
      }
      if (lane == 0) {
        sv[r] = sc;
        si[r] = id;
        sp[r] = j * lmax + row0 + r;
      }
    }
  }
  topk_tie::block_sort(sv, si, sp, SCAN_ROWS);
  // the block's best min(r_pad, SCAN_ROWS), then pads up to r_pad
  const size_t out = ((size_t)b * gridDim.x + blockIdx.x) * r_pad;
  for (int t = threadIdx.x; t < r_pad; t += blockDim.x) {
    const bool kept = t < SCAN_ROWS;
    cand_v[out + t] = kept ? sv[t] : -INFINITY;
    cand_i[out + t] = kept ? si[t] : -1;
    cand_p[out + t] = kept ? sp[t] : topk_tie::PAD_POS;
  }
}

// grid (nchunks, ceil(B / QTILE)).  Block (c, g) scores centroids
// [c*CENTROID_CHUNK, (c+1)*CENTROID_CHUNK) against queries
// [g*QTILE, (g+1)*QTILE) at precision P and writes each query's top
// np_pad (centroid index as id and tie key) to cand[b, c, :].  int8 reads
// centroid r's group scale from c_amax[r / blk_p]; warp t quantises
// query t with its own scale.
template <int P, typename T = float>
__global__ void __launch_bounds__(ROW_THREADS)
centroid_chunk_kernel(const T* __restrict__ q, const T* __restrict__ cents,
                      int B, int p, int d, int np_pad, int blk_p,
                      const int* __restrict__ c_amax,
                      float* __restrict__ cand_v, int* __restrict__ cand_i) {
  using namespace fused_common;
  static_assert(P == P_F32 || std::is_same<T, float>::value,
                "bf16 storage is scored in float32");
  extern __shared__ float4 qs4[];
  __shared__ float sv[QTILE][CENTROID_CHUNK];
  __shared__ int si[QTILE][CENTROID_CHUNK];
  __shared__ int sp[QTILE][CENTROID_CHUNK];
  __shared__ float sq[QTILE];

  const int b0 = blockIdx.y * QTILE;
  const int nq = min(QTILE, B - b0);
  const int d4 = d >> 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const T* qb = q + (size_t)b0 * d;
  int* qi = reinterpret_cast<int*>(qs4);
  if constexpr (P == P_INT8) {
    const float4* q4 = reinterpret_cast<const float4*>(qb);
    if (warp < nq) {  // warp-uniform
      const float s = int8_scale(warp_amax(qb + (size_t)warp * d, d));
      for (int c = lane; c < d4; c += 32)
        qi[warp * d4 + c] = pack4(q4[warp * d4 + c], s);
      if (lane == 0) sq[warp] = s;
    }
  } else {
    for (int c = threadIdx.x; c < nq * d4; c += blockDim.x)
      qs4[c] = P == P_BF16 ? bf16_round4(load4(qb, c)) : load4(qb, c);
  }
  for (int t = threadIdx.x; t < QTILE * CENTROID_CHUNK; t += blockDim.x) {
    sv[t / CENTROID_CHUNK][t % CENTROID_CHUNK] = -INFINITY;
    si[t / CENTROID_CHUNK][t % CENTROID_CHUNK] = topk_tie::PAD_POS;
    sp[t / CENTROID_CHUNK][t % CENTROID_CHUNK] = topk_tie::PAD_POS;
  }
  __syncthreads();

  const int c0 = blockIdx.x * CENTROID_CHUNK;
  const int n = min(CENTROID_CHUNK, p - c0);  // centroids >= p: never scored
  for (int r = warp; r < n; r += nwarps) {
    const T* row = cents + (size_t)(c0 + r) * d;
    float sc[QTILE];
    if constexpr (P == P_INT8) {
      const float st = int8_scale(__int_as_float(c_amax[(c0 + r) / blk_p]));
      int acc[QTILE];
      warp_row_dots_i8<QTILE>(reinterpret_cast<const float4*>(row), st, qi,
                              d4, nq, acc);
#pragma unroll
      for (int t = 0; t < QTILE; ++t)
        sc[t] = t < nq ? dequant(acc[t], sq[t], st) : 0.f;
    } else {
      row_dots<P>(row, qs4, d4, nq, sc);
    }
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < QTILE; ++t) {
        if (t < nq) {
          sv[t][r] = sc[t];
          si[t][r] = c0 + r;
          sp[t][r] = c0 + r;
        }
      }
    }
  }
  for (int t = 0; t < nq; ++t)
    topk_tie::block_sort(sv[t], si[t], sp[t], CENTROID_CHUNK);
  // each query's best min(np_pad, CENTROID_CHUNK), then pads up to np_pad
  for (int e = threadIdx.x; e < nq * np_pad; e += blockDim.x) {
    const int t = e / np_pad;
    const int i = e % np_pad;
    const size_t out =
        ((size_t)(b0 + t) * gridDim.x + blockIdx.x) * np_pad + i;
    const bool kept = i < CENTROID_CHUNK;
    cand_v[out] = kept ? sv[t][i] : -INFINITY;
    cand_i[out] = kept ? si[t][i] : topk_tie::PAD_POS;
  }
}

}  // namespace
