// The two scoring stages of the IVF kernels, shared by fused_turn.cu (the
// fused turn and scan at f32 / bf16 / int8), centroid_topk.cu and
// ivf_scan.cu (the standalone centroid top-k and list scan).
//
// centroid_chunk_kernel: stage 1, one block per (128-centroid chunk, tile
//   of up to 32 queries): each query's sorted top min(np_pad, 128) by
//   (score desc, centroid index asc); centroids past p are never scored.
// scan_lists_kernel: one block per (query, probed list, 128-row slice):
//   the block's sorted top min(r_pad, 128) by (score desc, flat position
//   probe*lmax + offset asc); pad rows (id -1) are never loaded.  With
//   arrival counters it also folds the blocks' lists into the query's top
//   r_pad in the same launch; without, merge_topk_f32 (fused_turn.cu)
//   folds them.
//
// Template arguments: the precision P of the fused turn (fused_common.cuh),
// and the storage type T of the queries and the scored rows, float or
// __nv_bfloat16.  bf16 storage is widened to float32 as it loads (exact)
// and scored in float32 (P == P_F32 only), as the Pallas kernels'
// `.astype(jnp.float32)` does; its rows load 16 bytes (8 values) a lane.
// A row's score is reduced in one fixed order for each T that does not
// depend on the batch, the grid, the rows in flight or the slice a row
// falls in (fused_common warp_rows_dots), so float32 rows score the same
// bits here as in every kernel that shares it.  Selection and merging
// rank by the total order of topk_tie.cuh, so every grouping of them
// keeps the same entries in the same order.
//
// Internal linkage: each source that includes this header gets its own
// instances of these kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

#include "fold.cuh"
#include "fused_common.cuh"
#include "topk_tie.cuh"

namespace {

constexpr int SCAN_ROWS = 128;       // rows of a probed list per block
constexpr int CENTROID_CHUNK = 128;  // centroids per stage-1 block
constexpr int ROW_THREADS = 256;     // 8 warps
// Scan blocks an SM: 3 (the registers for it) holds a B = 1 query's 64 x
// 6 = 384 blocks at once on the 132 SMs, with no second wave; the int8
// scan keeps 2, as its quantisation would spill at 3.
constexpr int SCAN_BLOCKS_SM = 3;
constexpr int QTILE_NARROW = 8;      // stage-1 queries a block at B <= 8
constexpr int QTILE_WIDE = 32;       // and above, while 32 queries fit:
constexpr int QTILE_WIDE_MAX_D = 1536;  // 196,608 B staged at d = 1,536
constexpr int SELECT_GROUP = 16;     // chunks a stage-1 fold merges first
constexpr int SCAN_INFLIGHT = 4;     // rows a scan warp loads at once
constexpr int ROW_LOADS = 3;         // 16-byte loads a lane per row per
                                     // pass: 1.5 KB of a row a warp
static_assert(SCAN_ROWS == 32 * 4 && CENTROID_CHUNK == 32 * 4,
              "the block's list is sorted by one warp, 4 entries a lane");

__host__ __device__ constexpr int log2c(int m) {
  return m <= 1 ? 0 : 1 + log2c(m / 2);
}

// The per-lane partial sums of R rows (null: skipped) of storage type T
// at precision P against nq <= NQ float32 queries staged in shared memory,
// by one warp (fused_common warp_rows_partial); transpose_sums adds them.
template <int P, typename T, int R, int NQ, int U = ROW_LOADS>
__device__ __forceinline__ void row_partial(const T* const* rows,
                                            const float4* qs4, int d4,
                                            int nq, float (&acc)[R][NQ]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4* r4[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      r4[i] = reinterpret_cast<const float4*>(rows[i]);
    fused_common::warp_rows_partial<R, NQ, U, P == fused_common::P_BF16>(
        r4, qs4, d4, nq, acc);
  } else {
    const uint4* r8[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      r8[i] = reinterpret_cast<const uint4*>(rows[i]);
    fused_common::warp_rows_partial_bf16<R, NQ, (U + 1) / 2>(
        r8, qs4, d4 >> 1, nq, acc);
  }
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
// writes its best min(w, real rows) to slot (b, j*nsplit + s) of cand_*
// (slots of w entries) and that count to cand_n (fold::select_slice).  A
// list id outside [0, p), or a list `own` marks as foreign, scans as
// empty.  The query, an input of the call, is loaded before
// fold::wait_primary (a launch chained behind stage 1 overlaps its
// prologue with stage 1's tail); sel, the ids and the rows after it (sel
// and own are not __restrict__: a load the compiler may treat as
// invariant could move above the wait).  The
// slice's 128 ids are read first (a thread each): a slice with no real
// row scores nothing and writes only its count 0; a warp loads
// SCAN_INFLIGHT real rows at once.  int8 reads row r's group scale from
// the index's cached group amax, amax[list, r / blk_l] (group_amax).
// With counters (B * nprobe + B zeroed ints; w == r_pad) the launch folds
// the query's lists (fold::fold_query); the block that folds query b
// writes its top w to out_* (B, w) (out_p may be null) or, with rr > 0,
// re-ranks its first rr candidates in float32 against q and the list rows
// (fold::rerank_fold; T float) and writes the top kp to out_* (B, kp).
// Dynamic shared memory: the query, then the fold's max(nsplit, nprobe) *
// w entries.
template <int P, typename T = float>
__global__ void __launch_bounds__(ROW_THREADS, P == fused_common::P_INT8
                                                   ? 2 : SCAN_BLOCKS_SM)
scan_lists_kernel(const T* __restrict__ q, const T* __restrict__ list_vecs,
                  const int* __restrict__ list_ids, int p, const int* sel,
                  int sel_stride, const int* own, int nprobe, int lmax,
                  int d, int nsplit, int w, int blk_l, int n_groups,
                  const int* __restrict__ amax, float* cand_v, int* cand_i,
                  int* cand_p, int* cand_n, int* counters, int rr, int kp,
                  float* out_v, int* out_i, int* out_p) {
  using namespace fused_common;
  static_assert(P == P_F32 || std::is_same<T, float>::value,
                "bf16 storage is scored in float32");
  constexpr int R = SCAN_INFLIGHT;
  extern __shared__ float4 qs4[];
  __shared__ float sv[SCAN_ROWS];
  __shared__ int si[SCAN_ROWS];
  __shared__ int sp[SCAN_ROWS];
  __shared__ float red[32];

  const int b = blockIdx.y;
  const int j = blockIdx.x / nsplit;
  const int s = blockIdx.x % nsplit;
  const int d4 = d >> 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  // f32 / bf16: the query's loads go out first, a thread a group of four
  // values while d4 <= ROW_THREADS, and land after the ids'; int8 (or a
  // wider query) stages it whole
  const bool early = P != P_INT8 && d4 <= ROW_THREADS;
  float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (early && threadIdx.x < d4) qv = load4(q + (size_t)b * d, threadIdx.x);
  float sq = 0.f;
  if (!early) sq = stage_query<P>(q + (size_t)b * d, d4, qs4, red);
  fold::wait_primary();

  const int list = sel[(size_t)b * sel_stride + j];
  const bool owned = list >= 0 && list < p &&
                     (own == nullptr || own[(size_t)b * nprobe + j] > 0);
  const int row0 = s * SCAN_ROWS;
  const int nrows = owned ? min(SCAN_ROWS, lmax - row0) : 0;
  const size_t slot = (size_t)b * gridDim.x + blockIdx.x;

  int id = -1;
  if (threadIdx.x < nrows)
    id = list_ids[(size_t)list * lmax + row0 + threadIdx.x];
  if (early && threadIdx.x < d4)
    qs4[threadIdx.x] = P == P_BF16 ? bf16_round4(qv) : qv;
  if (threadIdx.x < SCAN_ROWS) {
    si[threadIdx.x] = id;
    sv[threadIdx.x] = -INFINITY;
    sp[threadIdx.x] = topk_tie::PAD_POS;
  }
  const int n_real = __syncthreads_count(id >= 0);
  if (n_real > 0) {
    const int* gmax = P == P_INT8 ? amax + (size_t)list * n_groups : nullptr;
    for (int g = warp; g * R < nrows; g += nwarps) {
      const T* rows[R];
      bool any = false;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = g * R + i;
        const bool live = r < nrows && si[r] >= 0;
        rows[i] = live ? list_vecs + ((size_t)list * lmax + row0 + r) * d
                       : nullptr;
        any |= live;
      }
      if (!any) continue;  // warp-uniform: pad rows are never loaded
      // lane l ends with row l / (32 / R)'s score (transpose_sums)
      const int r = g * R + (lane >> (5 - log2c(R)));
      float sc;
      if constexpr (P == P_INT8) {
        const float4* r4[R];
        float st[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          r4[k] = reinterpret_cast<const float4*>(rows[k]);
          st[k] = rows[k] != nullptr
                      ? int8_scale(__int_as_float(
                            gmax[(row0 + g * R + k) / blk_l]))
                      : 1.f;
        }
        int acc[R][1], sum[1];
        warp_rows_partial_i8<R, 1, ROW_LOADS>(
            r4, st, reinterpret_cast<const int*>(qs4), d4, 1, acc);
        pair_sums<R, 1>(acc, sum);
        sc = r < nrows && si[r] >= 0
                 ? dequant(sum[0], sq,
                           int8_scale(__int_as_float(
                               gmax[(row0 + r) / blk_l])))
                 : 0.f;
      } else {
        float acc[R][1], sum[1];
        row_partial<P, T, R, 1>(rows, qs4, d4, 1, acc);
        pair_sums<R, 1>(acc, sum);
        sc = sum[0];
      }
      if ((lane & (32 / R - 1)) == 0 && r < nrows && si[r] >= 0) {
        sv[r] = sc;
        sp[r] = j * lmax + row0 + r;
      }
    }
    __syncthreads();
  }
  fold::select_slice(sv, si, sp, w, n_real, cand_v, cand_i, cand_p, cand_n,
                     slot);
  if (counters == nullptr) return;  // merge_topk_f32 folds the lists

  int *fi, *fp;
  float* fv = reinterpret_cast<float*>(qs4);
  if (!fold::fold_query(fv, cand_v, cand_i, cand_p, cand_n, counters, b, j,
                        nprobe, nsplit, w, gridDim.y, &fi, &fp))
    return;
  if (rr == 0) {
    fold::write_fold(fv, fi, fp, b, w, out_v, out_i, out_p);
    return;
  }
  if constexpr (std::is_same<T, float>::value)
    fold::rerank_fold(fi, fp, sv, w, rr, kp, q, list_vecs, d, sel,
                      sel_stride, lmax, b, out_v, out_i, out_p);
}

// grid (nchunks, ceil(B / NQ)).  Block (c, g) scores centroids
// [c*CENTROID_CHUNK, (c+1)*CENTROID_CHUNK) against queries
// [g*NQ, (g+1)*NQ), staged in dynamic shared memory, at precision P: a
// warp loads R centroid rows at once and scores them against every query
// of the tile, so the table is read once per tile (once per call at
// B <= 32).  Then warp t sorts the 128 scores of queries t, t + 8, ... in
// registers (topk_tie::warp_sort) and writes the best w1 (centroid index
// as id and tie key; pads (-inf, PAD_POS) past p) to cand[b, c, :w1].
// int8 reads centroid r's group scale from the index's cached group amax
// c_amax[r / blk_p] (group_amax); warp t quantises queries t, t + 8, ...
// with their own scales.  With counters (w1 == np_pad; ceil(B / NQ) *
// (ngroups + 1) zeroed ints, ngroups = ceil(nchunks / SELECT_GROUP)), the
// launch folds its lists into each query's top np_pad, (sel_v, sel) (B,
// np_pad), in two levels of topk_tie::merge_warps (the order and bits of
// merge_topk_f32): a group's SELECT_GROUP chunks, then the tile's groups.
// A scan chained behind it (programmatic dependent launch) may launch as
// soon as every block has started.
template <int P, typename T, int NQ, int R, int U>
__global__ void __launch_bounds__(ROW_THREADS)
centroid_chunk_kernel(const T* __restrict__ q, const T* __restrict__ cents,
                      int B, int p, int d, int w1, int blk_p,
                      const int* __restrict__ c_amax, float* cand_v,
                      int* cand_i, int* counters, int np_pad, float* sel_v,
                      int* sel) {
  using namespace fused_common;
  static_assert(P == P_F32 || std::is_same<T, float>::value,
                "bf16 storage is scored in float32");
  extern __shared__ float4 qs4[];
  // one row a query, padded to an odd stride: lane t writes query t's
  // score of a row without bank conflicts
  __shared__ float sv[NQ][CENTROID_CHUNK + 1];
  __shared__ float sq[NQ];

  // the scan chained behind this launch may start its blocks as soon as
  // every block of this one has: they stage their queries meanwhile
  fold::release_dependents();
  const int b0 = blockIdx.y * NQ;
  const int nq = min(NQ, B - b0);
  const int d4 = d >> 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const T* qb = q + (size_t)b0 * d;
  int* qi = reinterpret_cast<int*>(qs4);
  if constexpr (P == P_INT8) {
    const float4* q4 = reinterpret_cast<const float4*>(qb);
    for (int t = warp; t < nq; t += nwarps) {  // warp-uniform
      const float s = int8_scale(warp_amax(qb + (size_t)t * d, d));
      for (int c = lane; c < d4; c += 32)
        qi[t * d4 + c] = pack4(q4[t * d4 + c], s);
      if (lane == 0) sq[t] = s;
    }
  } else {
    // QLOADS float4s a thread in flight: the loads of a batch issue
    // before its stores
    constexpr int QLOADS = 8;
    for (int base = threadIdx.x; base < nq * d4;
         base += QLOADS * blockDim.x) {
      float4 v[QLOADS];
#pragma unroll
      for (int u = 0; u < QLOADS; ++u) {
        const int c = base + u * blockDim.x;
        if (c < nq * d4) v[u] = load4(qb, c);
      }
#pragma unroll
      for (int u = 0; u < QLOADS; ++u) {
        const int c = base + u * blockDim.x;
        if (c < nq * d4) qs4[c] = P == P_BF16 ? bf16_round4(v[u]) : v[u];
      }
    }
  }
  __syncthreads();

  const int c0 = blockIdx.x * CENTROID_CHUNK;
  const int n = min(CENTROID_CHUNK, p - c0);  // centroids >= p: never scored
  for (int g = warp; g * R < n; g += nwarps) {
    const T* rows[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      rows[i] = g * R + i < n ? cents + (size_t)(c0 + g * R + i) * d
                              : nullptr;
    // pair_sums leaves lane l one (row, query) score a pass
    constexpr int PASSES = R * NQ <= 32 ? 1 : R;
    constexpr int M = R * NQ <= 32 ? R * NQ : 32;
    float sc[PASSES];
    if constexpr (P == P_INT8) {
      const float4* r4[R];
      float st[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        r4[i] = reinterpret_cast<const float4*>(rows[i]);
        st[i] = rows[i] != nullptr
                    ? int8_scale(__int_as_float(c_amax[(c0 + g * R + i) /
                                                       blk_p]))
                    : 1.f;
      }
      int acc[R][NQ], sum[PASSES];
      warp_rows_partial_i8<R, NQ, U>(r4, st, qi, d4, nq, acc);
      pair_sums<R, NQ>(acc, sum);
#pragma unroll
      for (int k = 0; k < PASSES; ++k) {
        const int pair = k * M + (lane >> (5 - log2c(M)));
        const int i = pair / NQ, t = pair % NQ;
        const int r = g * R + i;
        sc[k] = t < nq && r < n
                    ? dequant(sum[k], sq[t],
                              int8_scale(__int_as_float(
                                  c_amax[(c0 + r) / blk_p])))
                    : 0.f;
      }
    } else {
      float acc[R][NQ];
      row_partial<P, T, R, NQ, U>(rows, qs4, d4, nq, acc);
      pair_sums<R, NQ>(acc, sc);
    }
#pragma unroll
    for (int k = 0; k < PASSES; ++k) {
      const int pair = k * M + (lane >> (5 - log2c(M)));
      const int i = pair / NQ, t = pair % NQ;
      const int r = g * R + i;
      if ((M == 32 || (lane & (32 / M - 1)) == 0) && t < nq && r < n)
        sv[t][r] = sc[k];
    }
  }
  __syncthreads();
  for (int t = warp; t < nq; t += nwarps) {
    float v[4];
    int ids[4], pos[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = lane * 4 + k;
      v[k] = e < n ? sv[t][e] : -INFINITY;
      ids[k] = e < n ? c0 + e : topk_tie::PAD_POS;
      pos[k] = ids[k];
    }
    topk_tie::warp_sort<4>(v, ids, pos);
    const size_t out = ((size_t)(b0 + t) * gridDim.x + blockIdx.x) * w1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = lane * 4 + k;
      if (e < w1) {
        cand_v[out + e] = v[k];
        cand_i[out + e] = ids[k];
      }
    }
  }
  if (counters == nullptr) return;  // merge_topk_f32 merges the chunks

  // the fold, in two levels: the last chunk block of each group of
  // SELECT_GROUP chunks merges the group's lists into the group's first
  // slot, then the last group of the tile merges the groups' lists into
  // (sel_v, sel); each level one query of the tile after another
  const int nchunks = gridDim.x;
  const int ngroups = (nchunks + SELECT_GROUP - 1) / SELECT_GROUP;
  const int g0 = blockIdx.x / SELECT_GROUP * SELECT_GROUP;
  const int cap = max(SELECT_GROUP, ngroups) * w1;
  float* fv = reinterpret_cast<float*>(qs4);
  int* fi = reinterpret_cast<int*>(fv + cap);
  int* fp = fi + cap;
  int lists = nchunks, step = 1;  // one group: its chunks at level 2
  if (ngroups > 1) {
    const int gn = min(SELECT_GROUP, nchunks - g0);
    int* counter =
        counters + (size_t)blockIdx.y * ngroups + g0 / SELECT_GROUP;
    if (!fold::arrive_last(counter, gn)) return;
    for (int t = 0; t < nq; ++t) {
      const size_t slot = (size_t)(b0 + t) * nchunks + g0;
      fold::load_lists(fv, fi, fp, cand_v, cand_i, cand_i, nullptr, slot, 1,
                       gn, w1, topk_tie::PAD_POS);
      __syncthreads();
      topk_tie::merge_warps(fv, fi, fp, gn, w1, topk_tie::PAD_POS);
      for (int e = threadIdx.x; e < w1; e += blockDim.x) {
        cand_v[slot * w1 + e] = fv[e];
        cand_i[slot * w1 + e] = fi[e];
      }
      __syncthreads();  // the next query's lists overwrite these
    }
    if (threadIdx.x == 0) *counter = 0;  // ready for the next call
    lists = ngroups;
    step = SELECT_GROUP;
  }
  int* counter = counters + (size_t)gridDim.y * ngroups + blockIdx.y;
  if (!fold::arrive_last(counter, lists)) return;
  for (int t = 0; t < nq; ++t) {
    const int b = b0 + t;
    fold::load_lists(fv, fi, fp, cand_v, cand_i, cand_i, nullptr,
                     (size_t)b * nchunks, step, lists, w1,
                     topk_tie::PAD_POS);
    __syncthreads();
    topk_tie::merge_warps(fv, fi, fp, lists, w1, topk_tie::PAD_POS);
    for (int e = threadIdx.x; e < np_pad; e += blockDim.x) {
      sel_v[(size_t)b * np_pad + e] = fv[e];
      sel[(size_t)b * np_pad + e] = fi[e];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *counter = 0;
}

// Stage 1's chunk blocks for B queries: tiles of QTILE_NARROW queries at
// B <= 8 (or d > QTILE_WIDE_MAX_D), else tiles of QTILE_WIDE; a warp loads
// 4 centroid rows at once, 6 (narrow) or 3 (wide: registers for 4 x 32
// sums) 16-byte loads a lane a row at a time, and each query value it
// reads from shared memory serves the 4 rows; each query's best w1 =
// min(np_pad, CENTROID_CHUNK) a chunk, folded into (sel_v, sel) in the
// same launch with counters (tiling.select_fold; the dynamic shared memory
// then holds the larger of the staged queries and a fold level's lists),
// else merged after it by merge_topk_f32 (tiling.plan_select).
template <int P, typename T>
cudaError_t launch_chunks(const T* q, const T* cents, int B, int p, int d,
                          int np_pad, int blk_p, const int* c_amax,
                          float* s1_v, int* s1_i, int* counters,
                          float* sel_v, int* sel, cudaStream_t st) {
  const int nchunks = (p + CENTROID_CHUNK - 1) / CENTROID_CHUNK;
  const int w1 = min(np_pad, CENTROID_CHUNK);
  const bool narrow = B <= QTILE_NARROW || d > QTILE_WIDE_MAX_D;
  const int qt = narrow ? QTILE_NARROW : QTILE_WIDE;
  if (counters != nullptr && w1 != np_pad) return cudaErrorInvalidValue;
  int smem = min(B, qt) * d * (int)sizeof(float);
  if (counters != nullptr)
    smem = max(smem, max(SELECT_GROUP, (nchunks + SELECT_GROUP - 1) /
                                           SELECT_GROUP) * w1 * 12);
  if (narrow)
    return fused_common::launch(
        centroid_chunk_kernel<P, T, QTILE_NARROW, 4, 6>,
        dim3(nchunks, (B + QTILE_NARROW - 1) / QTILE_NARROW), ROW_THREADS,
        smem, st, q, cents, B, p, d, w1, blk_p, c_amax, s1_v, s1_i,
        counters, np_pad, sel_v, sel);
  return fused_common::launch(
      centroid_chunk_kernel<P, T, QTILE_WIDE, 4, 3>,
      dim3(nchunks, (B + QTILE_WIDE - 1) / QTILE_WIDE), ROW_THREADS, smem,
      st, q, cents, B, p, d, w1, blk_p, c_amax, s1_v, s1_i, counters,
      np_pad, sel_v, sel);
}

// The scan blocks (scan_lists_kernel) with slices of w = min(r_pad,
// SCAN_ROWS) entries; with counters (w == r_pad) the fold into out_* in
// the same launch, re-ranked when rr > 0 (tiling.plan_fused_scan_ivf).
// pdl: launched as a programmatic dependent of the kernel before it on
// the stream (fused_turn: stage 1).
template <int P, typename T>
cudaError_t launch_scan(const T* q, const T* list_vecs, const int* list_ids,
                        int p, const int* sel, int sel_stride, const int* own,
                        int B, int nprobe, int lmax, int d, int w, int blk_l,
                        int n_groups, const int* amax, float* cand_v,
                        int* cand_i, int* cand_p, int* cand_n, int* counters,
                        int rr, int kp, float* out_v, int* out_i, int* out_p,
                        bool pdl, cudaStream_t st) {
  const int nsplit = (lmax + SCAN_ROWS - 1) / SCAN_ROWS;
  int smem = d * (int)sizeof(float);
  if (counters != nullptr)
    smem = max(smem, max(nsplit, nprobe) * w * 12);
  return fused_common::launch_after(
      pdl, scan_lists_kernel<P, T>, dim3(nprobe * nsplit, B), ROW_THREADS,
      smem, st, q, list_vecs, list_ids, p, sel, sel_stride, own, nprobe, lmax,
      d, nsplit, w, blk_l, n_groups, amax, cand_v, cand_i, cand_p, cand_n,
      counters, rr, kp, out_v, out_i, out_p);
}

}  // namespace
