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

#include "fused_common.cuh"
#include "topk_tie.cuh"

namespace {

constexpr int SCAN_ROWS = 128;       // rows of a probed list per block
constexpr int CENTROID_CHUNK = 128;  // centroids per stage-1 block
constexpr int ROW_THREADS = 256;     // 8 warps; the scan 2 blocks an SM
constexpr int QTILE_NARROW = 8;      // stage-1 queries a block at B <= 8
constexpr int QTILE_WIDE = 32;       // and above, while 32 queries fit:
constexpr int QTILE_WIDE_MAX_D = 1536;  // 196,608 B staged at d = 1,536
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

// Counts the block's arrival on `counter` once its writes are published;
// true (in every thread) for the last of n blocks to arrive, whose reads
// of the others' writes are then ordered after them.
__device__ __forceinline__ bool arrive_last(int* counter, int n) {
  __syncthreads();  // the block's writes before thread 0's fence
  int last = 0;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == n - 1;
  }
  if (!__syncthreads_or(last)) return false;
  __threadfence();
  return true;
}

// Loads n candidate lists of w entries into shared memory: list l from
// slot first + l * step of cand_* (slots of w entries), its cand_n[slot]
// real entries, pads (-inf, -1, PAD_POS) after them.  Reads through L2
// (other blocks wrote them in this launch).
__device__ __forceinline__ void load_lists(float* fv, int* fi, int* fp,
                                           const float* cand_v,
                                           const int* cand_i,
                                           const int* cand_p,
                                           const int* cand_n, size_t first,
                                           int step, int n, int w) {
  constexpr int LOADS = 4;  // entries a thread in flight
  for (int base = threadIdx.x; base < n * w; base += LOADS * blockDim.x) {
    float v[LOADS];
    int id[LOADS], pos[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = base + u * blockDim.x;
      const size_t slot = first + (size_t)(t / w) * step;
      const int e = t % w;
      // the entry and its slot's count load together (a slot holds w
      // entries, past its count unwritten); the count then picks
      const bool in = t < n * w;
      const int cnt = in ? __ldcg(cand_n + slot) : 0;
      const float ev = in ? __ldcg(cand_v + slot * w + e) : 0.f;
      const int ei = in ? __ldcg(cand_i + slot * w + e) : 0;
      const int ep = in ? __ldcg(cand_p + slot * w + e) : 0;
      const bool real = e < cnt;
      v[u] = real ? ev : -INFINITY;
      id[u] = real ? ei : -1;
      pos[u] = real ? ep : topk_tie::PAD_POS;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = base + u * blockDim.x;
      if (t < n * w) {
        fv[t] = v[u];
        fi[t] = id[u];
        fp[t] = pos[u];
      }
    }
  }
}

// grid (nprobe * nsplit, B).  Block (j, s) of query b scores rows
// [s*SCAN_ROWS, (s+1)*SCAN_ROWS) of list sel[b, j] at precision P and
// writes its best min(w, real rows) to slot (b, j*nsplit + s) of cand_*
// (slots of w entries) and that count to cand_n.  A list id outside
// [0, p), or a list `own` marks as foreign, scans as empty.  The slice's
// 128 ids are read first (a thread each): a slice with no real row stages
// nothing, scores nothing and writes only its count 0; a warp loads
// SCAN_INFLIGHT real rows at once.  One warp selects the best w in
// registers: at w <= 32 four sorted lists of 32 merged pairwise
// (topk_tie::warp_sort, warp_merge), else a sort of all 128.  int8 reads
// row r's group scale from amax[b, j, r / blk_l] (list_amax_kernel).
// With counters (B * nprobe + B zeroed ints; w == r_pad), the last slice
// of list (b, j) to arrive merges that list's nsplit slices over slot
// (b, j*nsplit), and the last list of query b to arrive merges its
// nprobe lists into out_* (B, w) (out_p may be null); each resets its
// counter to 0 for the next call.  Dynamic shared memory: the query, then
// the fold's max(nsplit, nprobe) * w entries.
template <int P, typename T = float>
__global__ void __launch_bounds__(ROW_THREADS, 2)
scan_lists_kernel(const T* __restrict__ q, const T* __restrict__ list_vecs,
                  const int* __restrict__ list_ids, int p,
                  const int* __restrict__ sel, int sel_stride,
                  const int* __restrict__ own, int nprobe, int lmax, int d,
                  int nsplit, int w, int blk_l, int n_groups,
                  const int* __restrict__ amax, float* cand_v, int* cand_i,
                  int* cand_p, int* cand_n, int* counters, float* out_v,
                  int* out_i, int* out_p) {
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
  const int list = sel[(size_t)b * sel_stride + j];
  const bool owned = list >= 0 && list < p &&
                     (own == nullptr || own[(size_t)b * nprobe + j] > 0);
  const int row0 = s * SCAN_ROWS;
  const int nrows = owned ? min(SCAN_ROWS, lmax - row0) : 0;
  const size_t slot = (size_t)b * gridDim.x + blockIdx.x;

  int id = -1;
  if (threadIdx.x < nrows)
    id = list_ids[(size_t)list * lmax + row0 + threadIdx.x];
  // f32 / bf16: the query's loads go out with the ids' (a thread a group
  // of four values while d4 <= ROW_THREADS)
  const bool early = P != P_INT8 && d4 <= ROW_THREADS;
  float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (early && owned && threadIdx.x < d4)
    qv = load4(q + (size_t)b * d, threadIdx.x);
  if (threadIdx.x < SCAN_ROWS) {
    si[threadIdx.x] = id;
    sv[threadIdx.x] = -INFINITY;
    sp[threadIdx.x] = topk_tie::PAD_POS;
  }
  const int n_real = __syncthreads_count(id >= 0);
  if (n_real > 0) {
    float sq = 0.f;
    if (early) {
      if (threadIdx.x < d4) qs4[threadIdx.x] = P == P_BF16 ? bf16_round4(qv)
                                                           : qv;
    } else {
      sq = stage_query<P>(q + (size_t)b * d, d4, qs4, red);
    }
    __syncthreads();
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
                            amax[((size_t)b * nprobe + j) * n_groups +
                                 (row0 + g * R + k) / blk_l]))
                      : 1.f;
        }
        int acc[R][1], sum[1];
        warp_rows_partial_i8<R, 1, ROW_LOADS>(
            r4, st, reinterpret_cast<const int*>(qs4), d4, 1, acc);
        pair_sums<R, 1>(acc, sum);
        sc = r < nrows && si[r] >= 0
                 ? dequant(sum[0], sq,
                           int8_scale(__int_as_float(
                               amax[((size_t)b * nprobe + j) * n_groups +
                                    (row0 + r) / blk_l])))
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
    const int keep = min(w, n_real);
    if (warp == 0 && w <= 32) {
      // the best 32 without sorting all 128: four lists of 32 (entry
      // k * 32 + lane in register k) sorted apart, then merged pairwise
      float v[4][1];
      int ids[4][1], pos[4][1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k][0] = sv[k * 32 + lane];
        ids[k][0] = si[k * 32 + lane];
        pos[k][0] = sp[k * 32 + lane];
        topk_tie::warp_sort<1>(v[k], ids[k], pos[k]);
      }
      topk_tie::warp_merge<1>(v[0], ids[0], pos[0], v[1], ids[1], pos[1]);
      topk_tie::warp_merge<1>(v[2], ids[2], pos[2], v[3], ids[3], pos[3]);
      topk_tie::warp_merge<1>(v[0], ids[0], pos[0], v[2], ids[2], pos[2]);
      if (lane < keep) {
        cand_v[slot * w + lane] = v[0][0];
        cand_i[slot * w + lane] = ids[0][0];
        cand_p[slot * w + lane] = pos[0][0];
      }
    } else if (warp == 0) {  // wider lists: the whole 128, 4 a lane
      float v[4];
      int ids[4], pos[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = sv[lane * 4 + k];
        ids[k] = si[lane * 4 + k];
        pos[k] = sp[lane * 4 + k];
      }
      topk_tie::warp_sort<4>(v, ids, pos);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane * 4 + k;
        if (e < keep) {
          cand_v[slot * w + e] = v[k];
          cand_i[slot * w + e] = ids[k];
          cand_p[slot * w + e] = pos[k];
        }
      }
    }
    if (threadIdx.x == 0) cand_n[slot] = keep;
  } else if (threadIdx.x == 0) {
    cand_n[slot] = 0;
  }
  if (counters == nullptr) return;  // merge_topk_f32 folds the lists

  float* fv = reinterpret_cast<float*>(qs4);
  const size_t first = (size_t)b * gridDim.x + (size_t)j * nsplit;
  if (nsplit > 1) {
    // level 1: the last slice of list (b, j) merges the list's slices
    int* counter = counters + (size_t)b * nprobe + j;
    if (!arrive_last(counter, nsplit)) return;
    int* fi = reinterpret_cast<int*>(fv + nsplit * w);
    int* fp = fi + nsplit * w;
    load_lists(fv, fi, fp, cand_v, cand_i, cand_p, cand_n, first, 1, nsplit,
               w);
    __syncthreads();
    topk_tie::merge_warps(fv, fi, fp, nsplit, w, -1);
    const int keep = __syncthreads_count(threadIdx.x < w &&
                                         fp[threadIdx.x] != topk_tie::PAD_POS);
    for (int t = threadIdx.x; t < keep; t += blockDim.x) {
      cand_v[first * w + t] = fv[t];
      cand_i[first * w + t] = fi[t];
      cand_p[first * w + t] = fp[t];
    }
    if (threadIdx.x == 0) {
      cand_n[first] = keep;
      *counter = 0;  // ready for the next call
    }
  }
  // level 2: the last list of query b merges the query's lists
  int* counter = counters + (size_t)gridDim.y * nprobe + b;
  if (!arrive_last(counter, nprobe)) return;
  int* fi = reinterpret_cast<int*>(fv + nprobe * w);
  int* fp = fi + nprobe * w;
  load_lists(fv, fi, fp, cand_v, cand_i, cand_p, cand_n,
             (size_t)b * gridDim.x, nsplit, nprobe, w);
  __syncthreads();
  topk_tie::merge_warps(fv, fi, fp, nprobe, w, -1);
  for (int t = threadIdx.x; t < w; t += blockDim.x) {
    out_v[(size_t)b * w + t] = fv[t];
    out_i[(size_t)b * w + t] = fi[t];
    if (out_p != nullptr) out_p[(size_t)b * w + t] = fp[t];
  }
  if (threadIdx.x == 0) *counter = 0;
}

// grid (nchunks, ceil(B / NQ)).  Block (c, g) scores centroids
// [c*CENTROID_CHUNK, (c+1)*CENTROID_CHUNK) against queries
// [g*NQ, (g+1)*NQ), staged in dynamic shared memory, at precision P: a
// warp loads R centroid rows at once and scores them against every query
// of the tile, so the table is read once per tile (once per call at
// B <= 32).  Then warp t sorts the 128 scores of queries t, t + 8, ... in
// registers (topk_tie::warp_sort) and writes the best w1 (centroid index
// as id and tie key; pads (-inf, PAD_POS) past p) to cand[b, c, :w1].
// int8 reads centroid r's group scale from c_amax[r / blk_p]; warp t
// quantises queries t, t + 8, ... with their own scales.
template <int P, typename T, int NQ, int R, int U>
__global__ void __launch_bounds__(ROW_THREADS)
centroid_chunk_kernel(const T* __restrict__ q, const T* __restrict__ cents,
                      int B, int p, int d, int w1, int blk_p,
                      const int* __restrict__ c_amax,
                      float* __restrict__ cand_v, int* __restrict__ cand_i) {
  using namespace fused_common;
  static_assert(P == P_F32 || std::is_same<T, float>::value,
                "bf16 storage is scored in float32");
  extern __shared__ float4 qs4[];
  // one row a query, padded to an odd stride: lane t writes query t's
  // score of a row without bank conflicts
  __shared__ float sv[NQ][CENTROID_CHUNK + 1];
  __shared__ float sq[NQ];

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
}

// Stage 1's chunk blocks for B queries: tiles of QTILE_NARROW queries at
// B <= 8 (or d > QTILE_WIDE_MAX_D), else tiles of QTILE_WIDE; a warp loads
// 4 centroid rows at once, 6 (narrow) or 3 (wide: registers for 4 x 32
// sums) 16-byte loads a lane a row at a time, and each query value it
// reads from shared memory serves the 4 rows; each query's best w1 =
// min(np_pad, CENTROID_CHUNK) a chunk (tiling.plan_select).
template <int P, typename T>
cudaError_t launch_chunks(const T* q, const T* cents, int B, int p, int d,
                          int w1, int blk_p, const int* c_amax, float* s1_v,
                          int* s1_i, cudaStream_t st) {
  const int nchunks = (p + CENTROID_CHUNK - 1) / CENTROID_CHUNK;
  const int row = d * (int)sizeof(float);
  if (B <= QTILE_NARROW || d > QTILE_WIDE_MAX_D)
    return fused_common::launch(
        centroid_chunk_kernel<P, T, QTILE_NARROW, 4, 6>,
        dim3(nchunks, (B + QTILE_NARROW - 1) / QTILE_NARROW), ROW_THREADS,
        min(B, QTILE_NARROW) * row, st, q, cents, B, p, d, w1, blk_p, c_amax,
        s1_v, s1_i);
  return fused_common::launch(
      centroid_chunk_kernel<P, T, QTILE_WIDE, 4, 3>,
      dim3(nchunks, (B + QTILE_WIDE - 1) / QTILE_WIDE), ROW_THREADS,
      min(B, QTILE_WIDE) * row, st, q, cents, B, p, d, w1, blk_p, c_amax,
      s1_v, s1_i);
}

// The scan blocks (scan_lists_kernel) with slices of w = min(r_pad,
// SCAN_ROWS) entries; with counters (w == r_pad) the fold into out_* in
// the same launch (tiling.plan_fused_scan_ivf).
template <int P, typename T>
cudaError_t launch_scan(const T* q, const T* list_vecs, const int* list_ids,
                        int p, const int* sel, int sel_stride, const int* own,
                        int B, int nprobe, int lmax, int d, int w, int blk_l,
                        int n_groups, const int* amax, float* cand_v,
                        int* cand_i, int* cand_p, int* cand_n, int* counters,
                        float* out_v, int* out_i, int* out_p,
                        cudaStream_t st) {
  const int nsplit = (lmax + SCAN_ROWS - 1) / SCAN_ROWS;
  int smem = d * (int)sizeof(float);
  if (counters != nullptr)
    smem = max(smem, max(nsplit, nprobe) * w * 12);
  return fused_common::launch(
      scan_lists_kernel<P, T>, dim3(nprobe * nsplit, B), ROW_THREADS, smem,
      st, q, list_vecs, list_ids, p, sel, sel_stride, own, nprobe, lmax, d,
      nsplit, w, blk_l, n_groups, amax, cand_v, cand_i, cand_p, cand_n,
      counters, out_v, out_i, out_p);
}

}  // namespace
