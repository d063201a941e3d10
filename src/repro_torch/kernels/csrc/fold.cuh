// The in-launch fold of the scan kernels, shared by the IVF family
// (ivf_stages.cuh: scan_lists_kernel, centroid_chunk_kernel) and the PQ
// family (pq_adc.cu: adc_scan_kernel).
//
// A scan block scores one 128-row slice of a probed list and keeps its
// best w = min(r_pad, 128) rows (select_slice: one warp in registers,
// only the real entries written, with their count).  When the query's
// top r_pad is one slice wide and the fold fits (tiling.scan_fold), the
// launch folds its own lists (fold_query): the last slice of a probed
// list to arrive (an arrival counter a list) merges the list's slices,
// and the last list of the query to arrive merges the query's lists;
// each merge is topk_tie::merge_warps.  The block that folds query b may
// then re-rank its first r candidates in float32 (rerank_fold), in the
// order and to the bits of fused_turn.cu's rerank_kernel.  The counters
// are a zeroed int32 buffer kept per device and stream
// (launcher.arrival_counters), reset by the block that uses them.
//
// Programmatic dependent launch (wait_primary / release_dependents): a
// kernel launched with cudaLaunchAttributeProgrammaticStreamSerialization
// (fused_common::launch_after with pdl) may start while the kernel before
// it on the stream drains; it reads only the call's inputs before
// wait_primary, which returns once that kernel has finished and its writes
// are visible.  Launched without the attribute, wait_primary returns at
// once.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "fused_common.cuh"
#include "topk_tie.cuh"

namespace fold {

constexpr int SLICE_ROWS = 128;  // rows of a probed list a scan block takes
constexpr int RERANK_ROWS = 4;   // candidate rows a re-rank warp loads at once
constexpr int RERANK_LOADS = 3;  // 16-byte loads a lane per row per pass

// Waits for the kernel this one depends on (griddepcontrol.wait).
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Lets the kernel that depends on this one launch now
// (griddepcontrol.launch_dependents): its wait_primary still waits for
// this whole grid.
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
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
// real entries (cand_n null: all w), pads (-inf, pad_id, PAD_POS) after
// them.  cand_p may alias cand_i.  Reads through L2 (other blocks wrote
// them in this launch).
__device__ __forceinline__ void load_lists(float* fv, int* fi, int* fp,
                                           const float* cand_v,
                                           const int* cand_i,
                                           const int* cand_p,
                                           const int* cand_n, size_t first,
                                           int step, int n, int w,
                                           int pad_id) {
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
      const int cnt = !in ? 0 : cand_n != nullptr ? __ldcg(cand_n + slot) : w;
      const float ev = in ? __ldcg(cand_v + slot * w + e) : 0.f;
      const int ei = in ? __ldcg(cand_i + slot * w + e) : 0;
      const int ep = in ? __ldcg(cand_p + slot * w + e) : 0;
      const bool real = e < cnt;
      v[u] = real ? ev : -INFINITY;
      id[u] = real ? ei : pad_id;
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

// Warp 0 keeps the best min(w, n_real) of the block's SLICE_ROWS entries
// (sv, si, sp; pads (-inf, -1, PAD_POS)) and writes them to slot `slot` of
// cand_* (slots of w entries), thread 0 the count to cand_n[slot].  At
// w <= 32 four sorted lists of 32 (entry k * 32 + lane in register k)
// are merged pairwise (topk_tie::warp_sort, warp_merge), else all 128 are
// sorted, 4 a lane.  No barrier; the caller synchronised after filling
// the entries.
__device__ __forceinline__ void select_slice(const float* sv, const int* si,
                                             const int* sp, int w, int n_real,
                                             float* cand_v, int* cand_i,
                                             int* cand_p, int* cand_n,
                                             size_t slot) {
  static_assert(SLICE_ROWS == 32 * 4, "a slice is 4 entries a lane");
  const int lane = threadIdx.x & 31;
  const int keep = min(w, n_real);
  if (threadIdx.x == 0) cand_n[slot] = keep;
  if ((threadIdx.x >> 5) != 0 || keep == 0) return;
  if (w <= 32) {
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
    return;
  }
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

// The two-level fold of query b's lists, called by every block of a scan
// launch of grid (nprobe * nsplit, nq) after select_slice (block (j, s)
// of query b wrote slot b * nprobe * nsplit + j * nsplit + s).  Counters:
// nq * nprobe per list, then nq per query.  Returns true, in every thread,
// in the one block that merged the query's lists: their best w then lie
// sorted in fv / fi / fp [0, w), arrays of max(nsplit, nprobe) * w entries
// each at `smem` (dynamic shared memory the block no longer needs).
__device__ __forceinline__ bool fold_query(float* smem, float* cand_v,
                                           int* cand_i, int* cand_p,
                                           int* cand_n, int* counters, int b,
                                           int j, int nprobe, int nsplit,
                                           int w, int nq, int** fi_out,
                                           int** fp_out) {
  float* fv = smem;
  const size_t row = (size_t)b * nprobe * nsplit;
  const size_t first = row + (size_t)j * nsplit;
  if (nsplit > 1) {
    // level 1: the last slice of list (b, j) merges the list's slices
    int* counter = counters + (size_t)b * nprobe + j;
    if (!arrive_last(counter, nsplit)) return false;
    int* fi = reinterpret_cast<int*>(fv + nsplit * w);
    int* fp = fi + nsplit * w;
    load_lists(fv, fi, fp, cand_v, cand_i, cand_p, cand_n, first, 1, nsplit,
               w, -1);
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
  int* counter = counters + (size_t)nq * nprobe + b;
  if (!arrive_last(counter, nprobe)) return false;
  int* fi = reinterpret_cast<int*>(fv + nprobe * w);
  int* fp = fi + nprobe * w;
  load_lists(fv, fi, fp, cand_v, cand_i, cand_p, cand_n, row, nsplit, nprobe,
             w, -1);
  __syncthreads();
  topk_tie::merge_warps(fv, fi, fp, nprobe, w, -1);
  if (threadIdx.x == 0) *counter = 0;
  *fi_out = fi;
  *fp_out = fp;
  return true;
}

// Writes the folded list (fv, fi, fp)[0, w) of query b to out_* (B, w);
// out_p may be null.
__device__ __forceinline__ void write_fold(const float* fv, const int* fi,
                                           const int* fp, int b, int w,
                                           float* out_v, int* out_i,
                                           int* out_p) {
  for (int t = threadIdx.x; t < w; t += blockDim.x) {
    out_v[(size_t)b * w + t] = fv[t];
    out_i[(size_t)b * w + t] = fi[t];
    if (out_p != nullptr) out_p[(size_t)b * w + t] = fp[t];
  }
}

// Candidate t's float row: rows[id] (sel null), or the list row at its
// flat position probe * lmax + offset of list sel[b * sel_stride + probe].
__device__ __forceinline__ const float* row_of(const int* fi, const int* fp,
                                               int t, const float* rows,
                                               int d, const int* sel,
                                               int sel_stride, int lmax,
                                               int b) {
  size_t row = (size_t)fi[t];
  if (sel != nullptr) {
    const int pos = fp[t];
    row = (size_t)sel[(size_t)b * sel_stride + pos / lmax] * lmax +
          pos % lmax;
  }
  return rows + row * d;
}

template <int N>
__device__ __forceinline__ void sort_exact(const float* es, const int* fi,
                                           int w, int kp, size_t out,
                                           float* out_v, int* out_i,
                                           int* out_p) {
  const int lane = threadIdx.x & 31;
  float v[N];
  int ids[N], pos[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int e = lane * N + k;
    v[k] = e < w ? es[e] : -INFINITY;
    ids[k] = e < w ? fi[e] : -1;
    pos[k] = e < w ? e : topk_tie::PAD_POS;
  }
  topk_tie::warp_sort<N>(v, ids, pos);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int e = lane * N + k;
    if (e < kp) {
      out_v[out + e] = v[k];
      out_i[out + e] = ids[k];
      out_p[out + e] = pos[k];
    }
  }
}

// The float32 re-rank of query b's w <= 128 folded candidates (fi, fp
// [0, w), sorted by the scan's values), in the order of rerank_kernel
// (fused_turn.cu): candidate t < r with an id >= 0 scores the exact dot
// of its row with the float32 query q (B, d); the rest score -inf and
// keep their id; the top kp by (exact score desc, rank t asc) go to
// out_* (B, kp) as (score, id, rank).  A candidate's row is rows[id]
// (sel null: the PQ corpus) or the list row at its flat position
// probe * lmax + offset of list sel[b * sel_stride + probe].  Each warp
// loads RERANK_ROWS rows at once and scores each in warp_row_dots' order
// (fused_common warp_rows_partial, then the xor tree by transpose_sums),
// so the scores are rerank_kernel's bits.  es: w floats of shared memory.
// Every thread calls it after a barrier.
__device__ __forceinline__ void rerank_fold(const int* fi, const int* fp,
                                            float* es, int w, int r, int kp,
                                            const float* __restrict__ q,
                                            const float* __restrict__ rows,
                                            int d, const int* sel,
                                            int sel_stride, int lmax, int b,
                                            float* out_v, int* out_i,
                                            int* out_p) {
  constexpr int R = RERANK_ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int d4 = d >> 2;
  const int n = min(r, w);
  // every candidate row's 128-byte lines asked of L2 at once: the warps'
  // gathers below then wait on one trip to device memory, not one a row
  const int lines = (d * 4 + 127) / 128;
  for (int x = threadIdx.x; x < n * lines; x += blockDim.x) {
    const int t = x / lines;
    if (fi[t] >= 0)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          row_of(fi, fp, t, rows, d, sel, sel_stride, lmax, b) +
          (x % lines) * 32));
  }
  for (int t = threadIdx.x; t < w; t += blockDim.x) es[t] = -INFINITY;
  __syncthreads();
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b * d);
  for (int g = warp; g * R < n; g += nwarps) {
    const float4* r4[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = g * R + i;
      r4[i] = t < n && fi[t] >= 0
                  ? reinterpret_cast<const float4*>(row_of(
                        fi, fp, t, rows, d, sel, sel_stride, lmax, b))
                  : nullptr;
    }
    float acc[R][1], sum[1];
    fused_common::warp_rows_partial<R, 1, RERANK_LOADS>(r4, q4, d4, 1, acc);
    fused_common::pair_sums<R, 1>(acc, sum);
    // lane l holds row l / (32 / R)'s score
    const int t = g * R + lane / (32 / R);
    if ((lane & (32 / R - 1)) == 0 && t < n && fi[t] >= 0) es[t] = sum[0];
  }
  __syncthreads();
  if (warp != 0) return;
  const size_t out = (size_t)b * kp;
  if (w <= 32)
    sort_exact<1>(es, fi, w, kp, out, out_v, out_i, out_p);
  else if (w <= 64)
    sort_exact<2>(es, fi, w, kp, out, out_v, out_i, out_p);
  else
    sort_exact<4>(es, fi, w, kp, out, out_v, out_i, out_p);
}

}  // namespace fold
