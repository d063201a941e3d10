// The in-launch fold of the scan kernels, shared by the IVF family
// (ivf_stages.cuh: scan_lists_kernel, centroid_chunk_kernel) and the PQ
// family (pq_adc.cu: adc_scan_kernel).
//
// A scan block scores one 128-row slice of a probed list and keeps its
// best w = min(r_pad, 128) rows (select_slice: each entry's rank counted
// by the block, only the real entries written, with their count).  When
// the query's top r_pad is one slice wide and the fold fits
// (tiling.scan_fold), the launch folds its own lists (fold_query): the
// last slice of a probed list to arrive (an arrival counter a list)
// merges the list's slices, and the last list of the query to arrive
// merges the query's lists; each level's lists land in shared memory in
// one round of asynchronous copies (load_lists) and merge by
// topk_tie::merge_warps.  The block that folds query b may then re-rank
// its first r candidates in float32 (rerank_fold), in the order and to
// the bits of fused_turn.cu's rerank_kernel.  The counters are a zeroed
// int32 buffer kept per device and stream (launcher.arrival_counters),
// reset by the block that uses them.
//
// Where the single-block phases' time goes (kernel_timeline.py, PERF.md
// section 6): on the H100 a bitonic step in one warp (shuffles and a
// compare chain) is a dependent link of ~0.1 us, so one warp sorting 128
// entries took ~3 us and merging two lists of 64 ~0.9 us.  So a slice's
// selection and the re-rank's sort count ranks with every thread at once
// (topk_tie::count_before); the merges stay topk_tie::merge_warps: a
// block-wide merge by merge-path ranks, a warp folding a tree of lists
// at once, ranks by binary searches in the other sorted lists and a
// radix select of the query level (8-bit digit passes of a 64-bit key,
// histograms in shared memory, survivors placed by their ranks) all
// measured slower; each level's lists land by one round of copies, not
// four rounds of loads.
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
// them in this launch).  With w a multiple of 4 and the arrays 16-byte
// aligned, every slot is copied whole by cp.async at once while the
// counts load, a list a thread, and the entries past each count are
// overwritten by pads after the copies land: one round trip to L2.
// Otherwise LOADS entries a thread in flight.  The caller synchronises
// before reading the lists.
__device__ __forceinline__ void load_lists(float* fv, int* fi, int* fp,
                                           const float* cand_v,
                                           const int* cand_i,
                                           const int* cand_p,
                                           const int* cand_n, size_t first,
                                           int step, int n, int w,
                                           int pad_id) {
  using namespace fused_common;
  if ((w & 3) == 0 && aligned16(cand_v) && aligned16(cand_i) &&
      aligned16(cand_p)) {
    const int pieces = w >> 2;  // 16-byte copies a slot of each array
    const int lp = __ffs(pieces) - 1;
    for (int x = threadIdx.x; x < (n << lp); x += blockDim.x) {
      const int l = x >> lp;
      const int c = (x & (pieces - 1)) << 2;
      const size_t src = (first + (size_t)l * step) * w + c;
      cp_async16(fv + l * w + c, cand_v + src);
      cp_async16(fi + l * w + c, cand_i + src);
      cp_async16(fp + l * w + c, cand_p + src);
    }
    const int l0 = threadIdx.x;
    const int cnt0 = l0 < n && cand_n != nullptr
                         ? __ldcg(cand_n + first + (size_t)l0 * step)
                         : w;
    cp_async_wait_all();
    __syncthreads();  // every copy landed before any pad overwrites it
    for (int l = l0; l < n; l += blockDim.x) {
      const int cnt = l == l0 || cand_n == nullptr
                          ? cnt0
                          : __ldcg(cand_n + first + (size_t)l * step);
      for (int e = cnt; e < w; ++e) {
        fv[l * w + e] = -INFINITY;
        fi[l * w + e] = pad_id;
        fp[l * w + e] = topk_tie::PAD_POS;
      }
    }
    return;
  }
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

// The block keeps the best keep = min(w, n_real) of its SLICE_ROWS
// entries (sv, si, sp; pads (-inf, -1, PAD_POS)) and writes them sorted
// to slot `slot` of cand_* (slots of w entries), thread 0 the count to
// cand_n[slot].  Each real entry's rank is counted among the 128
// (topk_tie::count_before), two threads an entry (each half the
// entries; the second half's count passes through si), and an entry of
// rank < keep is written at its rank.  Every thread of the block (2 *
// SLICE_ROWS threads: the scan kernels') calls it, after the barrier
// that follows filling the entries; si is overwritten.
__device__ __forceinline__ void select_slice(const float* sv, int* si,
                                             const int* sp, int w, int n_real,
                                             float* cand_v, int* cand_i,
                                             int* cand_p, int* cand_n,
                                             size_t slot) {
  constexpr int HALF = SLICE_ROWS / 2;
  const int keep = min(w, n_real);
  if (threadIdx.x == 0) cand_n[slot] = keep;
  if (keep == 0) return;  // block-uniform
  const int e = threadIdx.x % SLICE_ROWS;
  const int part = threadIdx.x / SLICE_ROWS;  // 0 or 1
  const float ev = sv[e];
  const int ei = si[e], ep = sp[e];
  int c = ei >= 0 ? topk_tie::count_before(sv, sp, part * HALF,
                                           (part + 1) * HALF, ev, ep)
                  : 0;
  __syncthreads();  // every entry read before si takes the counts
  if (part == 1) si[e] = c;
  __syncthreads();
  if (part == 0) c += si[e];
  if (part == 0 && ei >= 0 && c < keep) {
    cand_v[slot * w + c] = ev;
    cand_i[slot * w + c] = ei;
    cand_p[slot * w + c] = ep;
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

// Writes the top kp of the w exact scores es[0, w) by (score desc, rank
// t asc) to out_* + out as (score, fi[t], t): thread t < w counts the
// scores that rank before its own.  Every thread calls it after a
// barrier.
__device__ __forceinline__ void rank_exact(const float* es, const int* fi,
                                           int w, int kp, size_t out,
                                           float* out_v, int* out_i,
                                           int* out_p) {
  for (int t = threadIdx.x; t < w; t += blockDim.x) {
    const float ev = es[t];
    const int c = topk_tie::count_before(es, nullptr, 0, w, ev, t);
    if (c < kp) {
      out_v[out + c] = ev;
      out_i[out + c] = fi[t];
      out_p[out + c] = t;
    }
  }
}

// The float32 re-rank of query b's w <= 128 folded candidates (fi, fp
// [0, w), sorted by the scan's values), in the order of rerank_kernel
// (fused_turn.cu): candidate t < r with an id >= 0 scores the exact dot
// of its row with the float32 query q (B, d); the rest score -inf and
// keep their id; the top kp by (exact score desc, rank t asc) go to
// out_* (B, kp) as (score, id, rank) (rank_exact).  A candidate's row is
// rows[id] (sel null: the PQ corpus) or the list row at its flat
// position probe * lmax + offset of list sel[b * sel_stride + probe].
// Each warp loads RERANK_ROWS rows at once and scores each in
// warp_row_dots' order (fused_common warp_rows_partial, then the xor
// tree by transpose_sums), so the scores are rerank_kernel's bits.  es:
// w floats of shared memory.  Every thread calls it after a barrier.
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
  rank_exact(es, fi, w, kp, (size_t)b * kp, out_v, out_i, out_p);
}

}  // namespace fold
