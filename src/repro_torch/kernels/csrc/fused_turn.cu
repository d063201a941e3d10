// Fused TopLoc_IVF turn kernels for Hopper (sm_90a): float32, bf16 and
// int8 scoring, the quantised turns with an in-kernel float32 re-rank.
//
// fused_scan_ivf replaces the Pallas kernel fused_scan (family ivf) of
//   src/repro/kernels/fused_turn.py:644 (body _scan_kernel :482,
//   pallas_call :618): scan the caller's probed posting lists, mask pads
//   and foreign lists, keep the top r_pad under (value desc, flat position
//   asc) with positions numbered probe*lmax + offset.  bf16 / int8 score
//   the rows quantised (score_tile :89) and then re-rank the top r
//   candidates in float32 from the list rows (_scan_kernel :555-580,
//   rerank_exact :154): top kp by (exact score desc, candidate rank asc),
//   position = candidate rank.
// fused_turn_ivf replaces the Pallas kernel fused_turn (family ivf) of
//   src/repro/kernels/fused_turn.py:406 (body _turn_kernel :169,
//   pallas_call :368): stage 1 scores every centroid (quantised too under
//   bf16 / int8) and keeps the tie-aware top np_pad (the centroid index is
//   id and tie key), stage 2 is the fused_scan body driven by that
//   selection, stage 3 the float32 re-rank (:282-329).
//
// Precision (fused_common.cuh): int8 scales a query per row and the scored
// operand per group of the reference's tiles: blk_p centroids, blk_l rows
// of a list (tiling.centroid_groups / list_groups).  A group spans many
// blocks here (a block scores 128 rows), and its largest |x| depends on
// the index and the group size alone: group_amax reduces every group of
// the lists (or of the centroids) once per index, ops keeps the result
// per tensor (ops.group_scales), and the kernels read it.  bf16 rounds as
// rows load.
//
// Bound on this card: device-memory bytes.  A query reads the real rows of
// its nprobe probed lists once (at most 64 x 702 x 768 x 4 B = 138 MB at
// 8.8M docs / 16,384 lists, 41 us at 3.35 TB/s) and does 2 FLOP per 4 B
// read, far below the f32 ridge of ~20 FLOP/B; fused_turn adds the 50 MB
// centroid table; the quantised re-rank adds r rows.  At B = 1 a call is
// short enough that its latency chain (ids, rows, sort, merges, launches)
// counts beside the bytes: the design keeps rows in flight, the merges off
// one block's serial barriers and the chain in as few launches as it can.
//
// What the design does about it:
//  * scan (ivf_stages.cuh scan_lists_kernel): one 256-thread block per
//    (query, probed list, 128-row slice), so a single query already puts
//    64 x 6 = 384 blocks on the 132 SMs, three an SM, all resident at
//    once (int8 two: a second wave, as its quantisation would spill).  A block reads its slice's 128
//    ids first (the query's loads go out with them); a slice with no real
//    row stages nothing and writes only a count of 0, and pad rows (-1)
//    are never loaded.  A warp loads the rows of 4 real rows at once
//    before the first FMA (int8: __dp4a on the packed quantised bytes),
//    each row scored in the fixed order of warp_rows_dots;
//  * the block counts each of its 128 entries' rank (fold.cuh
//    select_slice) and writes only its real entries, at most min(r_pad,
//    128), in rank order, with their count;
//  * when the query's top r_pad is one slice wide or less and the fold
//    fits (tiling.scan_fold: the served k = 10 and the two-tower k = 100),
//    the scan launch folds the lists itself: the last slice of a probed
//    list to arrive (an arrival counter a list) merges the list's slices,
//    and the last list of the query to arrive merges the query's lists
//    into the output; each level's lists land in shared memory in one
//    round of asynchronous copies and merge by topk_tie::merge_warps
//    (warps fold lists in registers, then pairwise; fold.cuh
//    fold_query).  The
//    counters are a zeroed int32 buffer kept per device and stream
//    (launcher.arrival_counters), reset by the block that uses them, so
//    calls on two streams never share one.
//    Otherwise merge_kernel folds the lists after the scan, in the groups
//    and passes of tiling.merge_plan (growing lists of 128 into r_pad);
//  * where the scan folds, the block that folds query b also re-ranks the
//    quantised paths' first r candidates in float32 (fold.cuh
//    rerank_fold: its warps gather the list rows, 4 in flight, in
//    rerank_kernel's order and bits) and writes the top kp, so bf16 and
//    int8 scan in one launch too;
//  * stage 1 (centroid_chunk_kernel): one block per (128-centroid chunk,
//    up to 32 queries) reads each centroid row once for all the queries
//    of the call at B <= 32, and a warp sorts each query's 128 scores in
//    registers (at one query the block counts their ranks); at np_pad <=
//    128 and a tile of one query (B = 1, tiling.select_fold) the launch
//    folds the chunk lists itself, in two levels of arrival counters (16
//    chunks, then the groups); otherwise merge_kernel folds them
//    (topk_tie merge_warps at np_pad <= 128, merge_grow past it);
//  * fused_turn_ivf launches the scan as a programmatic dependent of the
//    kernel before it (cudaLaunchKernelEx, fold.cuh wait_primary): its
//    blocks load the query while stage 1 drains and read sel after the
//    wait;
//  * re-rank past the fold: one block per query scores its r_pad
//    candidates' float rows, one warp a row, and sorts them in dynamic
//    shared memory;
//  * every kernel's dynamic shared-memory cap is raised once per instance
//    and device (fused_common::opt_in_once), not per launch.
// The scan and stage-1 kernels live in ivf_stages.cuh, shared with the
// standalone centroid_topk.cu and ivf_scan.cu; the fold's pieces in
// fold.cuh, shared with pq_adc.cu.
// Scores are reduced in one fixed order (lane-strided FMAs, then a fixed
// xor-shuffle tree; int8 sums are exact) that does not depend on the
// batch, the grid, the rows in flight or the slice a row falls in, so a
// row scores the same at any B, and candidates rank by the total order
// of topk_tie.cuh, so every selection and merge grouping keeps the same
// entries in the same order.
// Simple first: no TMA, no tensor cores, no persistence.

// Plain C interface (bound with ctypes): every entry returns a cudaError_t
// as int, 0 when every launch was accepted.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "fused_common.cuh"
#include "ivf_stages.cuh"
#include "topk_tie.cuh"

namespace {

constexpr int MERGE_THREADS = 512;
constexpr int LOADS = 8;             // candidates a thread loads at once
constexpr int RERANK_THREADS = 512;  // 16 warps, one candidate row each
constexpr int MAX_R = 2048;          // widest candidate set (r_pad)

using fused_common::P_BF16;
using fused_common::P_F32;
using fused_common::P_INT8;
using fused_common::launch;
using fused_common::warp_row_dots;

constexpr int AMAX_ROWS = 4;         // rows a warp of group_amax loads at once

// grid (n_sets * nsplit).  Block (set, s) reduces rows [s*SCAN_ROWS,
// (s+1)*SCAN_ROWS) of set `set` (set_rows rows of d floats) to their
// largest |x| and folds it into amax[set, row / blk] (zeroed by the
// caller), first in shared memory and then one atomicMax a group the
// slice touches: the bits of non-negative floats order as ints, so
// atomicMax on them is the float max in any order.  A warp loads
// AMAX_ROWS rows at once.
__global__ void __launch_bounds__(ROW_THREADS)
group_amax_kernel(const float* __restrict__ x, int set_rows, int d,
                  int nsplit, int blk, int n_groups, int* __restrict__ amax) {
  __shared__ int gmax[SCAN_ROWS];
  const int set = blockIdx.x / nsplit;
  const int row0 = (blockIdx.x % nsplit) * SCAN_ROWS;
  const int n = min(SCAN_ROWS, set_rows - row0);
  const int g0 = row0 / blk;
  const int ng = (row0 + n - 1) / blk - g0 + 1;
  const int d4 = d >> 2;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < ng) gmax[threadIdx.x] = 0;
  __syncthreads();
  const float4* x4 = reinterpret_cast<const float4*>(
      x + ((size_t)set * set_rows + row0) * d);
  for (int r0 = (threadIdx.x >> 5) * AMAX_ROWS; r0 < n;
       r0 += (blockDim.x >> 5) * AMAX_ROWS) {
    float m[AMAX_ROWS];
#pragma unroll
    for (int i = 0; i < AMAX_ROWS; ++i) m[i] = 0.f;
    for (int c = lane; c < d4; c += 32) {
      float4 v[AMAX_ROWS];
#pragma unroll
      for (int i = 0; i < AMAX_ROWS; ++i)
        v[i] = r0 + i < n ? __ldg(x4 + (size_t)(r0 + i) * d4 + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < AMAX_ROWS; ++i)
        m[i] = fmaxf(m[i], fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                                 fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
    }
#pragma unroll
    for (int i = 0; i < AMAX_ROWS; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
      if (lane == 0 && r0 + i < n)
        atomicMax(gmax + (row0 + r0 + i) / blk - g0, __float_as_int(m[i]));
    }
  }
  __syncthreads();
  if (threadIdx.x < ng)
    atomicMax(amax + (size_t)set * n_groups + g0 + threadIdx.x,
              gmax[threadIdx.x]);
}

// grid (B, groups).  Block (b, g) merges lists [g*group, (g+1)*group) of
// the n lists of w_in entries of query b, list j at list offset j*stride
// of the query's row of `row` entries (src_n (B, n): the real entries of
// each list, the rest read as pads; null: all real), into their best w
// (topk_tie::merge_grow), and writes it to dst at b*dst_row +
// g*dst_group.  A pass with more than one group writes each group's best
// w over the group's first list (w_in == w) or into the next region, and
// the next pass reads those; the last pass has one group and writes the
// output.  src_p may alias src_i (stage 1, where the id is the tie key,
// so both stores write the same value); dst_p may be null.  Dynamic
// shared memory: the group's lists and, when w_in < w, one list of w.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* src_v, const int* src_i, const int* src_p,
             const int* src_n, size_t row, int n, int stride, int group,
             int w_in, int w, int pad_id, float* dst_v, int* dst_i,
             int* dst_p, size_t dst_row, size_t dst_group) {
  extern __shared__ float smem[];
  fold::release_dependents();
  const int first = blockIdx.y * group;
  const int lists = min(group, n - first);
  const int m = lists * w_in;
  const int cap = m + (w_in < w ? w : 0);
  float* sv = smem;
  int* si = reinterpret_cast<int*>(sv + cap);
  int* sp = si + cap;
  const size_t in = (size_t)blockIdx.x * row;
  // LOADS entries a thread in flight: the loads of a batch issue before
  // its stores to shared memory
  for (int base = threadIdx.x; base < m; base += LOADS * blockDim.x) {
    float v[LOADS];
    int id[LOADS], pos[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = base + u * blockDim.x;
      const int list = first + t / w_in;
      const int e = t % w_in;
      const size_t src = in + (size_t)list * stride * w_in + e;
      // the entry and its list's count load together; the count then
      // picks (entries past it are unwritten)
      const bool in = t < m;
      const int cnt = in && src_n != nullptr
                          ? src_n[(size_t)blockIdx.x * n + list]
                          : w_in;
      const float ev = in ? src_v[src] : 0.f;
      const int ei = in ? src_i[src] : 0;
      const int ep = in ? src_p[src] : 0;
      const bool real = in && e < cnt;
      v[u] = real ? ev : -INFINITY;
      id[u] = real ? ei : pad_id;
      pos[u] = real ? ep : topk_tie::PAD_POS;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = base + u * blockDim.x;
      if (t < m) {
        sv[t] = v[u];
        si[t] = id[u];
        sp[t] = pos[u];
      }
    }
  }
  __syncthreads();
  int width = w;
  if (w_in == w && w <= 128)  // lists of a warp or less: warps fold them
    topk_tie::merge_warps(sv, si, sp, lists, w, pad_id);
  else
    width = topk_tie::merge_grow(sv, si, sp, lists, w_in, w, pad_id);
  const size_t out = (size_t)blockIdx.x * dst_row + blockIdx.y * dst_group;
  for (int t = threadIdx.x; t < w; t += blockDim.x) {
    const bool kept = t < width;
    dst_v[out + t] = kept ? sv[t] : -INFINITY;
    dst_i[out + t] = kept ? si[t] : pad_id;
    if (dst_p != nullptr) dst_p[out + t] = kept ? sp[t] : topk_tie::PAD_POS;
  }
}

// grid (B).  Re-ranks query b's r_pad candidates (ids cand_i[b], flat
// positions cand_p[b]) by their exact float32 score, ranks >= r and pad
// ids excluded, and writes the top kp: (exact score, id, rank).  A row is
// rows[id] (sel null: the PQ corpus) or the IVF list row at flat position
// probe * lmax + offset of list sel[b, probe].  Dynamic shared memory: the
// query (d floats), then the r_pad-entry sort arrays.
__global__ void __launch_bounds__(RERANK_THREADS)
rerank_kernel(const float* __restrict__ q, const float* __restrict__ rows,
              int d, const int* __restrict__ sel, int sel_stride, int lmax,
              const int* __restrict__ cand_i, const int* __restrict__ cand_p,
              int r_pad, int r, int kp, float* __restrict__ out_v,
              int* __restrict__ out_i, int* __restrict__ out_p) {
  extern __shared__ float4 qs4[];
  float* sv = reinterpret_cast<float*>(qs4) + d;
  int* si = reinterpret_cast<int*>(sv + r_pad);
  int* sp = si + r_pad;

  const int b = blockIdx.x;
  const int d4 = d >> 2;
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b * d);
  for (int c = threadIdx.x; c < d4; c += blockDim.x) qs4[c] = q4[c];
  for (int t = threadIdx.x; t < r_pad; t += blockDim.x) {
    sv[t] = -INFINITY;
    si[t] = cand_i[(size_t)b * r_pad + t];
    sp[t] = t;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < r_pad; t += nwarps) {
    const int id = si[t];
    if (id < 0 || t >= r) continue;  // warp-uniform, never loaded
    size_t row = (size_t)id;
    if (sel != nullptr) {
      const int pos = cand_p[(size_t)b * r_pad + t];
      row = (size_t)sel[(size_t)b * sel_stride + pos / lmax] * lmax +
            pos % lmax;
    }
    float sc[1];
    warp_row_dots<1>(reinterpret_cast<const float4*>(rows + row * d), qs4, d4,
                     1, sc);
    if (lane == 0) sv[t] = sc[0];
  }
  topk_tie::block_sort(sv, si, sp, r_pad);
  const size_t out = (size_t)b * kp;
  for (int t = threadIdx.x; t < kp; t += blockDim.x) {
    out_v[out + t] = sv[t];
    out_i[out + t] = si[t];
    out_p[out + t] = sp[t];
  }
}

}  // namespace

extern "C" {

int merge_topk_f32(float* cand_v, int* cand_i, int* cand_p,
                   const int* cand_n, int B, int n_lists, int w_in, int w,
                   int pad_id, float* out_v, int* out_i, int* out_p,
                   cudaStream_t stream) {
  int g_first, g_later;
  fused_common::merge_groups(w_in, w, &g_first, &g_later);
  if (w_in < 1 || w < w_in || g_first < 2 || g_later < 2)
    return (int)cudaErrorInvalidValue;
  // one dynamic size for every pass: the largest (tiling.merge_smem)
  const int spare = w_in < w ? w : 0;
  int smem = (min(n_lists, g_first) * w_in + spare) * 12;
  const int groups = (n_lists + g_first - 1) / g_first;
  if (groups > 1) smem = max(smem, min(groups, g_later) * w * 12);
  cudaError_t err = fused_common::opt_in_once(
      reinterpret_cast<const void*>(merge_kernel));
  if (err != cudaSuccess) return (int)err;
  const size_t row = (size_t)n_lists * w_in;
  if (groups == 1) {
    merge_kernel<<<dim3(B, 1), MERGE_THREADS, smem, stream>>>(
        cand_v, cand_i, cand_p, cand_n, row, n_lists, 1, g_first, w_in, w,
        pad_id, out_v, out_i, out_p, (size_t)w, 0);
    return (int)cudaGetLastError();
  }
  // the first pass: in place when the width stays, else into the region
  // past the B query rows
  const bool in_place = w_in == w;
  float* mv = in_place ? cand_v : cand_v + B * row;
  int* mi = in_place ? cand_i : cand_i + B * row;
  int* mp = in_place ? cand_p : cand_p + B * row;
  const size_t mrow = in_place ? row : (size_t)groups * w;
  merge_kernel<<<dim3(B, groups), MERGE_THREADS, smem, stream>>>(
      cand_v, cand_i, cand_p, cand_n, row, n_lists, 1, g_first, w_in, w,
      pad_id, mv, mi, mp, mrow, in_place ? (size_t)g_first * w : (size_t)w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int n = groups;
  int stride = in_place ? g_first : 1;
  while (n > g_later) {  // grouped passes of lists of w, in place
    const int next = (n + g_later - 1) / g_later;
    merge_kernel<<<dim3(B, next), MERGE_THREADS, smem, stream>>>(
        mv, mi, mp, nullptr, mrow, n, stride, g_later, w, w, pad_id, mv, mi,
        mp, mrow, (size_t)g_later * stride * w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    n = next;
    stride *= g_later;
  }
  merge_kernel<<<dim3(B, 1), MERGE_THREADS, smem, stream>>>(
      mv, mi, mp, nullptr, mrow, n, stride, g_later, w, w, pad_id, out_v,
      out_i, out_p, (size_t)w, 0);
  return (int)cudaGetLastError();
}

int select_probes(const float* q, const float* cents, int p, int B, int d,
                  int np_pad, int precision, int blk_p, const int* c_amax,
                  float* s1_v, int* s1_i, int* counters, float* sel_v,
                  int* sel, cudaStream_t stream) {
  const int nchunks = (p + CENTROID_CHUNK - 1) / CENTROID_CHUNK;
  const int w1 = min(np_pad, CENTROID_CHUNK);
  cudaError_t err;
  if (precision == P_INT8)
    err = launch_chunks<P_INT8>(q, cents, B, p, d, np_pad, blk_p, c_amax,
                                s1_v, s1_i, counters, sel_v, sel, stream);
  else if (precision == P_BF16)
    err = launch_chunks<P_BF16>(q, cents, B, p, d, np_pad, blk_p, c_amax,
                                s1_v, s1_i, counters, sel_v, sel, stream);
  else
    err = launch_chunks<P_F32>(q, cents, B, p, d, np_pad, blk_p, c_amax,
                               s1_v, s1_i, counters, sel_v, sel, stream);
  if (err != cudaSuccess || counters != nullptr) return (int)err;
  return merge_topk_f32(s1_v, s1_i, s1_i, nullptr, B, nchunks, w1, np_pad,
                        topk_tie::PAD_POS, sel_v, sel, nullptr, stream);
}

int rerank_rows(const float* q, const float* rows, int d, const int* sel,
                int sel_stride, int lmax, const int* cand_i,
                const int* cand_p, int B, int r_pad, int r, int kp,
                float* out_v, int* out_i, int* out_p, cudaStream_t stream) {
  if (r_pad > MAX_R || kp > r_pad || r > r_pad)
    return (int)cudaErrorInvalidValue;
  const int smem = d * (int)sizeof(float) +
                   r_pad * (int)(sizeof(float) + 2 * sizeof(int));
  return (int)launch(rerank_kernel, dim3(B), RERANK_THREADS, smem, stream, q,
                     rows, d, sel, sel_stride, lmax, cand_i, cand_p, r_pad, r,
                     kp, out_v, out_i, out_p);
}

// The one-time int8 scale pass of an index: the largest |x| of every
// group of blk rows of each of the n_sets sets of set_rows rows of x
// (n_sets, set_rows, d) into amax (n_sets, n_groups), zeroed here first:
// the lists' groups (tiling.list_groups) or the centroids' (one set of p
// rows, tiling.centroid_groups).  ops keeps the result per index tensor.
int group_amax(const float* x, int n_sets, int set_rows, int d, int blk,
               int n_groups, int* amax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      amax, 0, (size_t)n_sets * n_groups * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int nsplit = (set_rows + SCAN_ROWS - 1) / SCAN_ROWS;
  group_amax_kernel<<<(unsigned)(n_sets * nsplit), ROW_THREADS, 0, st>>>(
      x, set_rows, d, nsplit, blk, n_groups, amax);
  return (int)cudaGetLastError();
}

}  // extern "C"

namespace {

// Stage 2 (+ 3); pdl: the scan chained behind stage 1 (fused_turn_ivf).
int scan_ivf(const float* q, const float* list_vecs, const int* list_ids,
             int p, const int* sel, int sel_stride, const int* own, int B,
             int nprobe, int lmax, int d, int precision, int blk_l,
             int n_groups, const int* amax, int r, int r_pad, int kp,
             float* cand_v, int* cand_i, int* cand_p, int* cand_n,
             int* counters, float* mid_v, int* mid_i, int* mid_p,
             float* out_v, int* out_i, int* out_p, bool pdl,
             cudaStream_t st) {
  const int nsplit = (lmax + SCAN_ROWS - 1) / SCAN_ROWS;
  const int w = min(r_pad, SCAN_ROWS);
  if (counters != nullptr && w != r_pad) return (int)cudaErrorInvalidValue;
  const bool f32 = precision == P_F32;
  // folded, the quantised paths re-rank in the scan launch into out_*
  const int rr = f32 || counters == nullptr ? 0 : r;
  float* top_v = f32 || counters != nullptr ? out_v : mid_v;
  int* top_i = f32 || counters != nullptr ? out_i : mid_i;
  int* top_p = f32 || counters != nullptr ? out_p : mid_p;
  cudaError_t err;
  if (precision == P_INT8)
    err = launch_scan<P_INT8>(q, list_vecs, list_ids, p, sel, sel_stride, own,
                              B, nprobe, lmax, d, w, blk_l, n_groups, amax,
                              cand_v, cand_i, cand_p, cand_n, counters, rr,
                              kp, top_v, top_i, top_p, pdl, st);
  else if (precision == P_BF16)
    err = launch_scan<P_BF16>(q, list_vecs, list_ids, p, sel, sel_stride, own,
                              B, nprobe, lmax, d, w, blk_l, n_groups, amax,
                              cand_v, cand_i, cand_p, cand_n, counters, rr,
                              kp, top_v, top_i, top_p, pdl, st);
  else
    err = launch_scan<P_F32>(q, list_vecs, list_ids, p, sel, sel_stride, own,
                             B, nprobe, lmax, d, w, blk_l, n_groups, amax,
                             cand_v, cand_i, cand_p, cand_n, counters, 0, kp,
                             top_v, top_i, top_p, pdl, st);
  if (err != cudaSuccess || counters != nullptr) return (int)err;
  const int e = merge_topk_f32(cand_v, cand_i, cand_p, cand_n, B,
                               nprobe * nsplit, w, r_pad, -1, top_v, top_i,
                               top_p, st);
  if (e != 0 || f32) return e;
  return rerank_rows(q, list_vecs, d, sel, sel_stride, lmax, mid_i, mid_p, B,
                     r_pad, r, kp, out_v, out_i, out_p, st);
}

}  // namespace

extern "C" {

// Stage 2 (+ 3) alone.  q (B, d); list_vecs (p, lmax, d); list_ids (p,
// lmax); sel (B, sel_stride) of which the first nprobe columns are probed;
// own (B, nprobe) or null.  Scratch cand_* holds B * nprobe * nsplit * w
// entries (nsplit = ceil(lmax / 128), w = min(r_pad, 128)) and what
// merge_topk_f32 adds past them, cand_n B * nprobe * nsplit counts.  With
// counters (B * nprobe + B zeroed ints, r_pad <= 128) the scan launch
// folds the lists itself, and re-ranks the quantised paths' candidates
// too (ivf_stages.cuh); without, merge_topk_f32 and rerank_rows follow it.
// f32: out_* (B, r_pad) is the top r_pad.  bf16 / int8: out_* (B, kp) is
// the float32 top kp of the quantised top r_pad's first r (mid_* (B,
// r_pad) receives that top r_pad when the launch does not fold); int8
// reads each list row's group amax from amax (p, n_groups), the index's
// cached scales (group_amax, groups of blk_l rows).
int fused_scan_ivf(const float* q, const float* list_vecs,
                   const int* list_ids, int p, const int* sel,
                   int sel_stride, const int* own, int B, int nprobe,
                   int lmax, int d, int precision, int blk_l, int n_groups,
                   const int* amax, int r, int r_pad, int kp, float* cand_v,
                   int* cand_i, int* cand_p, int* cand_n, int* counters,
                   float* mid_v, int* mid_i, int* mid_p, float* out_v,
                   int* out_i, int* out_p, void* stream) {
  return scan_ivf(q, list_vecs, list_ids, p, sel, sel_stride, own, B, nprobe,
                  lmax, d, precision, blk_l, n_groups, amax, r, r_pad, kp,
                  cand_v, cand_i, cand_p, cand_n, counters, mid_v, mid_i,
                  mid_p, out_v, out_i, out_p, false,
                  static_cast<cudaStream_t>(stream));
}

// Stages 1 + 2 (+ 3).  cents (p, d).  Scratch s1_* holds B * nchunks *
// min(np_pad, 128) entries (nchunks = ceil(p / 128)) and what
// merge_topk_f32 adds past them; with s1_counters (a zeroed int a query
// tile) stage 1 folds its chunks into sel_v / sel (B, np_pad) in its own
// launch (tiling.select_fold), else merge_topk_f32 does; int8 reads the
// centroid groups' amax (blk_p rows) from c_amax, the index's cached
// scales.  The scan is launched as a programmatic dependent of the kernel
// before it (stage 1, or its merge): its prologue overlaps that kernel's
// tail.  The rest as fused_scan_ivf.
int fused_turn_ivf(const float* q, const float* cents, const float* list_vecs,
                   const int* list_ids, int p, int B, int nprobe, int np_pad,
                   int lmax, int d, int precision, int blk_p,
                   const int* c_amax, int blk_l, int n_groups,
                   const int* amax, int r, int r_pad, int kp, float* s1_v,
                   int* s1_i, int* s1_counters, float* sel_v, int* sel,
                   float* cand_v, int* cand_i, int* cand_p, int* cand_n,
                   int* counters, float* mid_v, int* mid_i, int* mid_p,
                   float* out_v, int* out_i, int* out_p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = select_probes(q, cents, p, B, d, np_pad, precision, blk_p,
                              c_amax, s1_v, s1_i, s1_counters, sel_v, sel,
                              st);
  if (e != 0) return e;
  return scan_ivf(q, list_vecs, list_ids, p, sel, np_pad, nullptr, B, nprobe,
                  lmax, d, precision, blk_l, n_groups, amax, r, r_pad, kp,
                  cand_v, cand_i, cand_p, cand_n, counters, mid_v, mid_i,
                  mid_p, out_v, out_i, out_p, true, st);
}

}  // extern "C"
