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
// blocks here (a block scores 128 rows), so a reduction kernel first
// writes each group's largest |x| (list_amax_kernel for the probed lists
// of each query, centroid_amax_kernel for all centroids): one more read of
// those bytes.  bf16 rounds as rows load.
//
// Bound on this card: device-memory bytes.  A query reads the real rows of
// its nprobe probed lists once (at most 64 x 702 x 768 x 4 B = 138 MB at
// 8.8M docs / 16,384 lists, 41 us at 3.35 TB/s) and does 2 FLOP per 4 B
// read, far below the f32 ridge of ~20 FLOP/B; fused_turn adds the 50 MB
// centroid table; int8 reads the probed rows (and the centroids) twice
// and the re-rank adds r rows.
//
// What the design does about it:
//  * scan: one 256-thread block per (query, probed list, 128-row slice), so
//    a single query already puts 64 x 6 = 384 blocks on the 132 SMs; a
//    row's id is read first and pad rows (-1) are never loaded;
//  * a warp scores one row: float4 loads, up to 8 per lane issued before
//    the first FMA (int8: __dp4a on the packed quantised bytes), so a warp
//    keeps a 4 KB row in flight;
//  * stage 1: one block per (128-centroid chunk, 8 queries) reads each
//    centroid row once for all 8 queries;
//  * only each block's top r_pad / np_pad candidates leave the SM (a block
//    holds 128 rows or centroids, so past 128 the rest of its list is
//    pads); a small second kernel merges a query's sorted lists pairwise
//    in shared memory, in groups that fit one block and in as many passes
//    as needed (tiling.merge_plan): at the two-tower shape, 32 probes x
//    10 slices of top-128 lists are 491,520 B, two groups' worth; lists
//    of 2,048 (r = 2,000) go 9 a block;
//  * re-rank: one block per query scores its r_pad candidates' float rows,
//    one warp a row, and sorts them in dynamic shared memory.
// Scores are reduced in one fixed order (lane-strided FMAs, then a fixed
// xor-shuffle tree; int8 sums are exact) that does not depend on the
// batch, the grid or the slice a row falls in, so a row scores the same
// at any B.
// Simple first: no TMA, no tensor cores, no persistence, the group scales
// are recomputed per call.
//
// Plain C interface (bound with ctypes): every entry returns a cudaError_t
// as int, 0 when every launch was accepted.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "fused_common.cuh"
#include "topk_tie.cuh"

namespace {

constexpr int SCAN_ROWS = 128;       // rows of a probed list per block
constexpr int CENTROID_CHUNK = 128;  // centroids per stage-1 block
constexpr int QTILE = 8;             // queries per stage-1 block
constexpr int ROW_THREADS = 256;     // 8 warps, one row at a time each
constexpr int MERGE_THREADS = 512;
constexpr int RERANK_THREADS = 512;  // 16 warps, one candidate row each
constexpr int MAX_R = 2048;          // widest candidate set (r_pad)
static_assert(ROW_THREADS / 32 == QTILE, "stage 1: one warp per query");

using fused_common::P_BF16;
using fused_common::P_F32;
using fused_common::P_INT8;
using fused_common::bf16_round4;
using fused_common::block_amax;
using fused_common::by_precision;
using fused_common::dequant;
using fused_common::int8_scale;
using fused_common::launch;
using fused_common::pack4;
using fused_common::warp_amax;
using fused_common::warp_row_dots;
using fused_common::warp_row_dots_i8;

// Largest |x| of a row of d4 float4s, by one warp (all lanes get it).
__device__ __forceinline__ float warp_row_amax(const float4* __restrict__ row,
                                               int d4) {
  float m = 0.f;
  for (int c = threadIdx.x & 31; c < d4; c += 32) {
    const float4 v = __ldg(row + c);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                       fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Stages one query row of d4 float4s in shared memory for precision P:
// float32 as it is, bf16 rounded, int8 packed four values an int with its
// scale (returned; 0 otherwise).  All threads of the block call it.
template <int P>
__device__ __forceinline__ float stage_query(const float* __restrict__ q,
                                             int d4, float4* qs4,
                                             float* red) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  if constexpr (P == P_INT8) {
    const float sq = int8_scale(block_amax(q, 4 * d4, red));
    int* qi = reinterpret_cast<int*>(qs4);
    for (int c = threadIdx.x; c < d4; c += blockDim.x) qi[c] = pack4(q4[c], sq);
    return sq;
  } else {
    for (int c = threadIdx.x; c < d4; c += blockDim.x)
      qs4[c] = P == P_BF16 ? bf16_round4(q4[c]) : q4[c];
    return 0.f;
  }
}

// grid (nprobe * nsplit, B).  Block (j, s) of query b reduces each row of
// rows [s*SCAN_ROWS, (s+1)*SCAN_ROWS) of list sel[b, j] to its largest |x|
// and folds it into amax[b, j, row / blk_l] (zeroed by the caller): the
// bits of non-negative floats order as ints, so atomicMax on them is the
// float max in any order.  Lists the scan skips are skipped.
__global__ void __launch_bounds__(ROW_THREADS)
list_amax_kernel(const float* __restrict__ list_vecs, int p,
                 const int* __restrict__ sel, int sel_stride,
                 const int* __restrict__ own, int nprobe, int lmax, int d,
                 int nsplit, int blk_l, int n_groups, int* __restrict__ amax) {
  const int b = blockIdx.y;
  const int j = blockIdx.x / nsplit;
  const int s = blockIdx.x % nsplit;
  const int list = sel[(size_t)b * sel_stride + j];
  if (list < 0 || list >= p ||
      (own != nullptr && own[(size_t)b * nprobe + j] <= 0))
    return;
  const int row0 = s * SCAN_ROWS;
  const int nrows = min(SCAN_ROWS, lmax - row0);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nrows; r += blockDim.x >> 5) {
    const size_t row = (size_t)list * lmax + row0 + r;
    const float m = warp_row_amax(
        reinterpret_cast<const float4*>(list_vecs + row * d), d >> 2);
    if (lane == 0)
      atomicMax(amax + ((size_t)b * nprobe + j) * n_groups +
                    (row0 + r) / blk_l,
                __float_as_int(m));
  }
}

// grid (nchunks).  Folds each centroid row's largest |x| into
// c_amax[row / blk_p] (zeroed by the caller).
__global__ void __launch_bounds__(ROW_THREADS)
centroid_amax_kernel(const float* __restrict__ cents, int p, int d,
                     int blk_p, int* __restrict__ c_amax) {
  const int c0 = blockIdx.x * CENTROID_CHUNK;
  const int n = min(CENTROID_CHUNK, p - c0);
  for (int r = threadIdx.x >> 5; r < n; r += blockDim.x >> 5) {
    const float m = warp_row_amax(
        reinterpret_cast<const float4*>(cents + (size_t)(c0 + r) * d),
        d >> 2);
    if ((threadIdx.x & 31) == 0)
      atomicMax(c_amax + (c0 + r) / blk_p, __float_as_int(m));
  }
}

// grid (nprobe * nsplit, B).  Block (j, s) of query b scores rows
// [s*SCAN_ROWS, (s+1)*SCAN_ROWS) of list sel[b, j] at precision P and
// writes its top r_pad to cand[b, j*nsplit + s, :].  A list id outside
// [0, p) scans as an empty list.  int8 reads row r's group scale from
// amax[b, j, r / blk_l] (list_amax_kernel).
template <int P>
__global__ void __launch_bounds__(ROW_THREADS)
scan_lists_kernel(const float* __restrict__ q,
                  const float* __restrict__ list_vecs,
                  const int* __restrict__ list_ids, int p,
                  const int* __restrict__ sel, int sel_stride,
                  const int* __restrict__ own, int nprobe, int lmax, int d,
                  int nsplit, int r_pad, int blk_l, int n_groups,
                  const int* __restrict__ amax, float* __restrict__ cand_v,
                  int* __restrict__ cand_i, int* __restrict__ cand_p) {
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
      const float4* rp = reinterpret_cast<const float4*>(list_vecs + row * d);
      float sc;
      if constexpr (P == P_INT8) {
        const float st = int8_scale(__int_as_float(
            amax[((size_t)b * nprobe + j) * n_groups + (row0 + r) / blk_l]));
        int acc[1];
        warp_row_dots_i8<1>(rp, st, reinterpret_cast<const int*>(qs4), d4, 1,
                            acc);
        sc = dequant(acc[0], sq, st);
      } else {
        float out[1];
        warp_row_dots<1, P == P_BF16>(rp, qs4, d4, 1, out);
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
template <int P>
__global__ void __launch_bounds__(ROW_THREADS)
centroid_chunk_kernel(const float* __restrict__ q,
                      const float* __restrict__ cents, int B, int p, int d,
                      int np_pad, int blk_p, const int* __restrict__ c_amax,
                      float* __restrict__ cand_v, int* __restrict__ cand_i) {
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
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b0 * d);
  int* qi = reinterpret_cast<int*>(qs4);
  if constexpr (P == P_INT8) {
    if (warp < nq) {  // warp-uniform
      const float s = int8_scale(warp_amax(q + (size_t)(b0 + warp) * d, d));
      for (int c = lane; c < d4; c += 32)
        qi[warp * d4 + c] = pack4(q4[warp * d4 + c], s);
      if (lane == 0) sq[warp] = s;
    }
  } else {
    for (int c = threadIdx.x; c < nq * d4; c += blockDim.x)
      qs4[c] = P == P_BF16 ? bf16_round4(q4[c]) : q4[c];
  }
  for (int t = threadIdx.x; t < QTILE * CENTROID_CHUNK; t += blockDim.x) {
    sv[t / CENTROID_CHUNK][t % CENTROID_CHUNK] = -INFINITY;
    si[t / CENTROID_CHUNK][t % CENTROID_CHUNK] = topk_tie::PAD_POS;
    sp[t / CENTROID_CHUNK][t % CENTROID_CHUNK] = topk_tie::PAD_POS;
  }
  __syncthreads();

  const int c0 = blockIdx.x * CENTROID_CHUNK;
  const int n = min(CENTROID_CHUNK, p - c0);
  for (int r = warp; r < n; r += nwarps) {
    const float4* row =
        reinterpret_cast<const float4*>(cents + (size_t)(c0 + r) * d);
    float sc[QTILE];
    if constexpr (P == P_INT8) {
      const float st = int8_scale(__int_as_float(c_amax[(c0 + r) / blk_p]));
      int acc[QTILE];
      warp_row_dots_i8<QTILE>(row, st, qi, d4, nq, acc);
#pragma unroll
      for (int t = 0; t < QTILE; ++t)
        sc[t] = t < nq ? dequant(acc[t], sq[t], st) : 0.f;
    } else {
      warp_row_dots<QTILE, P == P_BF16>(row, qs4, d4, nq, sc);
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

// grid (B, groups).  Block (b, g) merges lists [g*group, (g+1)*group) of
// the n lists of query b, list j at list offset j*stride of the query's
// row of `row` entries, into their best w, and writes it to dst at
// b*dst_row + g*dst_group.  The first pass reads the scan blocks' lists
// (stride 1); a pass with more than one group writes each group's best w
// over the group's first list (which only this block reads), and the
// next pass reads those at stride * group; the last pass has one group
// and writes the output.  cand_p may alias cand_i (stage 1, where the id
// is the tie key, so both stores write the same value); dst_p may be null.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(float* cand_v, int* cand_i, int* cand_p, size_t row, int n,
             int stride, int group, int w, float* dst_v, int* dst_i,
             int* dst_p, size_t dst_row, size_t dst_group) {
  extern __shared__ float smem[];
  const int first = blockIdx.y * group;
  const int m = min(group, n - first) * w;
  float* sv = smem;
  int* si = reinterpret_cast<int*>(sv + m);
  int* sp = si + m;
  const size_t in = (size_t)blockIdx.x * row;
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const size_t src = in + (size_t)(first + t / w) * stride * w + t % w;
    sv[t] = cand_v[src];
    si[t] = cand_i[src];
    sp[t] = cand_p[src];
  }
  __syncthreads();
  topk_tie::merge_lists(sv, si, sp, m / w, w);
  const size_t out = (size_t)blockIdx.x * dst_row + blockIdx.y * dst_group;
  for (int t = threadIdx.x; t < w; t += blockDim.x) {
    dst_v[out + t] = sv[t];
    dst_i[out + t] = si[t];
    if (dst_p != nullptr) dst_p[out + t] = sp[t];
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

int merge_topk_f32(float* cand_v, int* cand_i, int* cand_p, int B,
                   int n_lists, int w, int group, float* out_v, int* out_i,
                   int* out_p, cudaStream_t stream) {
  if (group < 2 || w < 1) return (int)cudaErrorInvalidValue;
  const int smem = (n_lists < group ? n_lists : group) * w *
                   (int)(sizeof(float) + 2 * sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t row = (size_t)n_lists * w;
  int n = n_lists;
  int stride = 1;
  while (n > group) {  // grouped passes, in place (tiling.merge_plan)
    const int groups = (n + group - 1) / group;
    merge_kernel<<<dim3(B, groups), MERGE_THREADS, smem, stream>>>(
        cand_v, cand_i, cand_p, row, n, stride, group, w, cand_v, cand_i,
        cand_p, row, (size_t)group * stride * w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    n = groups;
    stride *= group;
  }
  merge_kernel<<<dim3(B, 1), MERGE_THREADS, smem, stream>>>(
      cand_v, cand_i, cand_p, row, n, stride, group, w, out_v, out_i, out_p,
      (size_t)w, 0);
  return (int)cudaGetLastError();
}

int select_probes(const float* q, const float* cents, int p, int B, int d,
                  int np_pad, int precision, int blk_p, int n_cgroups,
                  int* c_amax, int group, float* s1_v, int* s1_i,
                  float* sel_v, int* sel, cudaStream_t stream) {
  const int nchunks = (p + CENTROID_CHUNK - 1) / CENTROID_CHUNK;
  cudaError_t err;
  if (precision == P_INT8) {
    err = cudaMemsetAsync(c_amax, 0, (size_t)n_cgroups * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    centroid_amax_kernel<<<nchunks, ROW_THREADS, 0, stream>>>(cents, p, d,
                                                              blk_p, c_amax);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = launch(by_precision(precision, centroid_chunk_kernel<P_F32>,
                            centroid_chunk_kernel<P_BF16>,
                            centroid_chunk_kernel<P_INT8>),
               dim3(nchunks, (B + QTILE - 1) / QTILE), ROW_THREADS,
               QTILE * d * (int)sizeof(float), stream, q, cents, B, p, d,
               np_pad, blk_p, (const int*)c_amax, s1_v, s1_i);
  if (err != cudaSuccess) return (int)err;
  return merge_topk_f32(s1_v, s1_i, s1_i, B, nchunks, np_pad, group, sel_v,
                        sel, nullptr, stream);
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

// Stage 2 (+ 3) alone.  q (B, d); list_vecs (p, lmax, d); list_ids (p,
// lmax); sel (B, sel_stride) of which the first nprobe columns are probed;
// own (B, nprobe) or null.  Scratch cand_* holds B * nprobe * nsplit *
// r_pad entries (nsplit = ceil(lmax / 128)) and is merged in place, group
// lists a block (tiling.merge_group).  f32: out_* (B, r_pad) is the top
// r_pad.  bf16 / int8: mid_* (B, r_pad) receives the top r_pad and out_*
// (B, kp) the float32 top kp of its first r; int8 reduces the probed
// lists' group amax into amax (B * nprobe * n_groups ints, groups of
// blk_l rows) first.
int fused_scan_ivf(const float* q, const float* list_vecs,
                   const int* list_ids, int p, const int* sel,
                   int sel_stride, const int* own, int B, int nprobe,
                   int lmax, int d, int precision, int blk_l, int n_groups,
                   int* amax, int r, int r_pad, int kp, int group,
                   float* cand_v, int* cand_i, int* cand_p, float* mid_v,
                   int* mid_i, int* mid_p, float* out_v, int* out_i,
                   int* out_p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsplit = (lmax + SCAN_ROWS - 1) / SCAN_ROWS;
  const dim3 grid(nprobe * nsplit, B);
  cudaError_t err;
  if (precision == P_INT8) {
    err = cudaMemsetAsync(amax, 0, (size_t)B * nprobe * n_groups * sizeof(int),
                          st);
    if (err != cudaSuccess) return (int)err;
    list_amax_kernel<<<grid, ROW_THREADS, 0, st>>>(
        list_vecs, p, sel, sel_stride, own, nprobe, lmax, d, nsplit, blk_l,
        n_groups, amax);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = launch(by_precision(precision, scan_lists_kernel<P_F32>,
                            scan_lists_kernel<P_BF16>,
                            scan_lists_kernel<P_INT8>),
               grid, ROW_THREADS, d * (int)sizeof(float), st, q, list_vecs,
               list_ids, p, sel, sel_stride, own, nprobe, lmax, d, nsplit,
               r_pad, blk_l, n_groups, (const int*)amax, cand_v, cand_i,
               cand_p);
  if (err != cudaSuccess) return (int)err;
  if (precision == P_F32)
    return merge_topk_f32(cand_v, cand_i, cand_p, B, nprobe * nsplit, r_pad,
                          group, out_v, out_i, out_p, st);
  const int e = merge_topk_f32(cand_v, cand_i, cand_p, B, nprobe * nsplit,
                               r_pad, group, mid_v, mid_i, mid_p, st);
  if (e != 0) return e;
  return rerank_rows(q, list_vecs, d, sel, sel_stride, lmax, mid_i, mid_p, B,
                     r_pad, r, kp, out_v, out_i, out_p, st);
}

// Stages 1 + 2 (+ 3).  cents (p, d).  Scratch s1_* holds B * nchunks *
// np_pad entries (nchunks = ceil(p / 128)), merged s1_group lists a
// block; sel_v / sel (B, np_pad) receive the probe set; int8 reduces the
// centroid groups (blk_p rows) into c_amax (n_cgroups ints) first; the
// rest as fused_scan_ivf.
int fused_turn_ivf(const float* q, const float* cents, const float* list_vecs,
                   const int* list_ids, int p, int B, int nprobe, int np_pad,
                   int lmax, int d, int precision, int blk_p, int n_cgroups,
                   int* c_amax, int blk_l, int n_groups, int* amax, int r,
                   int r_pad, int kp, int s1_group, int group, float* s1_v,
                   int* s1_i, float* sel_v, int* sel, float* cand_v,
                   int* cand_i, int* cand_p, float* mid_v, int* mid_i,
                   int* mid_p, float* out_v, int* out_i, int* out_p,
                   void* stream) {
  const int e = select_probes(q, cents, p, B, d, np_pad, precision, blk_p,
                              n_cgroups, c_amax, s1_group, s1_v, s1_i, sel_v,
                              sel, static_cast<cudaStream_t>(stream));
  if (e != 0) return e;
  return fused_scan_ivf(q, list_vecs, list_ids, p, sel, np_pad, nullptr, B,
                        nprobe, lmax, d, precision, blk_l, n_groups, amax, r,
                        r_pad, kp, group, cand_v, cand_i, cand_p, mid_v, mid_i,
                        mid_p, out_v, out_i, out_p, stream);
}

}  // extern "C"
