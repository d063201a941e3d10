// Fused TopLoc_IVF turn kernels for Hopper (sm_90a), float32.
//
// fused_scan_ivf_f32 replaces the Pallas kernel fused_scan (family ivf,
//   rerank=False) of src/repro/kernels/fused_turn.py:644 (body _scan_kernel
//   :482, pallas_call :618): scan the caller's probed posting lists, mask
//   pads and foreign lists, keep the top r_pad under (value desc, flat
//   position asc) with positions numbered probe*lmax + offset.
// fused_turn_ivf_f32 replaces the Pallas kernel fused_turn (family ivf,
//   precision f32) of src/repro/kernels/fused_turn.py:406 (body _turn_kernel
//   :169, pallas_call :368): stage 1 scores every centroid and keeps the
//   tie-aware top np_pad (the centroid index is id and tie key), stage 2 is
//   the fused_scan body driven by that selection.
//
// Bound on this card: device-memory bytes.  A query reads the real rows of
// its nprobe probed lists once (at most 64 x 702 x 768 x 4 B = 138 MB at
// 8.8M docs / 16,384 lists, 41 us at 3.35 TB/s) and does 2 FLOP per 4 B
// read, far below the f32 ridge of ~20 FLOP/B; fused_turn adds the 50 MB
// centroid table.
//
// What the design does about it:
//  * scan: one 256-thread block per (query, probed list, 128-row slice), so
//    a single query already puts 64 x 6 = 384 blocks on the 132 SMs; a
//    row's id is read first and pad rows (-1) are never loaded;
//  * a warp scores one row: float4 loads, up to 8 per lane issued before
//    the first FMA, so a warp keeps a 4 KB row in flight;
//  * stage 1: one block per (128-centroid chunk, 8 queries) reads each
//    centroid row once for all 8 queries;
//  * only each block's top r_pad / np_pad candidates leave the SM; a small
//    second kernel merges a query's sorted lists pairwise in shared memory.
// Scores are reduced in one fixed order (lane-strided FMAs, then a fixed
// xor-shuffle tree) that does not depend on the batch, the grid or the
// slice a row falls in, so a row scores the same at any B.
// Simple first: no TMA, no tensor cores (f32 contract), no persistence.
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

using fused_common::warp_row_dots;

// grid (nprobe * nsplit, B).  Block (j, s) of query b scores rows
// [s*SCAN_ROWS, (s+1)*SCAN_ROWS) of list sel[b, j] and writes its top
// r_pad to cand[b, j*nsplit + s, :].  A list id outside [0, p) scans as an
// empty list.
__global__ void __launch_bounds__(ROW_THREADS)
scan_lists_kernel(const float* __restrict__ q,
                  const float* __restrict__ list_vecs,
                  const int* __restrict__ list_ids, int p,
                  const int* __restrict__ sel, int sel_stride,
                  const int* __restrict__ own, int nprobe, int lmax, int d,
                  int nsplit, int r_pad, float* __restrict__ cand_v,
                  int* __restrict__ cand_i, int* __restrict__ cand_p) {
  extern __shared__ float4 qs4[];
  __shared__ float sv[SCAN_ROWS];
  __shared__ int si[SCAN_ROWS];
  __shared__ int sp[SCAN_ROWS];

  const int b = blockIdx.y;
  const int j = blockIdx.x / nsplit;
  const int s = blockIdx.x % nsplit;
  const int d4 = d >> 2;
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b * d);
  for (int c = threadIdx.x; c < d4; c += blockDim.x) qs4[c] = q4[c];
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
      float sc[1];
      warp_row_dots<1>(reinterpret_cast<const float4*>(list_vecs + row * d),
                       qs4, d4, 1, sc);
      if (lane == 0) {
        sv[r] = sc[0];
        si[r] = id;
        sp[r] = j * lmax + row0 + r;
      }
    }
  }
  topk_tie::block_sort(sv, si, sp, SCAN_ROWS);
  const size_t out = ((size_t)b * gridDim.x + blockIdx.x) * r_pad;
  for (int t = threadIdx.x; t < r_pad; t += blockDim.x) {
    cand_v[out + t] = sv[t];
    cand_i[out + t] = si[t];
    cand_p[out + t] = sp[t];
  }
}

// grid (nchunks, ceil(B / QTILE)).  Block (c, g) scores centroids
// [c*CENTROID_CHUNK, (c+1)*CENTROID_CHUNK) against queries
// [g*QTILE, (g+1)*QTILE) and writes each query's top np_pad (centroid
// index as id and tie key) to cand[b, c, :].
__global__ void __launch_bounds__(ROW_THREADS)
centroid_chunk_kernel(const float* __restrict__ q,
                      const float* __restrict__ cents, int B, int p, int d,
                      int np_pad, float* __restrict__ cand_v,
                      int* __restrict__ cand_i) {
  extern __shared__ float4 qs4[];
  __shared__ float sv[QTILE][CENTROID_CHUNK];
  __shared__ int si[QTILE][CENTROID_CHUNK];
  __shared__ int sp[QTILE][CENTROID_CHUNK];

  const int b0 = blockIdx.y * QTILE;
  const int nq = min(QTILE, B - b0);
  const int d4 = d >> 2;
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b0 * d);
  for (int c = threadIdx.x; c < nq * d4; c += blockDim.x) qs4[c] = q4[c];
  for (int t = threadIdx.x; t < QTILE * CENTROID_CHUNK; t += blockDim.x) {
    sv[t / CENTROID_CHUNK][t % CENTROID_CHUNK] = -INFINITY;
    si[t / CENTROID_CHUNK][t % CENTROID_CHUNK] = topk_tie::PAD_POS;
    sp[t / CENTROID_CHUNK][t % CENTROID_CHUNK] = topk_tie::PAD_POS;
  }
  __syncthreads();

  const int c0 = blockIdx.x * CENTROID_CHUNK;
  const int n = min(CENTROID_CHUNK, p - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < n; r += nwarps) {
    float sc[QTILE];
    warp_row_dots<QTILE>(
        reinterpret_cast<const float4*>(cents + (size_t)(c0 + r) * d), qs4,
        d4, nq, sc);
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
  for (int e = threadIdx.x; e < nq * np_pad; e += blockDim.x) {
    const int t = e / np_pad;
    const int i = e % np_pad;
    const size_t out =
        ((size_t)(b0 + t) * gridDim.x + blockIdx.x) * np_pad + i;
    cand_v[out] = sv[t][i];
    cand_i[out] = si[t][i];
  }
}

// grid (B).  Merges query b's n_lists sorted lists of w entries into its
// best w.  cand_p may alias cand_i (stage 1, where the id is the tie key);
// out_p may be null.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ cand_v, const int* cand_i,
             const int* cand_p, int n_lists, int w,
             float* __restrict__ out_v, int* __restrict__ out_i,
             int* __restrict__ out_p) {
  extern __shared__ float smem[];
  const int n = n_lists * w;
  float* sv = smem;
  int* si = reinterpret_cast<int*>(sv + n);
  int* sp = si + n;
  const size_t in = (size_t)blockIdx.x * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    sv[t] = cand_v[in + t];
    si[t] = cand_i[in + t];
    sp[t] = cand_p[in + t];
  }
  __syncthreads();
  topk_tie::merge_lists(sv, si, sp, n_lists, w);
  const size_t out = (size_t)blockIdx.x * w;
  for (int t = threadIdx.x; t < w; t += blockDim.x) {
    out_v[out + t] = sv[t];
    out_i[out + t] = si[t];
    if (out_p != nullptr) out_p[out + t] = sp[t];
  }
}

}  // namespace

extern "C" {

int merge_topk_f32(const float* cand_v, const int* cand_i, const int* cand_p,
                   int B, int n_lists, int w, float* out_v, int* out_i,
                   int* out_p, cudaStream_t stream) {
  const int smem = n_lists * w * (int)(sizeof(float) + 2 * sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, MERGE_THREADS, smem, stream>>>(
      cand_v, cand_i, cand_p, n_lists, w, out_v, out_i, out_p);
  return (int)cudaGetLastError();
}

int select_probes_f32(const float* q, const float* cents, int p, int B,
                      int d, int np_pad, float* s1_v, int* s1_i,
                      float* sel_v, int* sel, cudaStream_t stream) {
  const int nchunks = (p + CENTROID_CHUNK - 1) / CENTROID_CHUNK;
  const int qsmem = QTILE * d * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      centroid_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      qsmem);
  if (err != cudaSuccess) return (int)err;
  centroid_chunk_kernel<<<dim3(nchunks, (B + QTILE - 1) / QTILE),
                          ROW_THREADS, qsmem, stream>>>(q, cents, B, p, d,
                                                        np_pad, s1_v, s1_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge_topk_f32(s1_v, s1_i, s1_i, B, nchunks, np_pad, sel_v, sel,
                        nullptr, stream);
}

// Stage 2 alone.  q (B, d); list_vecs (p, lmax, d); list_ids (p, lmax);
// sel (B, sel_stride) of which the first nprobe columns are probed;
// own (B, nprobe) or null.  Scratch cand_* holds B * nprobe * nsplit *
// r_pad entries (nsplit = ceil(lmax / 128)); out_* is (B, r_pad).
int fused_scan_ivf_f32(const float* q, const float* list_vecs,
                       const int* list_ids, int p, const int* sel,
                       int sel_stride, const int* own, int B, int nprobe,
                       int lmax, int d, int r_pad, float* cand_v, int* cand_i,
                       int* cand_p, float* out_v, int* out_i, int* out_p,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsplit = (lmax + SCAN_ROWS - 1) / SCAN_ROWS;
  scan_lists_kernel<<<dim3(nprobe * nsplit, B), ROW_THREADS,
                      d * sizeof(float), st>>>(
      q, list_vecs, list_ids, p, sel, sel_stride, own, nprobe, lmax, d,
      nsplit, r_pad, cand_v, cand_i, cand_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge_topk_f32(cand_v, cand_i, cand_p, B, nprobe * nsplit, r_pad,
                        out_v, out_i, out_p, st);
}

// Stages 1 + 2.  cents (p, d).  Scratch s1_* holds B * nchunks * np_pad
// entries (nchunks = ceil(p / 128)); sel_v / sel (B, np_pad) receive the
// probe set; the rest as fused_scan_ivf_f32.
int fused_turn_ivf_f32(const float* q, const float* cents,
                       const float* list_vecs, const int* list_ids, int p,
                       int B, int nprobe, int np_pad, int lmax, int d,
                       int r_pad, float* s1_v, int* s1_i, float* sel_v,
                       int* sel, float* cand_v, int* cand_i, int* cand_p,
                       float* out_v, int* out_i, int* out_p, void* stream) {
  const int e = select_probes_f32(q, cents, p, B, d, np_pad, s1_v, s1_i,
                                 sel_v, sel,
                                 static_cast<cudaStream_t>(stream));
  if (e != 0) return e;
  return fused_scan_ivf_f32(q, list_vecs, list_ids, p, sel, np_pad, nullptr,
                            B, nprobe, lmax, d, r_pad, cand_v, cand_i,
                            cand_p, out_v, out_i, out_p, stream);
}

}  // extern "C"
