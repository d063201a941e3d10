// IVF-PQ kernels of TopLoc_IVFPQ for Hopper (sm_90a): float32, bf16 and
// int8 ADC.
//
// pq_adc_scan_f32 replaces the Pallas kernel pq_adc_scan of
//   src/repro/kernels/pq_adc.py:79 (body _kernel :41, pallas_call :112):
//   ADC scores of the probed lists' uint8 codes, -1 pads masked, top r.
// fused_scan_pq replaces fused_scan_pq (family pq) of
//   src/repro/kernels/fused_turn.py:686 (body _scan_kernel :482,
//   pallas_call :618): the ADC scan with the caller's selection and an
//   `own` mask, then either the exact re-rank of the ADC top r against the
//   float corpus (-> top k, position = ADC rank) or the ADC top r itself
//   with flat positions probe*lmax + offset.
// fused_turn_pq replaces fused_turn_pq of
//   src/repro/kernels/fused_turn.py:445 (body _turn_kernel :169,
//   pallas_call :368): stage 1 of fused_turn.cu (centroids -> sel, at the
//   turn's precision), the ADC scan of sel, the exact re-rank.
//
// ADC score of a code row: acc = 0; acc += lut[j][code_j] for j = 0..m-1,
// in float32 and in that order: the Pallas kernels' order (one one-hot dot
// per subquantizer) and that of the plain versions (kernels/ref.py
// adc_sum), so candidate sets agree bit for bit.  bf16 rounds the LUT to
// bfloat16 first; int8 quantises it with one scale per (m, n_codes) table
// (adc_score_tile :117), sums the int8 entries in int32 (exact) and
// divides once by the scale.  The re-rank is float32 whatever the
// precision.  Candidates are ordered by (value desc, flat position asc),
// lax.top_k's order (topk_tie.cuh).
//
// Bound on this card: device-memory bytes and launch latency.  A query
// reads the code rows of its nprobe probed lists (at most 64 x 702 x 48 B
// = 2.2 MB at the smoke's shapes, 0.66 us at 3.35 TB/s), their ids and
// its 48 KB LUT; the re-rank reads r rows of the corpus (64 x 3 KB).  At
// B = 1 that is below a microsecond, so launch latency and the few
// dependent steps (scan, merge, re-rank) set the time.
//
// What the design does about it:
//  * scan: one 256-thread block per (query, probed list, 512-row slice),
//    128 blocks for one query at the smoke's shapes; the block stages the
//    query's LUT in shared memory (49,152 B at m = 48, opt-in dynamic
//    shared memory), a thread scores a code row from 16-byte loads, and a
//    pad row (id -1) is never loaded;
//  * only each block's top r_pad leaves the SM; fused_turn.cu's merge
//    kernel (merge_topk_f32) folds a query's sorted lists, group by group
//    where they do not fit one block;
//  * re-rank: fused_turn.cu's rerank_rows, one block per query, gathers
//    the merged candidates' corpus rows by doc id, one warp per row in a
//    fixed order (warp_row_dots), so a row scores the same at any B; ranks
//    >= r (the power-of-two padding) never re-enter; up to 2,048
//    candidates sort in dynamic shared memory.
// Simple first: no TMA, no persistence, the LUT reads may conflict on
// shared-memory banks.
//
// Plain C interface (bound with ctypes): every entry returns a cudaError_t
// as int, 0 when every launch was accepted.  Codes must be < n_codes
// and ids < the corpus rows: nothing here checks, so indexes are checked
// where they come in (pq.check_index).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "fused_common.cuh"
#include "topk_tie.cuh"

namespace {

constexpr int PQ_ROWS = 512;         // rows of a probed list per block
constexpr int ADC_THREADS = 256;

using fused_common::P_BF16;
using fused_common::P_F32;
using fused_common::P_INT8;

// grid (nprobe * nsplit, B).  Block (j, s) of query b scores rows
// [s*PQ_ROWS, (s+1)*PQ_ROWS) of list sel[b, j] with the LUT tables[b]
// (m, n_codes) at precision P and writes its top r_pad to
// cand[b, j*nsplit + s, :].  A list outside [0, p) or not owned scans as
// an empty list.  The LUT is staged in shared memory as float (f32,
// bf16-rounded) or as its int8 values in int slots.
template <int P>
__global__ void __launch_bounds__(ADC_THREADS)
adc_scan_kernel(const float* __restrict__ tables, int m, int n_codes,
                const uint8_t* __restrict__ codes,
                const int* __restrict__ list_ids, int p,
                const int* __restrict__ sel, int sel_stride,
                const int* __restrict__ own, int nprobe, int lmax,
                int nsplit, int r_pad, float* __restrict__ cand_v,
                int* __restrict__ cand_i, int* __restrict__ cand_p) {
  using Acc = typename std::conditional<P == P_INT8, int, float>::type;
  extern __shared__ float lut[];
  __shared__ float sv[PQ_ROWS];
  __shared__ int si[PQ_ROWS];
  __shared__ int sp[PQ_ROWS];
  __shared__ float red[32];

  const int b = blockIdx.y;
  const int j = blockIdx.x / nsplit;
  const int s = blockIdx.x % nsplit;
  const int lut_n = m * n_codes;
  const float* tb = tables + (size_t)b * lut_n;
  Acc* tab = reinterpret_cast<Acc*>(lut);
  float st = 0.f;  // int8: the table's scale
  if constexpr (P == P_INT8) {
    st = fused_common::int8_scale(fused_common::block_amax(tb, lut_n, red));
    for (int t = threadIdx.x; t < lut_n; t += blockDim.x)
      tab[t] = fused_common::quant8(tb[t], st);
  } else {
    for (int t = threadIdx.x; t < lut_n; t += blockDim.x)
      tab[t] = P == P_BF16 ? fused_common::bf16_round(tb[t]) : tb[t];
  }

  const int list = sel[(size_t)b * sel_stride + j];
  const bool owned = list >= 0 && list < p &&
                     (own == nullptr || own[(size_t)b * nprobe + j] > 0);
  const int row0 = s * PQ_ROWS;
  const int nrows = min(PQ_ROWS, lmax - row0);
  // 16-byte code loads when every row starts on a 16-byte boundary
  const bool vec16 =
      (m % 16) == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  __syncthreads();

  for (int r = threadIdx.x; r < PQ_ROWS; r += blockDim.x) {
    float v = -INFINITY;
    int id = -1;
    int pos = topk_tie::PAD_POS;
    if (owned && r < nrows) {
      const size_t row = (size_t)list * lmax + row0 + r;
      const int rid = list_ids[row];
      if (rid >= 0) {
        const uint8_t* c = codes + row * m;
        Acc acc = 0;
        if (vec16) {
          for (int j0 = 0; j0 < m; j0 += 16) {
            const uint4 w = __ldg(reinterpret_cast<const uint4*>(c + j0));
            const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
              for (int by = 0; by < 4; ++by) {
                const int sub = j0 + wi * 4 + by;
                acc += tab[sub * n_codes + ((words[wi] >> (8 * by)) & 0xffu)];
              }
            }
          }
        } else {
          for (int sub = 0; sub < m; ++sub)
            acc += tab[sub * n_codes + __ldg(c + sub)];
        }
        if constexpr (P == P_INT8)
          v = __fdiv_rn(__int2float_rn(acc), st);
        else
          v = acc;
        id = rid;
        pos = j * lmax + row0 + r;
      }
    }
    sv[r] = v;
    si[r] = id;
    sp[r] = pos;
  }
  topk_tie::block_sort(sv, si, sp, PQ_ROWS);
  // the block's best min(r_pad, PQ_ROWS), then pads up to r_pad
  const size_t out = ((size_t)b * gridDim.x + blockIdx.x) * r_pad;
  for (int t = threadIdx.x; t < r_pad; t += blockDim.x) {
    const bool kept = t < PQ_ROWS;
    cand_v[out + t] = kept ? sv[t] : -INFINITY;
    cand_i[out + t] = kept ? si[t] : -1;
    cand_p[out + t] = kept ? sp[t] : topk_tie::PAD_POS;
  }
}

// ADC scan at `precision` + merge: a query's top r_pad (out_*, (B,
// r_pad)).
int adc_scan_merge(const float* tables, int m, int n_codes,
                   const uint8_t* codes, const int* list_ids, int p,
                   const int* sel, int sel_stride, const int* own, int B,
                   int nprobe, int lmax, int r_pad, int precision,
                   float* cand_v, int* cand_i, int* cand_p, float* out_v,
                   int* out_i, int* out_p, cudaStream_t st) {
  const int nsplit = (lmax + PQ_ROWS - 1) / PQ_ROWS;
  const cudaError_t err = fused_common::launch(
      fused_common::by_precision(precision, adc_scan_kernel<P_F32>,
                                 adc_scan_kernel<P_BF16>,
                                 adc_scan_kernel<P_INT8>),
      dim3(nprobe * nsplit, B), ADC_THREADS,
      m * n_codes * (int)sizeof(float), st, tables, m, n_codes, codes,
      list_ids, p, sel, sel_stride, own, nprobe, lmax, nsplit, r_pad, cand_v,
      cand_i, cand_p);
  if (err != cudaSuccess) return (int)err;
  return merge_topk_f32(cand_v, cand_i, cand_p, nullptr, B, nprobe * nsplit,
                        r_pad, r_pad, -1, out_v, out_i, out_p, st);
}

}  // namespace

extern "C" {

// ADC scan alone.  tables (B, m, n_codes); codes (p, lmax, m) uint8;
// list_ids (p, lmax); sel (B, nprobe).  Scratch cand_* holds
// B * nprobe * nsplit * r_pad entries (nsplit = ceil(lmax / 512)), merged
// in place (tiling.merge_plan); out_* is (B, r_pad): ADC values, doc ids,
// flat positions.
int pq_adc_scan_f32(const float* tables, int m, int n_codes,
                    const uint8_t* codes, const int* list_ids, int p,
                    const int* sel, int B, int nprobe, int lmax, int r_pad,
                    float* cand_v, int* cand_i, int* cand_p, float* out_v,
                    int* out_i, int* out_p, void* stream) {
  return adc_scan_merge(tables, m, n_codes, codes, list_ids, p, sel, nprobe,
                        nullptr, B, nprobe, lmax, r_pad, P_F32, cand_v,
                        cand_i, cand_p, out_v, out_i, out_p,
                        static_cast<cudaStream_t>(stream));
}

// ADC scan at `precision` with the caller's sel (B, sel_stride) and own
// (B, nprobe) or null.  rerank != 0: mid_* (B, r_pad) receives the ADC
// top r_pad and out_* (B, kp) the exact float32 top kp of its first r
// candidates, against q (B, d) and corpus (N, d).  rerank == 0: out_*
// (B, r_pad) is the ADC top r_pad (mid_* unused; q and corpus may be
// null).
int fused_scan_pq(const float* tables, const float* q, int m, int n_codes,
                  const uint8_t* codes, const int* list_ids, int p,
                  const int* sel, int sel_stride, const int* own,
                  const float* corpus, int B, int nprobe, int lmax, int d,
                  int precision, int r, int r_pad, int kp, int rerank,
                  float* cand_v, int* cand_i, int* cand_p,
                  float* mid_v, int* mid_i, int* mid_p, float* out_v,
                  int* out_i, int* out_p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!rerank)
    return adc_scan_merge(tables, m, n_codes, codes, list_ids, p, sel,
                          sel_stride, own, B, nprobe, lmax, r_pad, precision,
                          cand_v, cand_i, cand_p, out_v, out_i, out_p, st);
  const int e = adc_scan_merge(tables, m, n_codes, codes, list_ids, p, sel,
                               sel_stride, own, B, nprobe, lmax, r_pad,
                               precision, cand_v, cand_i, cand_p, mid_v,
                               mid_i, mid_p, st);
  if (e != 0) return e;
  return rerank_rows(q, corpus, d, nullptr, 0, 0, mid_i, mid_p, B, r_pad, r,
                     kp, out_v, out_i, out_p, st);
}

// Whole IVF-PQ turn.  cents (p, d); scratch s1_* as select_probes'
// (fused_common.cuh); sel_v / sel (B, np_pad)
// receive the probe set (int8: centroid groups of blk_p rows, reduced
// into c_amax, n_cgroups ints), of which the first nprobe are scanned;
// the rest as fused_scan_pq with rerank.
int fused_turn_pq(const float* q, const float* cents, const float* tables,
                  int m, int n_codes, const uint8_t* codes,
                  const int* list_ids, int p, const float* corpus, int B,
                  int nprobe, int np_pad, int lmax, int d, int precision,
                  int blk_p, int n_cgroups, int* c_amax, int r, int r_pad,
                  int kp, float* s1_v, int* s1_i,
                  float* sel_v, int* sel, float* cand_v, int* cand_i,
                  int* cand_p, float* mid_v, int* mid_i, int* mid_p,
                  float* out_v, int* out_i, int* out_p, void* stream) {
  const int e = select_probes(q, cents, p, B, d, np_pad, precision, blk_p,
                              n_cgroups, c_amax, s1_v, s1_i, sel_v, sel,
                              static_cast<cudaStream_t>(stream));
  if (e != 0) return e;
  return fused_scan_pq(tables, q, m, n_codes, codes, list_ids, p, sel, np_pad,
                       nullptr, corpus, B, nprobe, lmax, d, precision, r,
                       r_pad, kp, 1, cand_v, cand_i, cand_p, mid_v,
                       mid_i, mid_p, out_v, out_i, out_p, stream);
}

}  // extern "C"
