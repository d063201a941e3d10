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
// B = 1 that is below a microsecond, so launch latency and the chain of
// dependent steps (LUT, ids, codes, selection, merges, re-rank) set the
// time: the design runs the chain in one launch, on the pattern of the
// IVF scan (ivf_stages.cuh scan_lists_kernel, fold.cuh).
//
// What the design does about it:
//  * scan: one 256-thread block per (query, probed list, 128-row slice):
//    64 x 6 = 384 blocks for one query at the smoke's shapes, so they
//    fill the card.  Each block stages the query's LUT in shared memory
//    (49,152 B at m = 48, opt-in dynamic shared memory) before it waits
//    for the kernel before it (fold::wait_primary: in fused_turn_pq the
//    scan is chained behind stage 1 by programmatic dependent launch),
//    then reads its slice's 128 ids; a slice with no real row scores
//    nothing and writes only a count of 0, and a pad row (id -1) is never
//    loaded.  A thread scores a code row from 16-byte loads;
//  * one warp selects the block's best min(r_pad, 128) in registers
//    (fold::select_slice: topk_tie::warp_sort / warp_merge), and only the
//    real entries leave the SM, with their count;
//  * when the query's top r_pad is one slice wide or less and the fold
//    fits (tiling.scan_fold: the served re-rank depth 64), the launch
//    folds its own lists with arrival counters (fold::fold_query, the IVF
//    scan's code: per probed list, then per query), its arrays over the
//    LUT's shared memory; the block that folds query b also re-ranks the
//    first r candidates against their corpus rows by doc id in float32
//    (fold::rerank_fold, the bits of rerank_kernel) and writes the top
//    kp.  Otherwise fused_turn.cu's merge_kernel (merge_topk_f32) folds
//    the lists after the scan, growing them to r_pad, and rerank_rows
//    (one block a query, up to 2,048 candidates sorted in dynamic shared
//    memory) re-ranks them.
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

#include "fold.cuh"
#include "fused_common.cuh"
#include "topk_tie.cuh"

namespace {

constexpr int ADC_ROWS = fold::SLICE_ROWS;  // rows of a probed list a block
constexpr int ADC_THREADS = 256;

using fused_common::P_BF16;
using fused_common::P_F32;
using fused_common::P_INT8;

constexpr int LUT_LOADS = 8;  // 16-byte LUT loads a thread has in flight

// Largest |x| of the n4 float4s at t4, by the whole block (red: 32
// floats; every thread gets it), LUT_LOADS loads a thread at once.
__device__ __forceinline__ float block_amax4(const float4* __restrict__ t4,
                                             int n4, float* red) {
  float m = 0.f;
  for (int base = threadIdx.x; base < n4; base += LUT_LOADS * blockDim.x) {
    float4 v[LUT_LOADS];
#pragma unroll
    for (int u = 0; u < LUT_LOADS; ++u) {
      const int c = base + u * blockDim.x;
      v[u] = c < n4 ? __ldg(t4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < LUT_LOADS; ++u)
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v[u].x), fabsf(v[u].y)),
                         fmaxf(fabsf(v[u].z), fabsf(v[u].w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

// Stages the query's LUT tb (lut_n floats) in shared memory for precision
// P: float (f32; bf16 rounded) or, for int8, its quantised values in int
// slots with one scale a table (returned; 0 otherwise).  16-byte loads,
// LUT_LOADS a thread in flight, when the LUT is whole float4s; else one
// value a thread at a time.  All threads of the block call it; the
// caller synchronises before reading the LUT.
template <int P>
__device__ __forceinline__ float stage_lut(const float* __restrict__ tb,
                                           int lut_n, float* lut,
                                           float* red) {
  using namespace fused_common;
  const bool vec = (lut_n & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(tb) & 15) == 0;
  float st = 0.f;
  if constexpr (P == P_INT8)
    st = int8_scale(vec ? block_amax4(reinterpret_cast<const float4*>(tb),
                                      lut_n >> 2, red)
                        : block_amax(tb, lut_n, red));
  if (!vec) {
    for (int t = threadIdx.x; t < lut_n; t += blockDim.x) {
      if constexpr (P == P_INT8)
        reinterpret_cast<int*>(lut)[t] = quant8(tb[t], st);
      else
        lut[t] = P == P_BF16 ? bf16_round(tb[t]) : tb[t];
    }
    return st;
  }
  const float4* t4 = reinterpret_cast<const float4*>(tb);
  const int n4 = lut_n >> 2;
  for (int base = threadIdx.x; base < n4; base += LUT_LOADS * blockDim.x) {
    float4 v[LUT_LOADS];
#pragma unroll
    for (int u = 0; u < LUT_LOADS; ++u) {
      const int c = base + u * blockDim.x;
      if (c < n4) v[u] = __ldg(t4 + c);
    }
#pragma unroll
    for (int u = 0; u < LUT_LOADS; ++u) {
      const int c = base + u * blockDim.x;
      if (c >= n4) continue;
      if constexpr (P == P_INT8)
        reinterpret_cast<int4*>(lut)[c] =
            make_int4(quant8(v[u].x, st), quant8(v[u].y, st),
                      quant8(v[u].z, st), quant8(v[u].w, st));
      else
        reinterpret_cast<float4*>(lut)[c] =
            P == P_BF16 ? bf16_round4(v[u]) : v[u];
    }
  }
  return st;
}

// grid (nprobe * nsplit, B).  Block (j, s) of query b scores rows
// [s*ADC_ROWS, (s+1)*ADC_ROWS) of list sel[b, j] with the LUT tables[b]
// (m, n_codes) at precision P and writes its best min(w, real rows) to
// slot (b, j*nsplit + s) of cand_* (slots of w entries) and that count to
// cand_n.  A list outside [0, p) or not owned scans as an empty list.
// The LUT is staged in shared memory as float (f32, bf16-rounded) or as
// its int8 values in int slots (stage_lut), before fold::wait_primary;
// sel and the lists after it (sel and own are not __restrict__: a load
// the compiler may treat as invariant could move above the wait).  With
// counters (B * nprobe + B zeroed ints; w == r_pad) the launch folds the
// query's lists (fold::fold_query); the block that
// folds query b writes its top w to out_* (B, w) or, with rr > 0,
// re-ranks its first rr candidates against q and the corpus rows in
// float32 (fold::rerank_fold) and writes the top kp to out_* (B, kp).
// Dynamic shared memory: the LUT, then the fold's max(nsplit, nprobe) * w
// entries over it.
template <int P>
__global__ void __launch_bounds__(ADC_THREADS)
adc_scan_kernel(const float* __restrict__ tables, int m, int n_codes,
                const uint8_t* __restrict__ codes,
                const int* __restrict__ list_ids, int p, const int* sel,
                int sel_stride, const int* own, int nprobe, int lmax,
                int nsplit, int w, float* cand_v, int* cand_i, int* cand_p,
                int* cand_n, int* counters, const float* __restrict__ q,
                const float* __restrict__ corpus, int d, int rr, int kp,
                float* out_v, int* out_i, int* out_p) {
  using Acc = typename std::conditional<P == P_INT8, int, float>::type;
  extern __shared__ float lut[];
  __shared__ float sv[ADC_ROWS];
  __shared__ int si[ADC_ROWS];
  __shared__ int sp[ADC_ROWS];
  __shared__ float red[32];

  const int b = blockIdx.y;
  const int j = blockIdx.x / nsplit;
  const int s = blockIdx.x % nsplit;
  const int lut_n = m * n_codes;
  const float* tb = tables + (size_t)b * lut_n;
  const float st = stage_lut<P>(tb, lut_n, lut, red);  // int8: its scale
  Acc* tab = reinterpret_cast<Acc*>(lut);
  fold::wait_primary();

  const int list = sel[(size_t)b * sel_stride + j];
  const bool owned = list >= 0 && list < p &&
                     (own == nullptr || own[(size_t)b * nprobe + j] > 0);
  const int row0 = s * ADC_ROWS;
  const int nrows = owned ? min(ADC_ROWS, lmax - row0) : 0;
  const size_t slot = (size_t)b * gridDim.x + blockIdx.x;
  int id = -1;
  if (threadIdx.x < nrows)
    id = list_ids[(size_t)list * lmax + row0 + threadIdx.x];
  if (threadIdx.x < ADC_ROWS) {
    si[threadIdx.x] = id;
    sv[threadIdx.x] = -INFINITY;
    sp[threadIdx.x] = topk_tie::PAD_POS;
  }
  // also orders the LUT's stores before its reads
  const int n_real = __syncthreads_count(id >= 0);
  if (n_real > 0) {
    if (id >= 0) {
      const uint8_t* c = codes + ((size_t)list * lmax + row0 + threadIdx.x) * m;
      // 16-byte code loads when every row starts on a 16-byte boundary
      const bool vec16 =
          (m % 16) == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
      Acc acc = 0;
      if (vec16) {
        for (int j0 = 0; j0 < m; j0 += 16) {
          const uint4 cw = __ldg(reinterpret_cast<const uint4*>(c + j0));
          const unsigned words[4] = {cw.x, cw.y, cw.z, cw.w};
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
        sv[threadIdx.x] = __fdiv_rn(__int2float_rn(acc), st);
      else
        sv[threadIdx.x] = acc;
      sp[threadIdx.x] = j * lmax + row0 + threadIdx.x;
    }
    __syncthreads();
  }
  fold::select_slice(sv, si, sp, w, n_real, cand_v, cand_i, cand_p, cand_n,
                     slot);
  if (counters == nullptr) return;  // merge_topk_f32 folds the lists

  int *fi, *fp;
  if (!fold::fold_query(lut, cand_v, cand_i, cand_p, cand_n, counters, b, j,
                        nprobe, nsplit, w, gridDim.y, &fi, &fp))
    return;
  if (rr == 0)
    fold::write_fold(lut, fi, fp, b, w, out_v, out_i, out_p);
  else
    fold::rerank_fold(fi, fp, sv, w, rr, kp, q, corpus, d, nullptr, 0, 0, b,
                      out_v, out_i, out_p);
}

// The ADC scan at `precision` into out_*: folded in its launch with
// counters (w == r_pad; re-ranked into (B, kp) when rr > 0, else the top
// r_pad (B, r_pad)), else merged after it into the top r_pad by
// merge_topk_f32.  pdl: chained behind stage 1 (fused_turn_pq).
int adc_scan(const float* tables, int m, int n_codes, const uint8_t* codes,
             const int* list_ids, int p, const int* sel, int sel_stride,
             const int* own, int B, int nprobe, int lmax, int r_pad,
             int precision, float* cand_v, int* cand_i, int* cand_p,
             int* cand_n, int* counters, const float* q, const float* corpus,
             int d, int rr, int kp, float* out_v, int* out_i, int* out_p,
             bool pdl, cudaStream_t st) {
  const int nsplit = (lmax + ADC_ROWS - 1) / ADC_ROWS;
  const int w = min(r_pad, ADC_ROWS);
  if (counters != nullptr && w != r_pad) return (int)cudaErrorInvalidValue;
  int smem = m * n_codes * (int)sizeof(float);
  if (counters != nullptr) smem = max(smem, max(nsplit, nprobe) * w * 12);
  const cudaError_t err = fused_common::launch_after(
      pdl,
      fused_common::by_precision(precision, adc_scan_kernel<P_F32>,
                                 adc_scan_kernel<P_BF16>,
                                 adc_scan_kernel<P_INT8>),
      dim3(nprobe * nsplit, B), ADC_THREADS, smem, st, tables, m, n_codes,
      codes, list_ids, p, sel, sel_stride, own, nprobe, lmax, nsplit, w,
      cand_v, cand_i, cand_p, cand_n, counters, q, corpus, d, rr, kp, out_v,
      out_i, out_p);
  if (err != cudaSuccess || counters != nullptr) return (int)err;
  return merge_topk_f32(cand_v, cand_i, cand_p, cand_n, B, nprobe * nsplit, w,
                        r_pad, -1, out_v, out_i, out_p, st);
}

// fused_scan_pq's body; pdl as adc_scan's.
int scan_pq(const float* tables, const float* q, int m, int n_codes,
            const uint8_t* codes, const int* list_ids, int p, const int* sel,
            int sel_stride, const int* own, const float* corpus, int B,
            int nprobe, int lmax, int d, int precision, int r, int r_pad,
            int kp, int rerank, float* cand_v, int* cand_i, int* cand_p,
            int* cand_n, int* counters, float* mid_v, int* mid_i, int* mid_p,
            float* out_v, int* out_i, int* out_p, bool pdl,
            cudaStream_t st) {
  if (!rerank || counters != nullptr)
    return adc_scan(tables, m, n_codes, codes, list_ids, p, sel, sel_stride,
                    own, B, nprobe, lmax, r_pad, precision, cand_v, cand_i,
                    cand_p, cand_n, counters, q, corpus, d, rerank ? r : 0,
                    kp, out_v, out_i, out_p, pdl, st);
  const int e = adc_scan(tables, m, n_codes, codes, list_ids, p, sel,
                         sel_stride, own, B, nprobe, lmax, r_pad, precision,
                         cand_v, cand_i, cand_p, cand_n, nullptr, q, corpus, d,
                         0, kp, mid_v, mid_i, mid_p, pdl, st);
  if (e != 0) return e;
  return rerank_rows(q, corpus, d, nullptr, 0, 0, mid_i, mid_p, B, r_pad, r,
                     kp, out_v, out_i, out_p, st);
}

}  // namespace

extern "C" {

// ADC scan alone.  tables (B, m, n_codes); codes (p, lmax, m) uint8;
// list_ids (p, lmax); sel (B, nprobe).  Scratch cand_* holds
// B * nprobe * nsplit * w entries (nsplit = ceil(lmax / 128), w =
// min(r_pad, 128)) and what merge_topk_f32 adds past them
// (tiling.merge_scratch), cand_n B * nprobe * nsplit counts; with counters
// (B * nprobe + B zeroed ints, r_pad <= 128) the launch folds the lists
// itself.  out_* is (B, r_pad): ADC values, doc ids, flat positions.
int pq_adc_scan_f32(const float* tables, int m, int n_codes,
                    const uint8_t* codes, const int* list_ids, int p,
                    const int* sel, int B, int nprobe, int lmax, int r_pad,
                    float* cand_v, int* cand_i, int* cand_p, int* cand_n,
                    int* counters, float* out_v, int* out_i, int* out_p,
                    void* stream) {
  return adc_scan(tables, m, n_codes, codes, list_ids, p, sel, nprobe,
                  nullptr, B, nprobe, lmax, r_pad, P_F32, cand_v, cand_i,
                  cand_p, cand_n, counters, nullptr, nullptr, 0, 0, r_pad,
                  out_v, out_i, out_p, false,
                  static_cast<cudaStream_t>(stream));
}

// ADC scan at `precision` with the caller's sel (B, sel_stride) and own
// (B, nprobe) or null; scratch and counters as pq_adc_scan_f32's.
// rerank != 0: out_* (B, kp) receives the exact float32 top kp of the ADC
// top r_pad's first r candidates, against q (B, d) and corpus (N, d)
// (mid_* (B, r_pad) the ADC top r_pad when the launch does not fold).
// rerank == 0: out_* (B, r_pad) is the ADC top r_pad (mid_* unused; q and
// corpus may be null).
int fused_scan_pq(const float* tables, const float* q, int m, int n_codes,
                  const uint8_t* codes, const int* list_ids, int p,
                  const int* sel, int sel_stride, const int* own,
                  const float* corpus, int B, int nprobe, int lmax, int d,
                  int precision, int r, int r_pad, int kp, int rerank,
                  float* cand_v, int* cand_i, int* cand_p, int* cand_n,
                  int* counters, float* mid_v, int* mid_i, int* mid_p,
                  float* out_v, int* out_i, int* out_p, void* stream) {
  return scan_pq(tables, q, m, n_codes, codes, list_ids, p, sel, sel_stride,
                 own, corpus, B, nprobe, lmax, d, precision, r, r_pad, kp,
                 rerank, cand_v, cand_i, cand_p, cand_n, counters, mid_v,
                 mid_i, mid_p, out_v, out_i, out_p, false,
                 static_cast<cudaStream_t>(stream));
}

// Whole IVF-PQ turn.  cents (p, d); stage 1 as fused_turn_ivf's
// (select_probes: scratch s1_*, s1_counters for its fold, int8 centroid
// groups of blk_p rows read from the cached c_amax); sel_v / sel (B,
// np_pad) receive the probe set, of which the first nprobe are scanned;
// the ADC scan is chained behind stage 1 (programmatic dependent launch)
// and runs as fused_scan_pq with rerank.
int fused_turn_pq(const float* q, const float* cents, const float* tables,
                  int m, int n_codes, const uint8_t* codes,
                  const int* list_ids, int p, const float* corpus, int B,
                  int nprobe, int np_pad, int lmax, int d, int precision,
                  int blk_p, const int* c_amax, int r, int r_pad, int kp,
                  float* s1_v, int* s1_i, int* s1_counters, float* sel_v,
                  int* sel, float* cand_v, int* cand_i, int* cand_p,
                  int* cand_n, int* counters, float* mid_v, int* mid_i,
                  int* mid_p, float* out_v, int* out_i, int* out_p,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = select_probes(q, cents, p, B, d, np_pad, precision, blk_p,
                              c_amax, s1_v, s1_i, s1_counters, sel_v, sel,
                              st);
  if (e != 0) return e;
  return scan_pq(tables, q, m, n_codes, codes, list_ids, p, sel, np_pad,
                 nullptr, corpus, B, nprobe, lmax, d, precision, r, r_pad, kp,
                 1, cand_v, cand_i, cand_p, cand_n, counters, mid_v, mid_i,
                 mid_p, out_v, out_i, out_p, true, st);
}

}  // extern "C"
