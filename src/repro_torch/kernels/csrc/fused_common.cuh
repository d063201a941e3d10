// Device and host pieces shared by the port's CUDA sources.
//
// warp_row_dots / warp_row_dots_i8: the fixed-order row scoring of the
//   fused IVF kernels (fused_turn.cu) that the IVF-PQ exact re-rank
//   (pq_adc.cu) reuses, so a row scores the same bits in every kernel and
//   at any batch size; float32, bf16-rounded or int8 operands.
// The precision contract (src/repro/kernels/fused_turn.py:81-150):
//   bf16 rounds both operands to bfloat16, nearest even, and sums their
//   products (exact in f32) in float32; int8 quantises symmetrically,
//   scale = 127 / max(amax, 1e-30), q = clip(rint(x * scale), -127, 127),
//   takes the int32 dot (exact) and dequantises f32(acc) / (sq * st).
//   Every step is one IEEE operation in a fixed order (no fast math), so
//   kernel and plain version (kernels/ref.py) agree bit for bit.
// launch / by_precision: a launch with its dynamic shared memory set and
//   its error returned, and the instance of a kernel for a precision code.
// merge_topk_f32 / select_probes / rerank_rows: the candidate merge, the
//   centroid stage (stage 1) and the float32 re-rank of fused_turn.cu,
//   exported with C linkage so pq_adc.cu launches the same kernels inside
//   the one library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_common {

constexpr int UNROLL = 8;  // float4 loads in flight per lane

// Precision of the quantised scoring stages (fused_turn.PRECISION_CODE).
enum Precision { P_F32 = 0, P_BF16 = 1, P_INT8 = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 bf16_round4(float4 v) {
  return make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                     bf16_round(v.w));
}

// The int8 scale of a group whose largest |x| is amax.
__device__ __forceinline__ float int8_scale(float amax) {
  return __fdiv_rn(127.f, fmaxf(amax, 1e-30f));
}

__device__ __forceinline__ int quant8(float x, float scale) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(x, scale)), -127.f), 127.f);
}

// Four quantised values packed as the signed bytes __dp4a reads.
__device__ __forceinline__ int pack4(float4 v, float scale) {
  return (quant8(v.x, scale) & 0xff) | ((quant8(v.y, scale) & 0xff) << 8) |
         ((quant8(v.z, scale) & 0xff) << 16) |
         (int)((unsigned)quant8(v.w, scale) << 24);
}

// f32(acc) / (sq * st): the product first, then one IEEE divide.
__device__ __forceinline__ float dequant(int acc, float sq, float st) {
  return __fdiv_rn(__int2float_rn(acc), __fmul_rn(sq, st));
}

// Largest |x| over x[0, n), by one warp (all 32 lanes call; all get it).
__device__ __forceinline__ float warp_amax(const float* x, int n) {
  float m = 0.f;
  for (int i = threadIdx.x & 31; i < n; i += 32) m = fmaxf(m, fabsf(x[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Largest |x| over x[0, n), by the whole block; red holds 32 floats of
// shared memory.  Every thread calls it and gets the result.
__device__ __forceinline__ float block_amax(const float* x, int n,
                                            float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, fabsf(x[i]));
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

// Scores one row against nq <= NQ queries staged in shared memory (query t
// at qs4 + t * d4), by one warp, in a fixed order: per lane, FMAs over the
// float4 columns lane, lane + 32, ... in ascending order, then an
// xor-shuffle tree.  The order for a (row, query) pair depends on neither
// NQ nor nq.  BF16 rounds the row's values to bfloat16 as they load (the
// caller stages the queries rounded): products of two bf16 values are
// exact, so each FMA rounds once, as a float32 sum of them does.  All 32
// lanes must call it and all end with the scores.
template <int NQ, bool BF16 = false>
__device__ __forceinline__ void warp_row_dots(const float4* __restrict__ row,
                                              const float4* qs4, int d4,
                                              int nq, float (&out)[NQ]) {
  const int lane = threadIdx.x & 31;
  float acc[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) acc[t] = 0.f;
  for (int base = 0; base < d4; base += 32 * UNROLL) {
    float4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + u * 32 + lane;
      x[u] = c < d4 ? __ldg(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      if (BF16) x[u] = bf16_round4(x[u]);
    }
#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      if (t < nq) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = base + u * 32 + lane;
          if (c < d4) {
            const float4 y = qs4[t * d4 + c];
            acc[t] = fmaf(x[u].x, y.x, acc[t]);
            acc[t] = fmaf(x[u].y, y.y, acc[t]);
            acc[t] = fmaf(x[u].z, y.z, acc[t]);
            acc[t] = fmaf(x[u].w, y.w, acc[t]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
    out[t] = acc[t];
  }
}

// The int8 form: the row's values quantised with its group's scale st as
// they load, packed four to an int, and dotted with the nq <= NQ packed
// queries (query t at qi + t * d4) by __dp4a into int32 sums, which are
// exact, so their order does not matter.  All 32 lanes must call it and
// all end with the sums.
template <int NQ>
__device__ __forceinline__ void warp_row_dots_i8(
    const float4* __restrict__ row, float st, const int* qi, int d4, int nq,
    int (&out)[NQ]) {
  const int lane = threadIdx.x & 31;
  int acc[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) acc[t] = 0;
  for (int base = 0; base < d4; base += 32 * UNROLL) {
    int x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + u * 32 + lane;
      x[u] = c < d4 ? pack4(__ldg(row + c), st) : 0;
    }
#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      if (t < nq) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = base + u * 32 + lane;
          if (c < d4) acc[t] = __dp4a(x[u], qi[t * d4 + c], acc[t]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
    out[t] = acc[t];
  }
}

// The instance of a kernel template for a precision code (the launch
// modules pass only the codes of fused_turn.PRECISION_CODE).
template <typename K>
K by_precision(int precision, K f32, K bf16, K int8) {
  return precision == P_INT8 ? int8 : precision == P_BF16 ? bf16 : f32;
}

// Sets a kernel's dynamic shared memory and launches it; the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                   int smem, cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace fused_common

extern "C" {

// Merges each query's n_lists sorted lists of w candidates (cand_*, laid
// out (B, n_lists, w)) into its best w (out_*, (B, w)) under (value desc,
// position asc).  A block holds at most `group` lists (>= 2); more lists
// are merged group by group, in place in cand_*, over several passes
// (tiling.merge_plan), which leaves the order of a one-block merge.
// cand_p may alias cand_i; out_p may be null.
int merge_topk_f32(float* cand_v, int* cand_i, int* cand_p, int B,
                   int n_lists, int w, int group, float* out_v, int* out_i,
                   int* out_p, cudaStream_t stream);

// Stage 1: scores the p centroids (p, d) against q (B, d) at `precision`
// and writes each query's tie-aware top np_pad to sel_v / sel
// (B, np_pad), through the scratch s1_* of B * ceil(p / 128) * np_pad
// entries, merged `group` lists a block.  int8 scores centroid groups of
// blk_p rows, their largest |x| reduced into c_amax (n_cgroups ints,
// null unless int8) first.
int select_probes(const float* q, const float* cents, int p, int B, int d,
                  int np_pad, int precision, int blk_p, int n_cgroups,
                  int* c_amax, int group, float* s1_v, int* s1_i,
                  float* sel_v, int* sel, cudaStream_t stream);

// Float32 re-rank: for each query b, the r_pad candidates cand_i[b] (-1 =
// pad) are scored exactly against q[b]; ranks >= r and pads score -inf;
// out_* (B, kp) receives the top kp by (exact score desc, rank asc) as
// (score, id, rank).  A candidate's row is corpus[id] (sel null) or, for
// IVF candidates at flat positions cand_p[b] (probe * lmax + offset),
// rows[(sel[b * sel_stride + probe] * lmax + offset)].
int rerank_rows(const float* q, const float* rows, int d, const int* sel,
                int sel_stride, int lmax, const int* cand_i,
                const int* cand_p, int B, int r_pad, int r, int kp,
                float* out_v, int* out_i, int* out_p, cudaStream_t stream);

}  // extern "C"
