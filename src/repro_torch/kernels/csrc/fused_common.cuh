// Device and host pieces shared by the port's CUDA sources.
//
// warp_rows_partial / warp_rows_partial_i8 + xor_sums / transpose_sums:
//   the fixed-order row scoring of the IVF kernels (ivf_stages.cuh) that
//   the float32 re-rank (warp_row_dots, one row) reuses, so a row scores
//   the same bits in every kernel, at any batch size and with any number
//   of rows in flight; float32, bf16-rounded or int8 operands.
// The precision contract (src/repro/kernels/fused_turn.py:81-150):
//   bf16 rounds both operands to bfloat16, nearest even, and sums their
//   products (exact in f32) in float32; int8 quantises symmetrically,
//   scale = 127 / max(amax, 1e-30), q = clip(rint(x * scale), -127, 127),
//   takes the int32 dot (exact) and dequantises f32(acc) / (sq * st).
// load4 / warp_rows_partial_bf16: rows stored as bfloat16, widened to
//   float32 as they load (centroid_topk.cu, ivf_scan.cu).
//   Every step is one IEEE operation in a fixed order (no fast math), so
//   kernel and plain version (kernels/ref.py) agree bit for bit.
// launch / opt_in_once / by_precision: a launch with its error returned,
//   its kernel's dynamic shared-memory cap raised once per instance and
//   device (not per launch), and the instance of a kernel for a precision
//   code.
// merge_topk_f32 / select_probes / rerank_rows: the candidate merge, the
//   centroid stage (stage 1) and the float32 re-rank of fused_turn.cu,
//   exported with C linkage so pq_adc.cu launches the same kernels inside
//   the one library.
// launch_after: a launch, plain or as a programmatic dependent of the
//   kernel before it on the stream (fold.cuh wait_primary).
// cp_async16 / cp_async4 / cp_async_wait_all: copies from device memory
//   into shared memory that the issuing thread does not wait for until
//   cp_async_wait_all, so every copy of a batch is in flight at once
//   (fold.cuh load_lists, embedding_bag.cu bag_rows_kernel).
// mbar_* / bulk_copy: Hopper's bulk copy engine: one thread asks for a
//   whole contiguous range, its completion counted in bytes on an
//   mbarrier in shared memory (pq_adc.cu adc_scan_kernel).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <set>
#include <utility>

namespace fused_common {

constexpr int UNROLL = 8;  // float4 loads in flight per lane

// 16 bytes (both addresses 16-byte aligned) through L2 only, not L1: the
// source may be data other blocks of the launch wrote.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

// 4 bytes (both addresses 4-byte aligned), of data this launch does not
// write.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(src)
               : "memory");
}

// Waits for every copy this thread issued; a barrier then makes them
// visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier of `count` arrivals, initialised by one thread; the fence
// makes it visible to the bulk copies, the block barrier that follows it
// to the block's threads.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of bulk copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` completes; the bytes the bulk
// copies counted on it are then visible to the calling thread.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into this block's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

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

// The per-lane partial sums of R rows against nq <= NQ queries staged in
// shared memory (query t at qs4 + t * d4), by one warp, in a fixed order:
// per lane and (row, query) pair, FMAs over the float4 columns lane, lane
// + 32, ... in ascending order.  xor_sums or transpose_sums then adds the
// 32 lanes' partials in one fixed tree.  The order for a (row, query)
// pair depends on neither R, U, NQ nor nq, so it is the same bits in every
// kernel.  Each lane issues the loads of all R rows, U float4s a row,
// before the first FMA; a null row loads nothing and sums 0.  BF16 rounds
// the rows' values to bfloat16 as they load (the caller stages the
// queries rounded): products of two bf16 values are exact, so each FMA
// rounds once, as a float32 sum of them does.  All 32 lanes must call it.
template <int R, int NQ, int U, bool BF16 = false>
__device__ __forceinline__ void warp_rows_partial(
    const float4* const* rows, const float4* qs4, int d4, int nq,
    float (&acc)[R][NQ]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int t = 0; t < NQ; ++t) acc[i][t] = 0.f;
  for (int base = 0; base < d4; base += 32 * U) {
    float4 x[R][U];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = base + u * 32 + lane;
        x[i][u] = rows[i] != nullptr && c < d4
                      ? __ldg(rows[i] + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        if (BF16) x[i][u] = bf16_round4(x[i][u]);
      }
    // u outer, t inner: consecutive FMAs feed different sums, while each
    // sum still takes its columns in ascending order
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + u * 32 + lane;
      if (c < d4) {
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          if (t < nq) {
            const float4 y = qs4[t * d4 + c];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              acc[i][t] = fmaf(x[i][u].x, y.x, acc[i][t]);
              acc[i][t] = fmaf(x[i][u].y, y.y, acc[i][t]);
              acc[i][t] = fmaf(x[i][u].z, y.z, acc[i][t]);
              acc[i][t] = fmaf(x[i][u].w, y.w, acc[i][t]);
            }
          }
        }
      }
    }
  }
}

// The sums over the warp of each lane's M partials, in the xor-shuffle
// tree: the partials of lanes l and l ^ 16 are added, then those of l and
// l ^ 8, ... l ^ 1.  Every lane ends with every sum.
template <int M, typename V>
__device__ __forceinline__ void xor_sums(V (&a)[M]) {
#pragma unroll
  for (int k = 0; k < M; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a[k] += __shfl_xor_sync(0xffffffffu, a[k], o);
}

// One step of transpose_sums: the M values split between partners at
// offset O (the upper lane keeps the upper half), each kept value added
// to its partner's; M == 1 ends with a plain xor tree over offsets O ...
// 1.  Recursion on M keeps every array index a constant, so the values
// stay in registers.
template <int M, int O, typename V>
__device__ __forceinline__ V split_sums(const V (&a)[M]) {
  if constexpr (M == 1) {
    V x = a[0];
#pragma unroll
    for (int o = O; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  } else {
    const bool upper = (threadIdx.x & O) != 0;
    V h[M / 2];
#pragma unroll
    for (int i = 0; i < M / 2; ++i) {
      const V send = upper ? a[i] : a[i + M / 2];
      const V keep = upper ? a[i + M / 2] : a[i];
      h[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return split_sums<M / 2, O / 2>(h);
  }
}

// The same sums as xor_sums, in the same tree (each step adds the same two
// partials; IEEE addition commutes, so the bits are the same), with the
// M <= 32 values split between the partners at each of the first log2(M)
// steps rather than all kept: 31 shuffles for 32 values rather than 160.
// Lane l returns the sum of value l >> (5 - log2(M)).
template <int M, typename V>
__device__ __forceinline__ V transpose_sums(const V (&a)[M]) {
  static_assert(M >= 1 && M <= 32 && (M & (M - 1)) == 0, "M: 1 .. 32");
  return split_sums<M, 16>(a);
}

// Lane l's sums of the (row, query) partials acc[R][NQ] by transpose_sums:
// with R * NQ <= 32 one pass over the pairs, lane l holding pair
// l >> (5 - log2(R * NQ)) (row = pair / NQ, query = pair % NQ); with
// NQ == 32 one pass a row, lane l holding query l of row k in out[k].
// The arrays stay in registers (indexed by constants only).
template <int R, int NQ, typename V>
__device__ __forceinline__ void pair_sums(V (&acc)[R][NQ],
                                          V (&out)[R * NQ <= 32 ? 1 : R]) {
  if constexpr (R * NQ <= 32) {
    V flat[R * NQ];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int t = 0; t < NQ; ++t) flat[i * NQ + t] = acc[i][t];
    out[0] = transpose_sums<R * NQ>(flat);
  } else {
    static_assert(NQ == 32, "one pass a row takes 32 queries");
#pragma unroll
    for (int k = 0; k < R; ++k) out[k] = transpose_sums<32>(acc[k]);
  }
}

// Scores one row against nq <= NQ queries: warp_rows_partial with R = 1
// and UNROLL loads a lane in flight, then xor_sums; every lane ends with
// the scores.
template <int NQ, bool BF16 = false>
__device__ __forceinline__ void warp_row_dots(const float4* __restrict__ row,
                                              const float4* qs4, int d4,
                                              int nq, float (&out)[NQ]) {
  const float4* rows[1] = {row};
  float acc[1][NQ];
  warp_rows_partial<1, NQ, UNROLL, BF16>(rows, qs4, d4, nq, acc);
  xor_sums<NQ>(acc[0]);
#pragma unroll
  for (int t = 0; t < NQ; ++t) out[t] = acc[0][t];
}

// Values 4c .. 4c+3 of a float32 or bfloat16 row, as float32 (a bf16 value
// widens exactly: its bits are the top half of the float's).
__device__ __forceinline__ float4 load4(const float* x, int c) {
  return reinterpret_cast<const float4*>(x)[c];
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, int c) {
  const uint2 w = reinterpret_cast<const uint2*>(x)[c];
  return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
}

// warp_rows_partial for bfloat16 rows of d8 groups of 8 values, read 16
// bytes a lane and widened to float32 as they load, against nq <= NQ
// float32 queries (query t at qs4 + t * 2 * d8).  Per lane and pair, FMAs
// over the groups lane, lane + 32, ... in ascending order, the group's 8
// values in order.  A null row loads nothing.
template <int R, int NQ, int U>
__device__ __forceinline__ void warp_rows_partial_bf16(
    const uint4* const* rows, const float4* qs4, int d8, int nq,
    float (&acc)[R][NQ]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int t = 0; t < NQ; ++t) acc[i][t] = 0.f;
  for (int base = 0; base < d8; base += 32 * U) {
    uint4 x[R][U];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = base + u * 32 + lane;
        x[i][u] = rows[i] != nullptr && c < d8 ? __ldg(rows[i] + c)
                                               : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + u * 32 + lane;
      if (c < d8) {
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          if (t < nq) {
            const float4 y0 = qs4[(t * d8 + c) * 2];
            const float4 y1 = qs4[(t * d8 + c) * 2 + 1];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              acc[i][t] = fmaf(bf16_lo(x[i][u].x), y0.x, acc[i][t]);
              acc[i][t] = fmaf(bf16_hi(x[i][u].x), y0.y, acc[i][t]);
              acc[i][t] = fmaf(bf16_lo(x[i][u].y), y0.z, acc[i][t]);
              acc[i][t] = fmaf(bf16_hi(x[i][u].y), y0.w, acc[i][t]);
              acc[i][t] = fmaf(bf16_lo(x[i][u].z), y1.x, acc[i][t]);
              acc[i][t] = fmaf(bf16_hi(x[i][u].z), y1.y, acc[i][t]);
              acc[i][t] = fmaf(bf16_lo(x[i][u].w), y1.z, acc[i][t]);
              acc[i][t] = fmaf(bf16_hi(x[i][u].w), y1.w, acc[i][t]);
            }
          }
        }
      }
    }
  }
}

// The int8 form: each row's values quantised with its group's scale st[i]
// as they load, packed four to an int, and dotted with the nq <= NQ packed
// queries (query t at qi + t * d4) by __dp4a into int32 partials, whose
// sums are exact in any order.  A null row loads nothing.
template <int R, int NQ, int U>
__device__ __forceinline__ void warp_rows_partial_i8(
    const float4* const* rows, const float* st, const int* qi, int d4,
    int nq, int (&acc)[R][NQ]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int t = 0; t < NQ; ++t) acc[i][t] = 0;
  for (int base = 0; base < d4; base += 32 * U) {
    // every load of the pass issues before the first one is quantised
    float4 f[R][U];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = base + u * 32 + lane;
        f[i][u] = rows[i] != nullptr && c < d4
                      ? __ldg(rows[i] + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    int x[R][U];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) x[i][u] = pack4(f[i][u], st[i]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + u * 32 + lane;
      if (c < d4) {
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          if (t < nq) {
            const int y = qi[t * d4 + c];
#pragma unroll
            for (int i = 0; i < R; ++i)
              acc[i][t] = __dp4a(x[i][u], y, acc[i][t]);
          }
        }
      }
    }
  }
}

// The instance of a kernel template for a precision code (the launch
// modules pass only the codes of fused_turn.PRECISION_CODE).
template <typename K>
K by_precision(int precision, K f32, K bf16, K int8) {
  return precision == P_INT8 ? int8 : precision == P_BF16 ? bf16 : f32;
}

// Shared memory one block may use on this card: 227 KB of the SM's 256
// KB (tiling.SMEM_BLOCK_BYTES).
constexpr int SMEM_BLOCK_BYTES = 232448;

// Raises a kernel's dynamic shared-memory cap to all a block may use
// (SMEM_BLOCK_BYTES less its static arrays), once per kernel instance and
// device: the launches then make no cudaFuncSetAttribute call of their
// own.  Thread-safe; a failure is returned and retried next time.
inline cudaError_t opt_in_once(const void* kernel) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev})) return cudaSuccess;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BLOCK_BYTES - (int)fa.sharedSizeBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  done.insert({kernel, dev});
  return cudaSuccess;
}

// Launches a kernel with its dynamic shared memory (its cap raised once,
// opt_in_once); the launch's error.  With pdl, as a programmatic dependent
// of the kernel before it on the stream (cudaLaunchKernelEx with
// cudaLaunchAttributeProgrammaticStreamSerialization): its blocks may
// start once every block of that kernel has started or called
// fold::release_dependents, and fold::wait_primary waits for that whole
// kernel.  A refused attribute launch returns its error; it is never
// retried as a plain launch.
template <typename... Params, typename... Args>
cudaError_t launch_after(bool pdl, void (*kernel)(Params...), dim3 grid,
                         int threads, int smem, cudaStream_t st,
                         Args... args) {
  cudaError_t err = opt_in_once(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  if (!pdl) {
    kernel<<<grid, threads, smem, st>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                   int smem, cudaStream_t st, Args... args) {
  return launch_after(false, kernel, grid, threads, smem, st, args...);
}

// Lists of w_in entries one merge block takes in its first pass toward
// the best w, and lists of w in its later passes: tiling.merge_groups.
// Lists that fit one block's shared memory, except that a first pass
// whose lists grow (w_in < w, topk_tie merge_grow, room for one list of
// w) takes 2 w / w_in of them: its groups spread over blocks and each
// grows into two lists of w.
inline void merge_groups(int w_in, int w, int* g_first, int* g_later) {
  const int entries = SMEM_BLOCK_BYTES / 12;
  *g_first = w_in < w ? min((entries - w) / w_in, max(2, 2 * w / w_in))
                      : entries / w_in;
  *g_later = entries / w;
}

}  // namespace fused_common

extern "C" {

// Merges each query's n_lists sorted lists of w_in candidates (cand_*,
// laid out (B, n_lists, w_in); cand_n (B, n_lists) the real entries of
// each list, the rest read as pads, or null: all w_in are real) into its
// best w >= w_in (out_*, (B, w)) under (value desc, position asc); pads
// carry pad_id.  A block holds the lists of one group; more lists are
// merged group by group over several passes (tiling.merge_plan): in
// place in cand_* when w_in == w, else the first pass writes its groups'
// best w past the B * n_lists * w_in entries of cand_* (tiling
// merge_scratch), and the later passes merge there in place.  cand_p may
// alias cand_i; out_p may be null.
int merge_topk_f32(float* cand_v, int* cand_i, int* cand_p,
                   const int* cand_n, int B, int n_lists, int w_in, int w,
                   int pad_id, float* out_v, int* out_i, int* out_p,
                   cudaStream_t stream);

// Stage 1: scores the p centroids (p, d) against q (B, d) at `precision`
// and writes each query's tie-aware top np_pad to sel_v / sel
// (B, np_pad), through the scratch s1_* of B * ceil(p / 128) *
// min(np_pad, 128) entries: folded in the launch with counters (a zeroed
// int a query tile), else merged by merge_topk_f32 (and what it adds past
// them).  int8 scores centroid groups of blk_p rows, their largest |x| the
// index's cached c_amax (null unless int8).
int select_probes(const float* q, const float* cents, int p, int B, int d,
                  int np_pad, int precision, int blk_p, const int* c_amax,
                  float* s1_v, int* s1_i, int* counters, float* sel_v,
                  int* sel, cudaStream_t stream);

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
