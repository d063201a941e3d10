// Tensor-core building blocks of the attention kernels (flash_attention.cu,
// flash_decode.cu) for Hopper (sm_90a): asynchronous 16-byte copies into
// shared memory, ldmatrix fragment loads, mma.sync on bf16 and tf32
// operands, the exact splits that let those narrow operands carry float32
// values, and the quad reductions of the online softmax.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k8): lane = 4 g + t
// (g = lane / 4, t = lane % 4).  The f32 accumulator C (16 x 8) holds
// c0, c1 = C[g][2t, 2t+1] and c2, c3 = C[g+8][2t, 2t+1].
//  * bf16 m16n8k16: A (16 x 16) in four registers of two bf16 each,
//    a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, ..], a2 = A[g][2t+8, ..],
//    a3 = A[g+8][2t+8, ..]; B (16 x 8) in two, b0 = B[2t, 2t+1][g],
//    b1 = B[2t+8, 2t+9][g].  The accumulator of one product is the A
//    operand of the next (FlashAttention-2's P in registers).
//  * tf32 m16n8k8: A (16 x 8), a0 = A[g][t], a1 = A[g+8][t], a2 =
//    A[g][t+4], a3 = A[g+8][t+4]; B (8 x 8), b0 = B[t][g], b1 = B[t+4][g].
//    The contraction index may be permuted alike in A and B: reading k
//    index t as element 2t and t + 4 as 2t + 1 makes a0, a2 = c0, c1 of an
//    accumulator and lets rows be read as float2.
//
// Precision: bf16 and tf32 operands keep 8 and 11 significant bits.  A
// float32 value x is carried exactly, or nearly, as a sum of narrow terms,
// each product taken on the tensor cores in f32:
//  * split_bf16 / split3_bf16: x = hi + lo (error <= 2^-16 |x|), or hi +
//    mid + lo (exact but for underflow), each term rounded to nearest;
//  * split_tf32 (3xTF32): x = hi + lo with hi rounded to nearest at tf32's
//    10 mantissa bits and lo = x - hi, which the tensor core truncates to
//    11 bits (error <= 2^-21 |x|); a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi.
//
// Everything here is inline: the header is included by several sources
// that are linked into one library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously, around L1, the 128-byte L2
// line prefetched.  With `valid` false nothing is read (src-size 0) and
// the 16 bytes are zero-filled; `src` must still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
// Other threads see the copies only after a barrier (__syncwarp for a
// warp's own tiles, __syncthreads for a block's).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and register i receives this lane's part of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed (rows of V become B's columns).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, tf32 operands (32-bit registers, low 13 bits ignored), f32
// accumulator.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, each rounded to nearest even; x0 in
// the low half (the lower column index).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return make_float2(__uint_as_float(r << 16),
                     __uint_as_float(r & 0xffff0000u));
}

// (x0, x1) = hi + lo, two bf16x2 terms.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// (x0, x1) = t[0] + t[1] + t[2], three bf16x2 terms.
__device__ __forceinline__ void split3_bf16(float x0, float x1,
                                            uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = pack_bf16(x0, x1);
    const float2 h = unpack_bf16(t[i]);
    x0 -= h.x;
    x1 -= h.y;
  }
}

// x = hi + lo for the 3xTF32 product: hi rounded to nearest (ties away)
// at 10 mantissa bits, lo = x - hi exactly (the tensor core truncates it).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b in 3xTF32: the two small cross terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b0_lo,
                                           uint32_t b1_hi, uint32_t b1_lo) {
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

// Max and sum over the four lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One online-softmax step of a row: fold the tile's max into the running
// max m and return the factor exp(m_old - m_new) that rescales l and acc.
// The first tile of a row must hold a key it attends to (m_new finite).
__device__ __forceinline__ float online_max(float& m, float tile_max) {
  const float m_new = fmaxf(m, tile_max);
  const float alpha = expf(m - m_new);
  m = m_new;
  return alpha;
}

// Raise a kernel's dynamic shared-memory cap to what the block maximum
// leaves beside its static shared memory, once per process and device
// (`done` is the caller's static flag array), instead of a host call
// before every launch.  A refusal is returned and cleared, so that it
// does not surface at the next launch's cudaGetLastError.
constexpr int kMaxDevices = 64;
constexpr int kSmemBlockBytes = 232448;

template <typename Kernel>
inline cudaError_t opt_in_smem_once(Kernel* kernel,
                                    bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < kMaxDevices && done[dev])
    return cudaSuccess;
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBlockBytes - (int)fa.sharedSizeBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

}  // namespace attn_mma
