// Flash attention forward for Hopper (sm_90a), on the tensor cores.
//
// flash_attention_bf16 / flash_attention_f32 replace the Pallas kernel
//   flash_attention of src/repro/kernels/flash_attention.py:89 (body
//   _fa_kernel :35, pallas_call :111): online-softmax attention over kv
//   tiles, GQA by kv head h / (H / Hkv), causal masking with q_offset =
//   Skv - S (queries are the last S positions) and masked scores set to
//   -1e30, fully masked causal kv tiles skipped, output acc / max(l,
//   1e-30) in the inputs' dtype.  The value width Dv may differ from D.
//   Unlike the Pallas kernel, S and Skv need not be tile multiples: rows
//   past S are never stored and keys past Skv take no part (score -inf,
//   weight 0), which is the reference's plain attention on those shapes.
//
// Bound on this card: operations.  At the bi-encoder's shapes (H 12,
// S = Skv = 256, D 64) a sequence does 4*H*S*Skv*D = 2.0e8 flops on
// 3.1 MB of float32 q, k, v and output: 1.2 us at the 3xTF32 rate (495 /
// 3 TFLOP/s), 3.0 us at 67 TFLOP/s float32 FMA, against 0.94 us of bytes.
// Yi-9B's bf16 prefill (H 32 / 4, S 784, D 128) does 1.6e10 flops: 16 us
// at 989 TFLOP/s.
//
// What the design does about it (FlashAttention-2 on mma.sync):
//  * one block of NW warps (1 or 4; tiling.plan_flash_attention takes 4
//    when that still gives a block to each of the 132 SMs, so Dragon's
//    B = 1 shape runs 192 one-warp blocks, not 48) per (batch x head,
//    16 NW query rows), the heaviest causal row tiles first; each warp
//    owns 16 query rows, its Q fragments in registers for the whole row;
//  * K and V stream through a double-buffered cp.async ring of 64-key
//    tiles in dynamic shared memory (zero-filled past Skv and past the
//    head dim), the next tile in flight while this one is computed; rows
//    are padded so the fragment reads are conflict-free; causal tiles past
//    the block's (and each warp's) last query are skipped;
//  * bf16 inputs (flash_bf16_kernel): Q K^T as mma.m16n8k16 bf16 -> f32,
//    K by ldmatrix; the scale multiplies the f32 scores after the dot;
//    online softmax in registers (row max and sum over the quad); P from
//    the accumulators as the A operand, two bf16 terms (hi + lo), V by
//    ldmatrix.trans; the output in bf16;
//  * float32 inputs (flash_tf32_kernel): every product in 3xTF32 on
//    mma.m16n8k8 (a_hi b_hi + a_hi b_lo + a_lo b_hi, float32 accuracy: the
//    towers hold embeddings to 1e-5, which neither one tf32 pass nor bf16
//    does); the contraction index is permuted (k t <-> 2t, t + 4 <-> 2t +
//    1, alike in both operands) so K rows are read as float2 and P stays
//    in registers; V is read per element.
//
// Plain C interface (bound with ctypes): returns a cudaError_t as int, 0
// when the launch was accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "attn_mma.cuh"

namespace {

using namespace attn_mma;

constexpr int BKV = 64;            // keys per kv tile
constexpr int MAX_DIM = 128;       // widest D and Dv
constexpr float MASKED = -1e30f;   // the Pallas kernel's NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, Hkv, S, Skv, D, Dv, causal;
  float scale;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;  // element strides
};

// Row strides in shared memory (elements) of a head-dim bucket DB, and
// the stages of the K / V ring:
//  bf16 K and V: DB + 8 (16 bytes of pad: ldmatrix rows on distinct
//  banks); three stages (registers, not shared memory, cap the blocks an
//  SM holds);
//  f32 K: DB + 8 (== 8 mod 32: float2 reads of row g, column 2t); V:
//  DB + 4 (== 4 mod 32: reads of rows 2t, 2t + 1, column g); two stages
//  (a third would cost Dragon's shape one of its three blocks an SM).
template <typename T, int DB>
struct Layout;
template <int DB>
struct Layout<__nv_bfloat16, DB> {
  static constexpr int RSK = DB + 8, RSV = DB + 8, STAGES = 3;
};
template <int DB>
struct Layout<float, DB> {
  static constexpr int RSK = DB + 8, RSV = DB + 4, STAGES = 2;
};

// Dynamic shared memory of one block: the stages of K and V tiles.
template <typename T, int DB>
constexpr int smem_bytes() {
  using L = Layout<T, DB>;
  return L::STAGES * BKV * (L::RSK + L::RSV) * (int)sizeof(T);
}

// Start the cp.async copies of kv tile rows [kv0, kv0 + BKV) into one
// stage; rows past Skv and columns past D / Dv are zero-filled, unread.
template <typename T, int DB, int NTH>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb,
                                          const T* vb, const Args& a,
                                          int kv0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = DB / VEC;  // 16-byte chunks of a padded row
  using L = Layout<T, DB>;
#pragma unroll 4
  for (int e = threadIdx.x; e < BKV * CH; e += NTH) {
    const int r = e / CH, c = e % CH;
    const bool row = kv0 + r < a.Skv;
    const bool kok = row && c * VEC < a.D, vok = row && c * VEC < a.Dv;
    cp_async16(ks + r * L::RSK + c * VEC,
               kok ? kb + (kv0 + r) * a.kss + c * VEC : kb, kok);
    cp_async16(vs + r * L::RSV + c * VEC,
               vok ? vb + (kv0 + r) * a.vss + c * VEC : vb, vok);
  }
}

// Scale, mask and fold one 16 x 64 score tile into the running softmax of
// rows g and g + 8 (m, l per thread; l a partial over the quad), rescale
// acc, and leave p = exp(s - m) in sc.  With BASE2 the scores are kept
// times log2(e) (m too) and p = exp2(s' - m'): one multiply and ex2 per
// score instead of expf's range reduction, about 2^-22 relative apart
// (the bf16 path, whose output rounds to 2^-9).
template <bool BASE2, int NT>
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[NT][4],
                                             const Args& a, int kv0,
                                             int row0, bool mask) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int q_offset = a.Skv - a.S;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[j][e] * (BASE2 ? a.scale * 1.4426950408889634f : a.scale);
      if (mask) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        const int row = row0 + g + (e >> 1) * 8;
        if (key >= a.Skv)
          x = -INFINITY;  // past the keys: weight exactly 0
        else if (a.causal && q_offset + row < key)
          x = MASKED;
      }
      sc[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (BASE2) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    } else {
      alpha[r] = online_max(m[r], quad_max(mx[r]));
    }
  }
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = BASE2 ? exp2f(sc[j][e] - m[e >> 1])
                       : expf(sc[j][e] - m[e >> 1]);
      sum[e >> 1] += sc[j][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], sum[r]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1);
template <>
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
template <>
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x0, x1);
}

// The kernel body shared by both dtypes: tile loop, ring, softmax, output.
// Path supplies load_q (Q fragments) and tile (Q K^T, softmax_tile, P V).
template <typename T, int NW, int DB, typename Path>
__device__ __forceinline__ void attention(const Args& a) {
  constexpr int NTH = NW * 32;
  constexpr int NT = DB / 8;  // n8 tiles of the output
  using L = Layout<T, DB>;
  constexpr int STAGE = BKV * (L::RSK + L::RSV);  // elements: K, then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 16 * NW;
  const int warp = threadIdx.x >> 5;
  const int row0 = q0 + warp * 16;  // this warp's first query row
  const int q_offset = a.Skv - a.S;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  const int n_tiles = (a.Skv + BKV - 1) / BKV;
  auto tiles_to = [&](int last_row) {  // kv tiles a query row reaches
    return a.causal ? min(n_tiles, max(q_offset + last_row, 0) / BKV + 1)
                    : n_tiles;
  };
  const int nkv = tiles_to(min(q0 + 16 * NW, a.S) - 1);
  const int nkv_warp = row0 < a.S ? tiles_to(min(row0 + 16, a.S) - 1) : 0;

  constexpr int NS = L::STAGES;
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nkv)
      load_tile<T, DB, NTH>(sm + i * STAGE, sm + i * STAGE + BKV * L::RSK,
                            kb, vb, a, i * BKV);
    cp_async_commit();
  }
  typename Path::QFrag qf;
  Path::load_q(qf, qb, a, row0);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < nkv; ++it) {
    // NS == 2: tile it + 1 goes into the stage every warp left at the end
    // of tile it - 1; NS > 2: tile it + NS - 1 into the stage of tile
    // it - 1, after the barrier that shows every warp is past it
    const int nx = it + NS - 1;
    T* const next = sm + (nx % NS) * STAGE;
    if (NS == 2) {
      if (nx < nkv)
        load_tile<T, DB, NTH>(next, next + BKV * L::RSK, kb, vb, a, nx * BKV);
      cp_async_commit();
    }
    cp_async_wait<NS == 2 ? 1 : NS - 2>();
    __syncthreads();  // tile it landed for every thread
    if (NS > 2) {
      if (nx < nkv)
        load_tile<T, DB, NTH>(next, next + BKV * L::RSK, kb, vb, a, nx * BKV);
      cp_async_commit();
    }
    if (it < nkv_warp) {
      const int kv0 = it * BKV;
      const bool mask = kv0 + BKV > a.Skv ||
                        (a.causal && kv0 + BKV - 1 > q_offset + row0);
      const T* ks = sm + (it % NS) * STAGE;
      Path::tile(qf, ks, ks + BKV * L::RSK, m, l, acc, a, kv0, row0, mask);
    }
    if (NS == 2) __syncthreads();  // every warp is done with stage it % 2
  }
  cp_async_wait<0>();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  T* ob = static_cast<T*>(a.out) + (size_t)bh * a.S * a.Dv;
  const float lr[2] = {fmaxf(quad_sum(l[0]), 1e-30f),
                       fmaxf(quad_sum(l[1]), 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= a.S) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < a.Dv)
        store2(ob + (size_t)row * a.Dv + col, acc[j][2 * r] / lr[r],
               acc[j][2 * r + 1] / lr[r]);
    }
  }
}

// bf16 operands: m16n8k16, K by ldmatrix, V by ldmatrix.trans.
template <int DB>
struct Bf16Path {
  static constexpr int KS = DB / 16;  // k16 steps of Q K^T
  static constexpr int RS = Layout<__nv_bfloat16, DB>::RSK;
  struct QFrag {
    uint32_t a[KS][4];
  };

  static __device__ __forceinline__ void load_q(QFrag& qf,
                                                const __nv_bfloat16* qb,
                                                const Args& a, int row0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a0: (g, 2t) a1: (g+8, 2t) a2, a3: +8
        const int row = row0 + g + (i & 1) * 8;
        const int col = kk * 16 + 2 * t + (i >> 1) * 8;
        qf.a[kk][i] = row < a.S && col < a.D
                          ? *reinterpret_cast<const uint32_t*>(
                                qb + row * a.qss + col)
                          : 0u;
      }
    }
  }

  static __device__ __forceinline__ void tile(
      const QFrag& qf, const __nv_bfloat16* ks, const __nv_bfloat16* vs,
      float (&m)[2], float (&l)[2], float (&acc)[DB / 8][4], const Args& a,
      int kv0, int row0, bool mask) {
    const int lane = threadIdx.x & 31;
    float sc[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t b[4];  // keys +0-7 | +8-15 x columns +0 | +8
        ldmatrix_x4(b, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * RS +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf.a[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf.a[kk], b[2], b[3]);
      }
    }
    softmax_tile<true>(sc, m, l, acc, a, kv0, row0, mask);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {  // keys 16 kk .. 16 kk + 15
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dn = 0; dn < DB / 16; ++dn) {
        uint32_t b[4];  // keys +0-7 | +8-15 x columns +0 | +8, transposed
        ldmatrix_x4_trans(
            b, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RS +
                   dn * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dn], pl, b[0], b[1]);
        mma_bf16(acc[2 * dn], ph, b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], pl, b[2], b[3]);
        mma_bf16(acc[2 * dn + 1], ph, b[2], b[3]);
      }
    }
  }
};

// float32 operands: 3xTF32 on m16n8k8, contraction index permuted (k t <->
// element 2t, t + 4 <-> 2t + 1).
template <int DB>
struct Tf32Path {
  static constexpr int KS = DB / 8;  // k8 steps of Q K^T
  static constexpr int RSK = Layout<float, DB>::RSK;
  static constexpr int RSV = Layout<float, DB>::RSV;
  struct QFrag {
    float a[KS][4];  // raw f32, split per use
  };

  static __device__ __forceinline__ void load_q(QFrag& qf, const float* qb,
                                                const Args& a, int row0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int col = kk * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a[r] and a[r + 2]: row g + 8 r
        const int row = row0 + g + 8 * r;
        const float2 x = row < a.S && col < a.D
                             ? *reinterpret_cast<const float2*>(
                                   qb + row * a.qss + col)
                             : make_float2(0.f, 0.f);
        qf.a[kk][r] = x.x;
        qf.a[kk][r + 2] = x.y;
      }
    }
  }

  static __device__ __forceinline__ void tile(
      const QFrag& qf, const float* ks, const float* vs, float (&m)[2],
      float (&l)[2], float (&acc)[DB / 8][4], const Args& a, int kv0,
      int row0, bool mask) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float sc[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(qf.a[kk][i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {  // keys 8 j + g, columns 2t, 2t+1
        const float2 kx = *reinterpret_cast<const float2*>(
            ks + (j * 8 + g) * RSK + kk * 8 + 2 * t);
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(kx.x, b0h, b0l);
        split_tf32(kx.y, b1h, b1l);
        mma_3xtf32(sc[j], ah, al, b0h, b0l, b1h, b1l);
      }
    }
    softmax_tile<false>(sc, m, l, acc, a, kv0, row0, mask);
#pragma unroll
    for (int kk = 0; kk < BKV / 8; ++kk) {  // keys 8 kk + 2t, 8 kk + 2t + 1
      uint32_t ph[4], pl[4];  // a0, a1, a2, a3 = c0, c2, c1, c3
      split_tf32(sc[kk][0], ph[0], pl[0]);
      split_tf32(sc[kk][2], ph[1], pl[1]);
      split_tf32(sc[kk][1], ph[2], pl[2]);
      split_tf32(sc[kk][3], ph[3], pl[3]);
      const float* v0 = vs + (kk * 8 + 2 * t) * RSV + g;
#pragma unroll
      for (int j = 0; j < DB / 8; ++j) {
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(v0[j * 8], b0h, b0l);
        split_tf32(v0[RSV + j * 8], b1h, b1l);
        mma_3xtf32(acc[j], ph, pl, b0h, b0l, b1h, b1l);
      }
    }
  }
};

template <int NW, int DB>
__global__ void __launch_bounds__(NW * 32)
flash_bf16_kernel(const Args a) {
  attention<__nv_bfloat16, NW, DB, Bf16Path<DB>>(a);
}

template <int NW, int DB>
__global__ void __launch_bounds__(NW * 32)
flash_tf32_kernel(const Args a) {
  attention<float, NW, DB, Tf32Path<DB>>(a);
}

template <typename T, int NW, int DB>
int launch(const Args& a, int B, cudaStream_t st) {
  static bool opted[kMaxDevices];
  const dim3 grid(B * a.H, (a.S + 16 * NW - 1) / (16 * NW));
  constexpr int smem = smem_bytes<T, DB>();
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    err = opt_in_smem_once(flash_tf32_kernel<NW, DB>, opted);
    if (err == cudaSuccess)
      flash_tf32_kernel<NW, DB><<<grid, NW * 32, smem, st>>>(a);
  } else {
    err = opt_in_smem_once(flash_bf16_kernel<NW, DB>, opted);
    if (err == cudaSuccess)
      flash_bf16_kernel<NW, DB><<<grid, NW * 32, smem, st>>>(a);
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Hkv, int S, int Skv, int D, int Dv, int causal,
             float scale, int warps, const long long* st, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (B * H == 0 || S == 0) return 0;
  if (D < 1 || D > MAX_DIM || Dv < 1 || Dv > MAX_DIM || D % VEC ||
      Dv % VEC || Skv < 1 || Hkv < 1 || H % Hkv != 0 ||
      (warps != 1 && warps != 4))
    return (int)cudaErrorInvalidValue;
  const Args a{q,     k,     v,     out,   H,     Hkv,   S,
               Skv,   D,     Dv,    causal, scale, st[0], st[1],
               st[2], st[3], st[4], st[5], st[6], st[7], st[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = D > 64 || Dv > 64;
  if (warps == 4)
    return wide ? launch<T, 4, 128>(a, B, s) : launch<T, 4, 64>(a, B, s);
  return wide ? launch<T, 1, 128>(a, B, s) : launch<T, 1, 64>(a, B, s);
}

}  // namespace

extern "C" {

// q (B, H, S, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv) bfloat16 with
// element strides strides[0..8] = (batch, head, row) of q, k and v (the
// last dim contiguous, rows 16-byte aligned); out (B, H, S, Dv) bfloat16
// contiguous.  Hkv divides H; D, Dv multiples of 8, at most 128; Skv >= 1;
// warps 1 or 4 (query rows of a block: 16 x warps).  scale is the float32
// value of 1 / sqrt(D).
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int Hkv, int S, int Skv,
                         int D, int Dv, int causal, float scale, int warps,
                         const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, B, H, Hkv, S, Skv, D, Dv,
                                 causal, scale, warps, strides, stream);
}

// As flash_attention_bf16 in float32; D and Dv multiples of 4.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Hkv, int S, int Skv,
                        int D, int Dv, int causal, float scale, int warps,
                        const long long* strides, void* stream) {
  return dispatch<float>(q, k, v, out, B, H, Hkv, S, Skv, D, Dv, causal,
                         scale, warps, strides, stream);
}

}  // extern "C"
