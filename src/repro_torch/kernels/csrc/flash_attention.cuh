// The flash attention forward kernels of flash_attention.cu, shared with
// flash_attention_wide.cu: the layout, the tile loop, the bf16 and 3xTF32
// paths, the kernel templates and their launch.  flash_attention.cu
// (design notes there) instantiates the narrow buckets (D, Dv <= 128) and
// holds the C entries; flash_attention_wide.cu the wide ones, which are
// compiled apart so that the two build in parallel.
//
// Everything here is a template or inline: the header is included by
// both sources, which are linked into one library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "attn_mma.cuh"

namespace flash_attention {

using namespace attn_mma;

constexpr int BKV = 64;            // keys per kv tile
constexpr int NARROW_DIM = 128;    // widest D and Dv of the narrow instances
constexpr int MAX_DIM = 256;       // widest D and Dv
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

// Row strides in shared memory (elements) of the buckets DK, DV:
//  bf16 K, V and Q: width + 8 (16 bytes of pad: ldmatrix rows on distinct
//  banks);
//  f32 K and Q: DK + 8 (== 8 mod 32: float2 reads of row g, column 2t);
//  V: DV + 4 (== 4 mod 32: reads of rows 2t, 2t + 1, column g).
template <typename T, int DK, int DV>
struct Rows;
template <int DK, int DV>
struct Rows<__nv_bfloat16, DK, DV> {
  static constexpr int RSK = DK + 8, RSV = DV + 8, RSQ = DK + 8;
};
template <int DK, int DV>
struct Rows<float, DK, DV> {
  static constexpr int RSK = DK + 8, RSV = DV + 4, RSQ = DK + 8;
};

// An instance past the narrow buckets: Q staged in shared memory.
template <int DK, int DV>
constexpr bool kWide = DK > NARROW_DIM || DV > NARROW_DIM;

// The shared memory of one block of NW warps: the stages of K and V
// tiles, then (wide instances) the block's query rows.
template <typename T, int NW, int DK, int DV>
struct Layout : Rows<T, DK, DV> {
  using R = Rows<T, DK, DV>;
  static constexpr bool WIDE = kWide<DK, DV>;
  static constexpr int STAGE = BKV * (R::RSK + R::RSV);  // elements
  static constexpr int QROWS = WIDE ? 16 * NW * R::RSQ : 0;  // elements
  // narrow: bf16 three stages (registers, not shared memory, cap the
  // blocks an SM holds), f32 two (a third would cost Dragon's shape one
  // of its three blocks an SM); wide: two, or one where two do not fit
  static constexpr int STAGES =
      !WIDE ? (std::is_same_v<T, float> ? 2 : 3)
      : (2 * STAGE + QROWS) * (int)sizeof(T) <= kSmemBlockBytes ? 2
                                                                 : 1;
  static constexpr int SMEM = (STAGES * STAGE + QROWS) * (int)sizeof(T);
  static_assert(SMEM <= kSmemBlockBytes, "a block's shared memory");
};

// Start the cp.async copies of kv tile rows [kv0, kv0 + BKV) into one
// stage; rows past Skv and columns past D / Dv are zero-filled, unread.
template <typename T, int DK, int DV, int NTH>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb,
                                          const T* vb, const Args& a,
                                          int kv0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHK = DK / VEC, CHV = DV / VEC;  // 16-byte chunks of a row
  constexpr int CH = CHK > CHV ? CHK : CHV;
  using R = Rows<T, DK, DV>;
#pragma unroll 4
  for (int e = threadIdx.x; e < BKV * CH; e += NTH) {
    const int r = e / CH, c = e % CH;
    const bool row = kv0 + r < a.Skv;
    if (CHK == CH || c < CHK) {
      const bool kok = row && c * VEC < a.D;
      cp_async16(ks + r * R::RSK + c * VEC,
                 kok ? kb + (kv0 + r) * a.kss + c * VEC : kb, kok);
    }
    if (CHV == CH || c < CHV) {
      const bool vok = row && c * VEC < a.Dv;
      cp_async16(vs + r * R::RSV + c * VEC,
                 vok ? vb + (kv0 + r) * a.vss + c * VEC : vb, vok);
    }
  }
}

// Start the cp.async copies of the block's query rows [q0, q0 + 16 NW)
// into shared memory (wide instances); rows past S and columns past D
// are zero-filled, unread.
template <typename T, int DK, int NTH, int RSQ>
__device__ __forceinline__ void load_q_rows(T* qs, const T* qb,
                                            const Args& a, int q0,
                                            int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = DK / VEC;
  for (int e = threadIdx.x; e < rows * CH; e += NTH) {
    const int r = e / CH, c = e % CH;
    const bool ok = q0 + r < a.S && c * VEC < a.D;
    cp_async16(qs + r * RSQ + c * VEC,
               ok ? qb + (q0 + r) * a.qss + c * VEC : qb, ok);
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
// Path supplies the Q fragments (load_q: registers, or the warp's rows in
// shared memory) and tile (Q K^T, softmax_tile, P V).
template <typename T, int NW, int DK, int DV, typename Path>
__device__ __forceinline__ void attention(const Args& a) {
  constexpr int NTH = NW * 32;
  constexpr int NT = DV / 8;  // n8 tiles of the output
  using L = Layout<T, NW, DK, DV>;
  constexpr int STAGE = L::STAGE;  // elements: K, then V
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
  T* const qs = sm + NS * STAGE;  // wide: the block's query rows
  if constexpr (L::WIDE)  // landed with the first tile's group
    load_q_rows<T, DK, NTH, L::RSQ>(qs, qb, a, q0, 16 * NW);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nkv)
      load_tile<T, DK, DV, NTH>(sm + i * STAGE, sm + i * STAGE + BKV * L::RSK,
                                kb, vb, a, i * BKV);
    cp_async_commit();
  }
  typename Path::QFrag qf;
  Path::load_q(qf, qb, qs + warp * 16 * L::RSQ, a, row0);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < nkv; ++it) {
    // NS == 1: tile it into the one stage, every warp done with tile it -
    // 1; NS == 2: tile it + 1 goes into the stage every warp left at the
    // end of tile it - 1; NS > 2: tile it + NS - 1 into the stage of tile
    // it - 1, after the barrier that shows every warp is past it
    const int nx = it + NS - 1;
    T* const next = sm + (nx % NS) * STAGE;
    if (NS <= 2) {
      if (nx < nkv)
        load_tile<T, DK, DV, NTH>(next, next + BKV * L::RSK, kb, vb, a,
                                  nx * BKV);
      cp_async_commit();
    }
    cp_async_wait<NS == 1 ? 0 : NS == 2 ? 1 : NS - 2>();
    __syncthreads();  // tile it landed for every thread
    if (NS > 2) {
      if (nx < nkv)
        load_tile<T, DK, DV, NTH>(next, next + BKV * L::RSK, kb, vb, a,
                                  nx * BKV);
      cp_async_commit();
    }
    if (it < nkv_warp) {
      const int kv0 = it * BKV;
      const bool mask = kv0 + BKV > a.Skv ||
                        (a.causal && kv0 + BKV - 1 > q_offset + row0);
      const T* ks = sm + (it % NS) * STAGE;
      Path::tile(qf, ks, ks + BKV * L::RSK, m, l, acc, a, kv0, row0, mask);
    }
    if (NS <= 2) __syncthreads();  // every warp is done with stage it % NS
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

// bf16 operands: m16n8k16, K by ldmatrix, V by ldmatrix.trans; Q in
// registers (QSM false) or by ldmatrix from the warp's rows in shared
// memory (QSM true).
template <int DK, int DV, bool QSM>
struct Bf16Path {
  static constexpr int KS = DK / 16;  // k16 steps of Q K^T
  static constexpr int RSK = Rows<__nv_bfloat16, DK, DV>::RSK;
  static constexpr int RSV = Rows<__nv_bfloat16, DK, DV>::RSV;
  static constexpr int RSQ = Rows<__nv_bfloat16, DK, DV>::RSQ;
  struct QRegs {
    uint32_t a[KS][4];
  };
  struct QRows {
    const __nv_bfloat16* q;  // the warp's 16 rows, RSQ apart
  };
  using QFrag = std::conditional_t<QSM, QRows, QRegs>;

  static __device__ __forceinline__ void load_q(QFrag& qf,
                                                const __nv_bfloat16* qb,
                                                const __nv_bfloat16* qs,
                                                const Args& a, int row0) {
    if constexpr (QSM) {
      qf.q = qs;
    } else {
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
  }

  // The A fragment of k step kk: rows 0-15 by lanes 0-15 at column
  // 16 kk, the same rows by lanes 16-31 at 16 kk + 8.
  static __device__ __forceinline__ void q_frag(uint32_t (&r)[4],
                                                const QFrag& qf, int kk) {
    if constexpr (QSM) {
      const int lane = threadIdx.x & 31;
      ldmatrix_x4(r, qf.q + (lane & 15) * RSQ + kk * 16 + (lane >> 4) * 8);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = qf.a[kk][i];
    }
  }

  static __device__ __forceinline__ void tile(
      const QFrag& qf, const __nv_bfloat16* ks, const __nv_bfloat16* vs,
      float (&m)[2], float (&l)[2], float (&acc)[DV / 8][4], const Args& a,
      int kv0, int row0, bool mask) {
    const int lane = threadIdx.x & 31;
    float sc[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      q_frag(qa, qf, kk);
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t b[4];  // keys +0-7 | +8-15 x columns +0 | +8
        ldmatrix_x4(b, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * RSK +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qa, b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa, b[2], b[3]);
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
      for (int dn = 0; dn < DV / 16; ++dn) {
        uint32_t b[4];  // keys +0-7 | +8-15 x columns +0 | +8, transposed
        ldmatrix_x4_trans(
            b, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RSV +
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
// element 2t, t + 4 <-> 2t + 1); Q raw in registers (QSM false) or read
// as float2 from the warp's rows in shared memory (QSM true), split per
// use either way.
template <int DK, int DV, bool QSM>
struct Tf32Path {
  static constexpr int KS = DK / 8;  // k8 steps of Q K^T
  static constexpr int RSK = Rows<float, DK, DV>::RSK;
  static constexpr int RSV = Rows<float, DK, DV>::RSV;
  static constexpr int RSQ = Rows<float, DK, DV>::RSQ;
  struct QRegs {
    float a[KS][4];  // raw f32, split per use
  };
  struct QRows {
    const float* q;  // the warp's 16 rows, RSQ apart
  };
  using QFrag = std::conditional_t<QSM, QRows, QRegs>;

  static __device__ __forceinline__ void load_q(QFrag& qf, const float* qb,
                                                const float* qs,
                                                const Args& a, int row0) {
    if constexpr (QSM) {
      qf.q = qs;
    } else {
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
  }

  // The raw A fragment of k step kk: rows g and g + 8, columns 8 kk + 2t
  // and 8 kk + 2t + 1.
  static __device__ __forceinline__ void q_frag(float (&r)[4],
                                                const QFrag& qf, int kk) {
    if constexpr (QSM) {
      const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 x = *reinterpret_cast<const float2*>(
            qf.q + (g + 8 * i) * RSQ + kk * 8 + 2 * t);
        r[i] = x.x;
        r[i + 2] = x.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = qf.a[kk][i];
    }
  }

  static __device__ __forceinline__ void tile(
      const QFrag& qf, const float* ks, const float* vs, float (&m)[2],
      float (&l)[2], float (&acc)[DV / 8][4], const Args& a, int kv0,
      int row0, bool mask) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float sc[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float qa[4];
      q_frag(qa, qf, kk);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(qa[i], ah[i], al[i]);
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
      for (int j = 0; j < DV / 8; ++j) {
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(v0[j * 8], b0h, b0l);
        split_tf32(v0[RSV + j * 8], b1h, b1l);
        mma_3xtf32(acc[j], ph, pl, b0h, b0l, b1h, b1l);
      }
    }
  }
};

template <int NW, int DK, int DV>
__global__ void __launch_bounds__(NW * 32)
flash_bf16_kernel(const Args a) {
  attention<__nv_bfloat16, NW, DK, DV, Bf16Path<DK, DV, kWide<DK, DV>>>(a);
}

template <int NW, int DK, int DV>
__global__ void __launch_bounds__(NW * 32)
flash_tf32_kernel(const Args a) {
  attention<float, NW, DK, DV, Tf32Path<DK, DV, kWide<DK, DV>>>(a);
}

template <typename T, int NW, int DK, int DV>
int launch(const Args& a, int B, cudaStream_t st) {
  static bool opted[kMaxDevices];
  const dim3 grid(B * a.H, (a.S + 16 * NW - 1) / (16 * NW));
  constexpr int smem = Layout<T, NW, DK, DV>::SMEM;
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    err = opt_in_smem_once(flash_tf32_kernel<NW, DK, DV>, opted);
    if (err == cudaSuccess)
      flash_tf32_kernel<NW, DK, DV><<<grid, NW * 32, smem, st>>>(a);
  } else {
    err = opt_in_smem_once(flash_bf16_kernel<NW, DK, DV>, opted);
    if (err == cudaSuccess)
      flash_bf16_kernel<NW, DK, DV><<<grid, NW * 32, smem, st>>>(a);
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The wide instances (D or Dv > 128; 4-warp blocks), in
// flash_attention_wide.cu: keys 128 / 192 / 256 and values 128 / 256
// bucketed apart.
int launch_wide_bf16(const Args& a, int B, cudaStream_t s);
int launch_wide_f32(const Args& a, int B, cudaStream_t s);

}  // namespace flash_attention
