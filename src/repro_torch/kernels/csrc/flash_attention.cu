// Flash attention forward for Hopper (sm_90a), float32.
//
// flash_attention_f32 replaces the Pallas kernel flash_attention of
//   src/repro/kernels/flash_attention.py:89 (body _fa_kernel :35,
//   pallas_call :111): online-softmax attention over kv tiles, GQA by
//   kv head h / (H / Hkv), q scaled by 1/sqrt(D) before the dot, causal
//   masking with q_offset = Skv - S (queries are the last S positions)
//   and masked scores set to -1e30, fully masked causal kv tiles skipped,
//   output acc / max(l, 1e-30).  The value width Dv may differ from D.
//   Unlike the Pallas kernel, S and Skv need not be tile multiples: rows
//   past S are never stored and keys past Skv take no part (score -inf,
//   weight 0), which is the reference's plain attention on those shapes.
//
// Bound on this card: operations.  At the bi-encoder's shapes (H 12,
// S = Skv = 256, D 64) a sequence does 4*H*S*Skv*D = 2.0e8 flops on
// 3.1 MB of q, k, v and output: 3.0 us at 67 TFLOP/s float32 against
// 0.94 us of bytes at 3.35 TB/s.  Tensor cores are left out on purpose:
// TF32 keeps ~3 decimal digits, outside the port's 1e-5 tolerance.
//
// What the design does about it: one 256-thread block per (batch x head,
// 64-row q tile).  The block holds its scaled q tile in shared memory and
// streams 64-key tiles of K and V through shared memory; each thread owns
// a 4 x 4 patch of the 64 x 64 score tile (4 rows, keys tx + 16 j), so a
// step of the d loop is 8 shared loads for 16 FMAs, and a row's max and
// sum reduce across the 16 lanes that share it by shuffles.  The tile's
// softmax weights go through shared memory (P) to the P.V product, where
// the thread owns the same 4 rows and value columns tx + 16 j.  Row
// strides of D + 1 and 65 floats keep the column reads off a single
// bank.  Simple first: plain f32 FMA, no TMA, no wgmma, no
// double-buffering of the kv tiles.
//
// Plain C interface (bound with ctypes): returns a cudaError_t as int, 0
// when the launch was accepted.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BKV = 64;            // keys per kv tile
constexpr int TX = 16;             // lanes sharing a row
constexpr int THREADS = 256;       // (BQ / RPT) x TX
constexpr int RPT = 4;             // rows per thread
constexpr int CPT = BKV / TX;      // score columns per thread
constexpr int MAX_DIM = 128;       // widest D and Dv
constexpr int PS = BKV + 1;        // row stride of the P tile
constexpr float MASKED = -1e30f;   // the Pallas kernel's NEG_INF

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (B * H, ceil(S / BQ)).  VPT = value columns per thread (Dv <= 16 VPT).
template <int VPT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int H, int Hkv, int S, int Skv, int D, int Dv, int causal,
                 float scale) {
  extern __shared__ float smem[];
  const int ds = D + 1;
  float* Qs = smem;                // BQ x ds, scaled
  float* Ks = Qs + BQ * ds;        // BKV x ds
  float* Vs = Ks + BKV * ds;       // BKV x Dv
  float* Ps = Vs + BKV * Dv;       // BQ x PS

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const float* qb = q + (size_t)bh * S * D;
  const float* kb = k + (size_t)kvh * Skv * D;
  const float* vb = v + (size_t)kvh * Skv * Dv;
  const int q_offset = Skv - S;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    Qs[r * ds + c] = q0 + r < S ? qb[(size_t)(q0 + r) * D + c] * scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][VPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) acc[i][j] = 0.f;
  }

  int nkv = (Skv + BKV - 1) / BKV;
  if (causal) {
    // kv tiles past the tile's last query row are fully masked: skip them
    const int q_last = q_offset + min(q0 + BQ, S) - 1;
    nkv = min(nkv, max(q_last, 0) / BKV + 1);
  }

  for (int t = 0; t < nkv; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();  // the previous tile's K, V and P are read
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, c = e - r * D;
      Ks[r * ds + c] = kv0 + r < Skv ? kb[(size_t)(kv0 + r) * D + c] : 0.f;
    }
    for (int e = tid; e < BKV * Dv; e += THREADS) {
      const int r = e / Dv, c = e - r * Dv;
      Vs[r * Dv + c] = kv0 + r < Skv ? vb[(size_t)(kv0 + r) * Dv + c] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[RPT], bk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = Qs[(ty * RPT + i) * ds + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bk[j] = Ks[(tx + TX * j) * ds + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q_offset + q0 + ty * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = kv0 + tx + TX * j;
        if (kpos >= Skv)
          s[i][j] = -INFINITY;  // past the keys: weight exactly 0
        else if (causal && qpos < kpos)
          s[i][j] = MASKED;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * RPT + i) * PS + tx + TX * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < VPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kvn = min(BKV, Skv - kv0);
    for (int c = 0; c < kvn; ++c) {
      float vv[VPT];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int col = tx + TX * j;
        vv[j] = col < Dv ? Vs[c * Dv + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty * RPT + i) * PS + c];
#pragma unroll
        for (int j = 0; j < VPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* o = out + ((size_t)bh * S + row) * Dv;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = tx + TX * j;
      if (col < Dv) o[col] = acc[i][j] / li;
    }
  }
}

template <int VPT>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int H, int Hkv, int S, int Skv, int D, int Dv, int causal,
           float scale, cudaStream_t stream) {
  const int smem =
      (BQ * (D + 1) + BKV * (D + 1) + BKV * Dv + BQ * PS) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<VPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<VPT><<<dim3(B * H, (S + BQ - 1) / BQ), THREADS, smem,
                          stream>>>(q, k, v, out, H, Hkv, S, Skv, D, Dv,
                                    causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, S, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv), out (B, H, S,
// Dv), all contiguous float32; Hkv divides H; 1 <= D, Dv <= 128; Skv >= 1.
// scale is the float32 value of 1 / sqrt(D).
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* out, int B, int H, int Hkv, int S, int Skv,
                        int D, int Dv, int causal, float scale,
                        void* stream) {
  if (B * H == 0 || S == 0) return 0;
  if (D < 1 || D > MAX_DIM || Dv < 1 || Dv > MAX_DIM || Skv < 1 ||
      Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dv <= 4 * TX)
    return launch<4>(q, k, v, out, B, H, Hkv, S, Skv, D, Dv, causal, scale,
                     st);
  return launch<8>(q, k, v, out, B, H, Hkv, S, Skv, D, Dv, causal, scale, st);
}

}  // extern "C"
