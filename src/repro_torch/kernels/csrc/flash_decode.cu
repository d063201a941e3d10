// Decode attention (one new token against a KV cache) for Hopper (sm_90a).
//
// flash_decode_bf16 / flash_decode_f32 replace the Pallas kernel
// flash_decode of src/repro/kernels/flash_attention.py:180 (body
// _decode_kernel :141, pallas_call :201): for each batch row b and head h,
// softmax(q[b,h] k[b,h/group,:len]^T / sqrt(D)) v[b,h/group,:len] with
// len = min(cache_len[b], S), in float32 math over a bfloat16 or float32
// cache read in its own type.
//
// Bound on this card: device-memory bytes.  A step reads each kv head's
// first len rows of K and V once (at B = 8, 4 kv heads, D = 128, len =
// 32,768 in bf16: 537 MB, 160 us at 3.35 TB/s) and does 4 FLOP per cache
// element per query of the group (8 for Yi-9B): 2 FLOP/B, far below the
// ridge.  Rows at or past len are never read.
//
// flash_decode_bf16 (the served path: Yi-9B's cache is bf16) is
// decode_mma_kernel, one launch a call:
//  * S is cut into splits of `chunk` rows (tiling.decode_split: 64 to 512
//    rows, a function of S alone), one 4-warp block per (split, b x kv
//    head); warp w streams rows 16 j .. 16 j + 15 of the chunk for j = w,
//    w + 4, ..., each 16-row K and V sub-tile through its own 3-stage
//    cp.async ring in dynamic shared memory (the block's stage is a
//    64-row tile, 17 KB of K and 17 KB of V at D = 128), so K and V of a
//    tile arrive together, the chunk is streamed once, and only __syncwarp
//    orders a warp's ring;
//  * Q K^T on the tensor cores, mma.m16n8k16 bf16 -> f32: A is a 16-row Q
//    tile (the group's <= 8 queries, then zero rows; a byte-bound kernel
//    loses nothing to the idle half), B is K by ldmatrix from rows padded
//    by 16 bytes (conflict-free).  A bf16 q is one term; a float32 q is
//    split into three bf16 terms (exact), three products.  1/sqrt(D)
//    multiplies the f32 scores after the dot, so the operands stay exact;
//  * online softmax in registers: a row's max and sum over its quad by two
//    shuffles each;
//  * P V on the tensor cores: P is taken from the score accumulators in
//    registers as the A operand, split into two bf16 terms (hi + lo, error
//    <= 2^-16 p; one bf16 term would not hold the f32 gate), V is B by
//    ldmatrix.trans;
//  * the block folds its four warps' (m, l, acc) in warp order and writes
//    the split's slot; a per-(b, kv head) arrival counter tells the last
//    block of the row to arrive, which folds the splits in split order
//    (so the bits depend neither on B nor on the order of arrival), writes
//    the output (bf16 for a bf16 q, else f32) and resets its counter to 0.
//    A row of one split writes its output directly, with the same bits.
//    The counter buffer is the caller's: zeroed, and not shared by calls
//    that may run at once (flash_decode.py keeps one per device and
//    stream).
//
// flash_decode_f32 (a float32 cache, which no served path runs) keeps the
// first design: f32 FMA on CUDA cores, `lpr` lanes sharing a cache row
// and reducing its dot by xor shuffles, K and V read in two passes over
// the chunk (phase A scores into shared memory, phase B one warp per query
// for the softmax, phase C P V), and a second kernel folding the splits
// in split order.
//
// Plain C interface (bound with ctypes): every entry returns a cudaError_t
// as int, 0 when every launch was accepted.  cache_len[b] < 1 gives NaN
// rows (a softmax over no position), as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "attn_mma.cuh"

namespace {

using attn_mma::cp_async16;

constexpr int THREADS = 256;   // 8 warps (f32 cache)
constexpr int MAX_DIM = 128;
constexpr int MAX_GROUP = 8;   // one warp per query of the group in phase B;
                               // the query rows of the mma tile
constexpr int MAX_CHUNK = 512;
constexpr int UNROLL = 4;      // rows a lane group has in flight

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

// ---------------------------------------------------------------------------
// float32 cache: split and combine kernels
// ---------------------------------------------------------------------------

// grid (nsplit, B * Hkv).  Block (s, bh) attends the group's queries to
// rows [s*chunk, min((s+1)*chunk, len)) of kv head bh and writes its
// (m, l, acc) per query to the split's slot, in three phases:
//  A  scores: lpr lanes (a power of two >= D / 4) share a row, UNROLL
//     rows in flight; the row's dot per query goes to p_s;
//  B  one warp per query: the chunk's max m, p = exp(s - m) in place,
//     l = sum p;
//  C  P V: the same lanes stream V rows, acc[g][:] += p[g][r] v[r][:],
//     then the warps' row groups fold by shuffle and the warps in order.
template <int G>
__global__ void __launch_bounds__(THREADS, 2)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ cache_len,
                    int hkv, int group, int S, int D, int lpr, int chunk,
                    int nsplit, float scale, float* __restrict__ part_m,
                    float* __restrict__ part_l,
                    float* __restrict__ part_acc) {
  constexpr int VEC = 4;
  __shared__ float p_s[MAX_GROUP][MAX_CHUNK];
  __shared__ float m_s[MAX_GROUP], l_s[MAX_GROUP];
  extern __shared__ float fold[];  // (warps, G, D)
  const int bh = blockIdx.y;
  const int len = min(cache_len[bh / hkv], S);
  const int start = blockIdx.x * chunk;
  const int n = min(chunk, len - start);  // block-uniform
  const size_t slot = (size_t)bh * nsplit + blockIdx.x;
  if (n <= 0) return;  // past len: the combine reads no slot of this split
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_rg = THREADS / lpr;            // row groups of the block
  const int rg = threadIdx.x / lpr;
  const int col = (lane % lpr) * VEC;        // this lane's first column
  const bool active = col < D;
  const float* k0 = k + ((size_t)bh * S + start) * D + col;
  const float* v0 = v + ((size_t)bh * S + start) * D + col;

  // A: scores
  {
    float qf[G][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < group && active)
          f = __ldg(reinterpret_cast<const float4*>(
              q + ((size_t)bh * group + g) * D + col + e));
        qf[g][e] = f.x * scale;
        qf[g][e + 1] = f.y * scale;
        qf[g][e + 2] = f.z * scale;
        qf[g][e + 3] = f.w * scale;
      }
    }
    for (int base = 0; base < n; base += n_rg * UNROLL) {
      float kx[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = base + u * n_rg + rg;
        if (r < n && active) {
          load16(k0 + (size_t)r * D, kx[u]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kx[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = base + u * n_rg + rg;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) t = fmaf(qf[g][e], kx[u][e], t);
          for (int o = lpr >> 1; o > 0; o >>= 1)
            t += __shfl_xor_sync(0xffffffffu, t, o);
          if (g < group && r < n && lane % lpr == 0) p_s[g][r] = t;
        }
      }
    }
  }
  __syncthreads();

  // B: softmax over the chunk, one warp per query, in a fixed order
  if (warp < group) {
    float mx = -INFINITY;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, p_s[warp][r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(p_s[warp][r] - mx);
      p_s[warp][r] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      m_s[warp] = mx;
      l_s[warp] = sum;
    }
  }
  __syncthreads();

  // C: P V
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }
  for (int base = 0; base < n; base += n_rg * UNROLL) {
    float vx[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * n_rg + rg;
      if (r < n && active) {
        load16(v0 + (size_t)r * D, vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vx[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * n_rg + rg;
      if (r < n) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = g < group ? p_s[g][r] : 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vx[u][e], acc[g][e]);
        }
      }
    }
  }
  // fold the warp's row groups (lanes lpr apart), then the warps in order
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      for (int o = lpr; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
  if (lane < lpr && active) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        fold[((size_t)warp * G + g) * D + col + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < group * D; t += THREADS) {
    const int g = t / D;
    const int d = t % D;
    float a = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) a += fold[((size_t)w * G + g) * D + d];
    part_acc[(slot * group + g) * D + d] = a;
    if (d == 0) {
      part_m[slot * group + g] = m_s[g];
      part_l[slot * group + g] = l_s[g];
    }
  }
}

// grid (B * Hkv), max(group * D, 32 * group) threads.  Folds the splits
// of (b, kv head) that hold rows, in split order: warp g takes query g's
// max m over the splits, the weights exp(m_i - m) (into shared memory,
// group x nsplit floats) and l = sum l_i w_i; then one thread per (g, d)
// sums acc_i[g][d] w_i and writes out (B*Hkv*group, D) = acc / l.
__global__ void __launch_bounds__(MAX_GROUP * MAX_DIM)
decode_combine_kernel(const int* __restrict__ cache_len, int hkv, int group,
                      int S, int D, int chunk, int nsplit,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      float* __restrict__ out) {
  extern __shared__ float w_s[];  // (group, nsplit)
  __shared__ float l_s[MAX_GROUP];
  const int bh = blockIdx.x;
  const int len = min(cache_len[bh / hkv], S);
  const int n = len > 0 ? (len + chunk - 1) / chunk : 0;
  const size_t slot0 = (size_t)bh * nsplit;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < group) {
    float mx = -INFINITY;
    for (int i = lane; i < n; i += 32)
      mx = fmaxf(mx, part_m[(slot0 + i) * group + warp]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float w = expf(part_m[(slot0 + i) * group + warp] - mx);
      w_s[warp * nsplit + i] = w;
      l = fmaf(part_l[(slot0 + i) * group + warp], w, l);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) l_s[warp] = l;
  }
  __syncthreads();
  const int g = threadIdx.x / D;
  const int d = threadIdx.x % D;
  if (g < group) {
    const float* src = part_acc + (slot0 * group + g) * D + d;
    const size_t step = (size_t)group * D;
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) a = fmaf(src[i * step], w_s[g * nsplit + i], a);
    out[((size_t)bh * group + g) * D + d] = a / l_s[g];  // NaN when n == 0
  }
}


template <int G>
int launch_f32(const float* q, const float* k, const float* v,
               const int* cache_len, int B, int H, int hkv, int S, int D,
               int chunk, int nsplit, float scale, float* part_m,
               float* part_l, float* part_acc, float* out, cudaStream_t st) {
  static bool opted[attn_mma::kMaxDevices];
  static bool opted_combine[attn_mma::kMaxDevices];
  const int group = H / hkv;
  int lpr = 1;
  while (lpr < D / 4) lpr <<= 1;
  const int smem = THREADS / 32 * G * D * (int)sizeof(float);
  cudaError_t err = attn_mma::opt_in_smem_once(
      decode_split_kernel<G>, opted);
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<G><<<dim3(nsplit, B * hkv), THREADS, smem, st>>>(
      q, k, v, cache_len, hkv, group, S, D, lpr, chunk, nsplit, scale,
      part_m, part_l, part_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = (max(group * D, 32 * group) + 31) / 32 * 32;
  const int wsmem = group * nsplit * (int)sizeof(float);
  err = attn_mma::opt_in_smem_once(
      decode_combine_kernel, opted_combine);
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<B * hkv, threads, wsmem, st>>>(
      cache_len, hkv, group, S, D, chunk, nsplit, part_m, part_l, part_acc,
      out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 cache: decode_mma_kernel
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int STAGES = 3;      // ring depth of each warp's sub-tiles
constexpr int SUB = 16;        // rows of a sub-tile: one k16 step of P V
constexpr int FOLD_HEAD = 32;  // floats before the fold arrays: M[8], L[8],
                               // the arrival flag

// Dynamic shared memory of decode_mma_kernel<KS> (tiling.plan_flash_decode
// computes the same): the ring, or the fold arrays after it, the larger.
__host__ __device__ constexpr int ring_bytes(int ks) {
  return STAGES * MMA_WARPS * 2 * SUB * (ks * 16 + 8) * 2;
}

int mma_smem(int ks, int group, int nsplit) {
  const int warps = FOLD_HEAD + 3 * MMA_WARPS * MAX_GROUP +
                    MMA_WARPS * MAX_GROUP * ks * 16;
  const int splits = FOLD_HEAD + group * nsplit;
  return max(ring_bytes(ks), 4 * max(warps, splits));
}

// Four consecutive outputs from index i (a multiple of 4).
template <bool OUT_BF16>
__device__ __forceinline__ void store_out4(void* out, size_t i, float4 x) {
  if (OUT_BF16)
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) =
        make_uint2(attn_mma::pack_bf16(x.x, x.y),
                   attn_mma::pack_bf16(x.z, x.w));
  else
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = x;
}

__device__ __forceinline__ float4 fma4(float4 x, float w, float4 a) {
  return make_float4(fmaf(x.x, w, a.x), fmaf(x.y, w, a.y),
                     fmaf(x.z, w, a.z), fmaf(x.w, w, a.w));
}

__device__ __forceinline__ float4 div4(float4 x, float l) {
  return make_float4(x.x / l, x.y / l, x.z / l, x.w / l);
}

// grid (nsplit, B * Hkv), MMA_THREADS threads.  KS k16 steps cover the
// head dim (D <= 16 KS, zero-filled past D); NQ bf16 terms carry q (1: a
// bf16 q, 3: a float32 q); the output is bf16 when q is.
template <int KS, int NQ>
__global__ void __launch_bounds__(MMA_THREADS, 2)
decode_mma_kernel(const void* __restrict__ qv,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ cache_len, int hkv, int group,
                  int S, int D, int chunk, int nsplit, float scale,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, int* __restrict__ counter,
                  void* __restrict__ out) {
  using namespace attn_mma;
  constexpr int DP = KS * 16;      // padded head dim
  constexpr int RS = DP + 8;       // smem row stride (bf16): +16 bytes
  constexpr int NT = DP / 8;       // n8 tiles of the output
  constexpr int CH = DP / 8;       // 16-byte chunks of a padded row
  constexpr bool OUT_BF16 = NQ == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* fs = reinterpret_cast<float*>(smem_raw);

  const int bh = blockIdx.y;
  const int len = min(cache_len[bh / hkv], S);
  const int start = blockIdx.x * chunk;
  const int n = min(chunk, len - start);  // block-uniform
  if (n <= 0) return;  // past len: the fold reads no slot of this split
  const int n_active = (len + chunk - 1) / chunk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t row0 = (size_t)bh * S + start;
  const __nv_bfloat16* kb = k + row0 * D;
  const __nv_bfloat16* vb = v + row0 * D;

  // this warp's sub-tiles: rows SUB j .. of the chunk, j = warp + 4 i
  const int n_sub = (n + SUB - 1) / SUB;
  const int cnt = n_sub > warp ? (n_sub - warp + MMA_WARPS - 1) / MMA_WARPS
                               : 0;
  auto slot = [&](int stage, int kv) {
    return ring + ((stage * MMA_WARPS + warp) * 2 + kv) * SUB * RS;
  };
  auto load = [&](int i) {
    const int r0 = (warp + i * MMA_WARPS) * SUB;
    __nv_bfloat16* ks = slot(i % STAGES, 0);
    __nv_bfloat16* vs = slot(i % STAGES, 1);
#pragma unroll
    for (int e = lane; e < SUB * CH; e += 32) {
      const int r = e / CH, c = e % CH;
      const bool ok = r0 + r < n && c * 8 < D;
      const size_t off = ok ? (size_t)(r0 + r) * D + c * 8 : 0;
      cp_async16(ks + r * RS + c * 8, kb + off, ok);
      cp_async16(vs + r * RS + c * 8, vb + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < cnt) load(i);
    cp_async_commit();
  }

  // Q fragments (rows g < group; rows g + 8 of the tile are zero): per k16
  // step the columns 2t, 2t+1 and 2t+8, 2t+9, as NQ bf16 terms
  uint32_t qa[NQ][KS][2];
  {
    const size_t qrow = ((size_t)bh * group + g) * D;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = kk * 16 + half * 8 + 2 * t;
        const bool ok = g < group && col < D;
        if (NQ == 1) {
          qa[0][kk][half] =
              ok ? *reinterpret_cast<const uint32_t*>(
                       static_cast<const __nv_bfloat16*>(qv) + qrow + col)
                 : 0u;
        } else {
          const float2 x =
              ok ? *reinterpret_cast<const float2*>(
                       static_cast<const float*>(qv) + qrow + col)
                 : make_float2(0.f, 0.f);
          uint32_t terms[3];
          split3_bf16(x.x, x.y, terms);
#pragma unroll
          for (int qi = 0; qi < NQ; ++qi) qa[qi][kk][half] = terms[qi];
        }
      }
    }
  }

  float m_run = -INFINITY, l_run = 0.f;  // row g of the tile
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < cnt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();  // sub-tile i landed for every lane; i - 1 is read
    if (i + STAGES - 1 < cnt) load(i + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* ks = slot(i % STAGES, 0);
    const __nv_bfloat16* vs = slot(i % STAGES, 1);
    const int r0 = (warp + i * MMA_WARPS) * SUB;

    // S = Q K^T for 16 keys: two n8 tiles
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b[4];  // keys 0-7 | 8-15 x columns +0 | +8
      ldmatrix_x4(b, ks + ((lane >> 4) * 8 + (lane & 7)) * RS + kk * 16 +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int qi = NQ - 1; qi >= 0; --qi) {
        const uint32_t a[4] = {qa[qi][kk][0], 0u, qa[qi][kk][1], 0u};
        mma_bf16(sc[0], a, b[0], b[1]);
        mma_bf16(sc[1], a, b[2], b[3]);
      }
    }
    // row g: keys 2t, 2t+1 (tile 0) and 8+2t, 9+2t (tile 1)
    float s[4] = {sc[0][0], sc[0][1], sc[1][0], sc[1][1]};
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = r0 + (e >> 1) * 8 + 2 * t + (e & 1);
      s[e] = key < n ? s[e] * scale : -INFINITY;
      mx = fmaxf(mx, s[e]);
    }
    const float alpha = online_max(m_run, quad_max(mx));
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = expf(s[e] - m_run);
    l_run = fmaf(l_run, alpha, (p[0] + p[1]) + (p[2] + p[3]));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha;
      acc[j][1] *= alpha;
    }
    // P V: P (row g; rows g + 8 zero) as hi + lo bf16 terms
    uint32_t ph[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
    split_bf16(p[0], p[1], ph[0], pl[0]);
    split_bf16(p[2], p[3], ph[2], pl[2]);
#pragma unroll
    for (int dn = 0; dn < DP / 16; ++dn) {
      uint32_t b[4];  // keys 0-7 | 8-15 x columns +0 | +8, transposed
      ldmatrix_x4_trans(b, vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * RS +
                               dn * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dn], pl, b[0], b[1]);
      mma_bf16(acc[2 * dn], ph, b[0], b[1]);
      mma_bf16(acc[2 * dn + 1], pl, b[2], b[3]);
      mma_bf16(acc[2 * dn + 1], ph, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  l_run = quad_sum(l_run);
  __syncthreads();  // every warp is done with the ring

  // fold the four warps in warp order: M, then e_w = exp(m_w - M), L
  float* wm = fs + FOLD_HEAD;                   // [warp][8]
  float* wl = wm + MMA_WARPS * MAX_GROUP;
  float* we = wl + MMA_WARPS * MAX_GROUP;
  float* wacc = we + MMA_WARPS * MAX_GROUP;     // [warp][8][DP]
  if (g < group) {
    if (t == 0) {
      wm[warp * MAX_GROUP + g] = m_run;
      wl[warp * MAX_GROUP + g] = l_run;
    }
    float* dst = wacc + (warp * MAX_GROUP + g) * DP + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) = make_float2(acc[j][0],
                                                            acc[j][1]);
  }
  __syncthreads();
  if (threadIdx.x < group) {
    const int q = threadIdx.x;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) M = fmaxf(M, wm[w * MAX_GROUP + q]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float e = expf(wm[w * MAX_GROUP + q] - M);  // 0 for an idle warp
      we[w * MAX_GROUP + q] = e;
      L = fmaf(wl[w * MAX_GROUP + q], e, L);
    }
    fs[q] = M;
    fs[MAX_GROUP + q] = L;
  }
  __syncthreads();
  const size_t slot0 = (size_t)bh * nsplit;
  const size_t slot_i = slot0 + blockIdx.x;
  const int d4 = D / 4;  // four columns a thread at a time
  for (int idx = threadIdx.x; idx < group * d4; idx += MMA_THREADS) {
    const int q = idx / d4, d = (idx % d4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w)
      a = fma4(*reinterpret_cast<const float4*>(
                   wacc + (w * MAX_GROUP + q) * DP + d),
               we[w * MAX_GROUP + q], a);
    if (n_active == 1)  // the fold of one split: weight 1, the same bits
      store_out4<OUT_BF16>(out, ((size_t)bh * group + q) * D + d,
                           div4(a, fs[MAX_GROUP + q]));
    else
      *reinterpret_cast<float4*>(part_acc + (slot_i * group + q) * D + d) =
          a;
  }
  if (n_active == 1) return;
  if (threadIdx.x < group) {
    part_m[slot_i * group + threadIdx.x] = fs[threadIdx.x];
    part_l[slot_i * group + threadIdx.x] = fs[MAX_GROUP + threadIdx.x];
  }
  // publish the slot, then count the arrival: the barrier orders the
  // block's writes before thread 0's fence, which is cumulative
  __syncthreads();
  int* last = reinterpret_cast<int*>(fs + 2 * MAX_GROUP);
  if (threadIdx.x == 0) {
    __threadfence();
    *last = atomicAdd(counter + bh, 1) == n_active - 1;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // the last block of (b, kv head): fold the splits in split order (warp w
  // takes queries w, w + 4: max, weights into smem, l), then one thread
  // per (query, column)
  float* wts = fs + FOLD_HEAD;  // [group][n_active]
  for (int q = warp; q < group; q += MMA_WARPS) {
    float mx = -INFINITY;
    for (int i = lane; i < n_active; i += 32)
      mx = fmaxf(mx, __ldcg(part_m + (slot0 + i) * group + q));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int i = lane; i < n_active; i += 32) {
      const float w = expf(__ldcg(part_m + (slot0 + i) * group + q) - mx);
      wts[q * n_active + i] = w;
      l = fmaf(__ldcg(part_l + (slot0 + i) * group + q), w, l);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) fs[MAX_GROUP + q] = l;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < group * d4; idx += MMA_THREADS) {
    const int q = idx / d4, d = (idx % d4) * 4;
    const float4* src = reinterpret_cast<const float4*>(
        part_acc + (slot0 * group + q) * D + d);
    const size_t step = (size_t)group * D / 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int i = 0; i < n_active; ++i)
      a = fma4(__ldcg(src + i * step), wts[q * n_active + i], a);
    store_out4<OUT_BF16>(out, ((size_t)bh * group + q) * D + d,
                         div4(a, fs[MAX_GROUP + q]));
  }
  if (threadIdx.x == 0) counter[bh] = 0;  // ready for the next call
}

template <int KS, int NQ>
int launch_mma(const void* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const int* cache_len, int B, int H,
               int hkv, int S, int D, int chunk, int nsplit, float scale,
               float* part_m, float* part_l, float* part_acc, int* counter,
               void* out, cudaStream_t st) {
  static bool opted[attn_mma::kMaxDevices];
  const int group = H / hkv;
  const int smem = mma_smem(KS, group, nsplit);
  if (smem > attn_mma::kSmemBlockBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = attn_mma::opt_in_smem_once(
      decode_mma_kernel<KS, NQ>, opted);
  if (err != cudaSuccess) return (int)err;
  decode_mma_kernel<KS, NQ><<<dim3(nsplit, B * hkv), MMA_THREADS, smem, st>>>(
      q, k, v, cache_len, hkv, group, S, D, chunk, nsplit, scale, part_m,
      part_l, part_acc, counter, out);
  return (int)cudaGetLastError();
}

template <int NQ>
int dispatch_mma(const void* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, const int* cache_len, int B, int H,
                 int hkv, int S, int D, int chunk, int nsplit, float scale,
                 float* part_m, float* part_l, float* part_acc, int* counter,
                 void* out, cudaStream_t st) {
#define FD_MMA(KS_)                                                       \
  return launch_mma<KS_, NQ>(q, k, v, cache_len, B, H, hkv, S, D, chunk,  \
                             nsplit, scale, part_m, part_l, part_acc,     \
                             counter, out, st)
  if (D <= 16) FD_MMA(1);
  if (D <= 32) FD_MMA(2);
  if (D <= 64) FD_MMA(4);
  FD_MMA(8);
#undef FD_MMA
}

bool bad_shape(int H, int hkv, int D, int vec, int chunk, int nsplit) {
  return hkv < 1 || H % hkv || H / hkv > MAX_GROUP || D < 1 ||
         D > MAX_DIM || D % vec || chunk < 1 || chunk > MAX_CHUNK ||
         nsplit < 1;
}

}  // namespace

extern "C" {

// q (B, H, D) f32; k, v (B, Hkv, S, D) f32; cache_len (B,) int32; part_m,
// part_l (B*Hkv, nsplit, H/Hkv) and part_acc (B*Hkv, nsplit, H/Hkv, D) f32
// scratch; out (B, H, D) f32.
int flash_decode_f32(const float* q, const float* k, const float* v,
                     const int* cache_len, int B, int H, int hkv, int S,
                     int D, int chunk, int nsplit, float scale, float* part_m,
                     float* part_l, float* part_acc, float* out,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(H, hkv, D, 4, chunk, nsplit))
    return (int)cudaErrorInvalidValue;
  const int group = H / hkv;
#define FD_LAUNCH(G_)                                                    \
  return launch_f32<G_>(q, k, v, cache_len, B, H, hkv, S, D, chunk,      \
                        nsplit, scale, part_m, part_l, part_acc, out, st)
  if (group <= 1) FD_LAUNCH(1);
  if (group <= 2) FD_LAUNCH(2);
  if (group <= 4) FD_LAUNCH(4);
  FD_LAUNCH(MAX_GROUP);
#undef FD_LAUNCH
}

// q (B, H, D) bf16 when q_bf16 else f32; k, v (B, Hkv, S, D) bf16;
// cache_len (B,) int32; part_* as flash_decode_f32's; counter (B*Hkv,)
// int32, zero, left zero; out (B, H, D) bf16 when q_bf16 else f32.
int flash_decode_bf16(const void* q, int q_bf16, const void* k,
                      const void* v, const int* cache_len, int B, int H,
                      int hkv, int S, int D, int chunk, int nsplit,
                      float scale, float* part_m, float* part_l,
                      float* part_acc, int* counter, void* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(H, hkv, D, 8, chunk, nsplit))
    return (int)cudaErrorInvalidValue;
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  if (q_bf16)
    return dispatch_mma<1>(q, kb, vb, cache_len, B, H, hkv, S, D, chunk,
                           nsplit, scale, part_m, part_l, part_acc, counter,
                           out, st);
  return dispatch_mma<3>(q, kb, vb, cache_len, B, H, hkv, S, D, chunk, nsplit,
                         scale, part_m, part_l, part_acc, counter, out, st);
}

}  // extern "C"
