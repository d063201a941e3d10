// Decode attention (one new token against a KV cache) for Hopper (sm_90a).
//
// flash_decode_f32 / flash_decode_bf16 replace the Pallas kernel
// flash_decode of src/repro/kernels/flash_attention.py:180 (body
// _decode_kernel :141, pallas_call :201): for each batch row b and head h,
// softmax(q[b,h] k[b,h/group,:len]^T / sqrt(D)) v[b,h/group,:len] with
// len = min(cache_len[b], S), in float32 math over a float32 or bfloat16
// cache read in its own type.
//
// Bound on this card: device-memory bytes.  A step reads each kv head's
// first len rows of K and V once (at B = 8, 4 kv heads, D = 128, len =
// 32,768 in bf16: 537 MB, 160 us at 3.35 TB/s) and does 4 FLOP per cache
// element per query of the group (8 for Yi-9B): 2 FLOP/B, far below the
// ridge.  Rows at or past len are never read.
//
// What the design does about it (flash-decoding):
//  * the Pallas grid walks S sequentially per (b, kv head), which would
//    give B x Hkv = 4 blocks at B = 1; here S is cut into splits of
//    `chunk` rows (flash_decode.decode_split: 64 to 512 rows, a function
//    of S alone), one 256-thread block per (split, b x kv head), so a
//    step at B = 8 and S = 32,768 puts 64 x 32 blocks on the 132 SMs;
//  * phase A: `lpr` lanes share a cache row, each lane reading 16 bytes
//    of K (8 bf16 or 4 f32), four rows in flight, converting them to f32
//    against the group's queries (times 1/sqrt(D), in f32) held in
//    registers; the lanes of a row reduce each dot by xor shuffles into
//    the block's score tile in shared memory;
//  * phase B: one warp per query of the group takes the chunk's max,
//    p = exp(s - max) once per (query, row), and the sum l;
//  * phase C: the same lanes stream V, four rows in flight, and keep
//    acc[group][their 8 or 4 columns]; the row groups fold by shuffle,
//    the warps in order through shared memory, into the split's (m, l,
//    acc) slot; a second kernel folds the splits of each (b, kv head) in
//    split order, so the result depends on neither B nor the scheduling.
// Simple first: no TMA, no tensor cores, K and V read in two passes over
// the chunk.  The f32 split partials, group x (D + 2) floats a split, are
// written and read once: at chunk 512 and group 8 that is 3 % of the bf16
// cache bytes.
//
// Plain C interface (bound with ctypes): every entry returns a cudaError_t
// as int, 0 when every launch was accepted.  cache_len[b] < 1 gives NaN
// rows (a softmax over no position), as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;   // 8 warps
constexpr int MAX_DIM = 128;
constexpr int MAX_GROUP = 8;   // one warp per query of the group in phase B
constexpr int MAX_CHUNK = 512;
constexpr int UNROLL = 4;      // rows a lane group has in flight

template <typename T>
struct Vec;  // elements of T in 16 bytes
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

// 8 bf16 -> f32, exactly: a bf16 is the high half of its f32
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// grid (nsplit, B * Hkv).  Block (s, bh) attends the group's queries to
// rows [s*chunk, min((s+1)*chunk, len)) of kv head bh and writes its
// (m, l, acc) per query to the split's slot, in three phases:
//  A  scores: lpr lanes (a power of two >= D / VEC) share a row, UNROLL
//     rows in flight; the row's dot per query goes to p_s;
//  B  one warp per query: the chunk's max m, p = exp(s - m) in place,
//     l = sum p;
//  C  P V: the same lanes stream V rows, acc[g][:] += p[g][r] v[r][:],
//     then the warps' row groups fold by shuffle and the warps in order.
template <typename T, int G>
__global__ void __launch_bounds__(THREADS, 2)
decode_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cache_len,
                    int hkv, int group, int S, int D, int lpr, int chunk,
                    int nsplit, float scale, float* __restrict__ part_m,
                    float* __restrict__ part_l,
                    float* __restrict__ part_acc) {
  constexpr int VEC = Vec<T>::N;
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
  const T* k0 = k + ((size_t)bh * S + start) * D + col;
  const T* v0 = v + ((size_t)bh * S + start) * D + col;

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

template <typename T, int G>
int launch(const float* q, const T* k, const T* v, const int* cache_len,
           int B, int H, int hkv, int S, int D, int chunk, int nsplit,
           float scale, float* part_m, float* part_l, float* part_acc,
           float* out, cudaStream_t st) {
  const int group = H / hkv;
  const int nvec = D / Vec<T>::N;
  int lpr = 1;
  while (lpr < nvec) lpr <<= 1;
  const int smem = THREADS / 32 * G * D * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<T, G><<<dim3(nsplit, B * hkv), THREADS, smem, st>>>(
      q, k, v, cache_len, hkv, group, S, D, lpr, chunk, nsplit, scale,
      part_m, part_l, part_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = (max(group * D, 32 * group) + 31) / 32 * 32;
  const int wsmem = group * nsplit * (int)sizeof(float);
  err = cudaFuncSetAttribute(decode_combine_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wsmem);
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<B * hkv, threads, wsmem, st>>>(
      cache_len, hkv, group, S, D, chunk, nsplit, part_m, part_l, part_acc,
      out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const float* q, const T* k, const T* v, const int* cache_len,
             int B, int H, int hkv, int S, int D, int chunk, int nsplit,
             float scale, float* part_m, float* part_l, float* part_acc,
             float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hkv < 1 || H % hkv || D < 1 || D > MAX_DIM || D % Vec<T>::N ||
      chunk < 1 || chunk > MAX_CHUNK || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  const int group = H / hkv;
#define FD_LAUNCH(G_)                                                      \
  return launch<T, G_>(q, k, v, cache_len, B, H, hkv, S, D, chunk, nsplit, \
                       scale, part_m, part_l, part_acc, out, st)
  if (group <= 1) FD_LAUNCH(1);
  if (group <= 2) FD_LAUNCH(2);
  if (group <= 4) FD_LAUNCH(4);
  if (group <= MAX_GROUP) FD_LAUNCH(MAX_GROUP);
#undef FD_LAUNCH
  return (int)cudaErrorInvalidValue;
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
  return dispatch<float>(q, k, v, cache_len, B, H, hkv, S, D, chunk, nsplit,
                         scale, part_m, part_l, part_acc, out, stream);
}

// As flash_decode_f32 with k, v (B, Hkv, S, D) bfloat16.
int flash_decode_bf16(const float* q, const void* k, const void* v,
                      const int* cache_len, int B, int H, int hkv, int S,
                      int D, int chunk, int nsplit, float scale,
                      float* part_m, float* part_l, float* part_acc,
                      float* out, void* stream) {
  return dispatch<__nv_bfloat16>(
      q, static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), cache_len, B, H, hkv, S, D, chunk,
      nsplit, scale, part_m, part_l, part_acc, out, stream);
}

}  // extern "C"
