// Tie-aware top-k order for the fused IVF kernels, as CUDA device functions.
//
// Counterpart of the tie-aware bitonic networks of the JAX reference
// (src/repro/kernels/sorting.py:124-197: _compare_exchange_tie,
// bitonic_sort_desc_tie, merge_topk_desc_tie, block_topk_desc_tie).
// Candidates are ordered by the composite key (value desc, position asc):
// lax.top_k's order over a flat row, ties going to the smaller source
// position.  Values compare as lax.top_k compares them, by their bits mapped
// to a monotone integer (order_key), so +0.0 ranks above -0.0 (core/topk.py
// order_key is the same map); NaN is out of scope.  Pads carry (-inf, a pad
// id, PAD_POS) and never displace a real candidate.  Every real candidate
// has its own position, so the order is total: any network that keeps the
// best w of a set by ranks_before (a block sort, a warp sort, a merge tree
// in any grouping) leaves the same w entries in the same order, and the
// kernels' outputs do not depend on the launch shape.
//
// block_sort / merge_lists / merge_grow work on three parallel arrays in
// shared memory (value, id, position), static or dynamic, of power-of-two
// widths (the kernels sort and merge up to 2,048 entries a list); every
// thread of the block must call them.  warp_sort sorts 32 N entries held
// in one warp's registers, N a lane, with shuffles and no barrier.  They
// are inline because several sources of the one library include this
// header.
#pragma once

#include <climits>
#include <cmath>

namespace topk_tie {

constexpr int PAD_POS = INT_MAX;

// The float's bits with the magnitude bits of negatives flipped: an int
// that orders like the float, -0.0 (-1) below +0.0 (0).
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// True when (va, pa) ranks strictly before (vb, pb).
__device__ __forceinline__ bool ranks_before(float va, int pa, float vb,
                                             int pb) {
  const int ka = order_key(va);
  const int kb = order_key(vb);
  return ka > kb || (ka == kb && pa < pb);
}

__device__ __forceinline__ void swap3(float* v, int* id, int* pos, int a,
                                      int b) {
  float tv = v[a]; v[a] = v[b]; v[b] = tv;
  int ti = id[a]; id[a] = id[b]; id[b] = ti;
  int tp = pos[a]; pos[a] = pos[b]; pos[b] = tp;
}

// In-place bitonic sort of n entries (n a power of two), best first.
// Synchronises before it starts and after it ends.
__device__ inline void block_sort(float* v, int* id, int* pos, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        // the final stage (size == n) runs best-first over the whole row
        const bool best_first = (lo & size) == 0;
        const bool swap =
            best_first ? ranks_before(v[hi], pos[hi], v[lo], pos[lo])
                       : ranks_before(v[lo], pos[lo], v[hi], pos[hi]);
        if (swap) swap3(v, id, pos, lo, hi);
      }
    }
  }
  __syncthreads();
}

// Sorts each of n_lists consecutive bitonic lists of w entries (w a power
// of two) best first with a half-cleaner network: log2(w) steps, each
// followed by a barrier.
__device__ inline void half_clean(float* v, int* id, int* pos, int n_lists,
                                  int w) {
  const int hw = w >> 1;
  for (int dist = hw; dist > 0; dist >>= 1) {
    for (int t = threadIdx.x; t < n_lists * hw; t += blockDim.x) {
      const int e = t % hw;
      const int lo = (t / hw) * w + 2 * e - (e & (dist - 1));
      const int hi = lo + dist;
      if (ranks_before(v[hi], pos[hi], v[lo], pos[lo]))
        swap3(v, id, pos, lo, hi);
    }
    __syncthreads();
  }
}

// Merges n_lists consecutive lists of w entries each (w a power of two,
// every list sorted best first) into the best w, left in list 0.  Each
// round folds list half+i into list i (entry t keeps the better of a[t]
// and b[w-1-t], which leaves the best w of both as a bitonic sequence)
// and sorts the folded lists with a half-cleaner network: log2(w) + 1
// steps per round, ceil(log2(n_lists)) rounds.  The caller synchronises
// after filling the lists; this synchronises after every step.
__device__ inline void merge_lists(float* v, int* id, int* pos, int n_lists,
                                   int w) {
  for (int m = n_lists; m > 1;) {
    const int half = (m + 1) >> 1;
    const int pairs = m - half;  // lists [half, m) fold into [0, pairs)
    for (int t = threadIdx.x; t < pairs * w; t += blockDim.x) {
      const int b = (half + t / w) * w + (w - 1 - t % w);
      if (ranks_before(v[b], pos[b], v[t], pos[t])) {
        v[t] = v[b];
        id[t] = id[b];
        pos[t] = pos[b];
      }
    }
    __syncthreads();
    half_clean(v, id, pos, pairs, w);
    m = half;
  }
}

// The best w of n_lists consecutive sorted lists of w_in <= w entries
// each (both powers of two), left sorted in [0, w); returns the width of
// that list (< w only when all the entries fit in fewer: the caller
// reads pads past it).  While the lists are narrower than w, pairs merge
// whole into lists of twice the width (list 2i, then list 2i+1 reversed,
// is bitonic: one compare step and a half-cleaner), no entry dropped; an
// odd last list is paired with pads (pad_id), so the arrays must hold
// n_lists * w_in + w entries when w_in < w.  Lists of width w are then
// folded by merge_lists.  The caller synchronises after filling the
// lists; this synchronises after every step.
__device__ inline int merge_grow(float* v, int* id, int* pos, int n_lists,
                                 int w_in, int w, int pad_id) {
  int n = n_lists;
  int width = w_in;
  while (width < w && n > 1) {
    if (n & 1) {
      for (int t = threadIdx.x; t < width; t += blockDim.x) {
        v[n * width + t] = -INFINITY;
        id[n * width + t] = pad_id;
        pos[n * width + t] = PAD_POS;
      }
      ++n;
      __syncthreads();
    }
    const int pairs = n >> 1;
    const int hw = width > 1 ? width >> 1 : 1;
    // a[e] against b[width-1-e] and a[width-1-e] against b[e]: the better
    // of each pair stays in a, the worse goes to b in that order
    for (int t = threadIdx.x; t < pairs * hw; t += blockDim.x) {
      const int base = (t / hw) * 2 * width;
      const int e = t % hw;
      const int f = width - 1 - e;
      const int ends[2][2] = {{base + e, base + width + f},
                              {base + f, base + width + e}};
      float bv[2], wv[2];
      int bi[2], wi[2], bp[2], wp[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int a = ends[k][0], b = ends[k][1];
        const bool b_first = ranks_before(v[b], pos[b], v[a], pos[a]);
        bv[k] = b_first ? v[b] : v[a];
        bi[k] = b_first ? id[b] : id[a];
        bp[k] = b_first ? pos[b] : pos[a];
        wv[k] = b_first ? v[a] : v[b];
        wi[k] = b_first ? id[a] : id[b];
        wp[k] = b_first ? pos[a] : pos[b];
      }
      const int lo[2] = {base + e, base + f};
      const int up[2] = {base + width + e, base + width + f};
#pragma unroll
      for (int k = 0; k < (e == f ? 1 : 2); ++k) {
        v[lo[k]] = bv[k]; id[lo[k]] = bi[k]; pos[lo[k]] = bp[k];
        v[up[k]] = wv[k]; id[up[k]] = wi[k]; pos[up[k]] = wp[k];
      }
    }
    __syncthreads();
    half_clean(v, id, pos, 2 * pairs, width);
    width <<= 1;
    n = pairs;
  }
  if (n > 1) merge_lists(v, id, pos, n, width);
  return width;
}

// One compare-exchange step of a bitonic network over the 32 N entries of
// one warp, entry lane * N + j in register j of the lane: stride s of the
// k-block stage (entries whose k bit is clear run best first).  Strides
// below N exchange within a lane, the others across lanes by shuffles.
template <int N>
__device__ __forceinline__ void warp_step(float (&v)[N], int (&id)[N],
                                          int (&pos)[N], int k, int s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int e = lane * N + j;
    const bool best_first = (e & k) == 0;
    if (s < N) {
      const int jp = j ^ s;
      if (jp > j &&
          (best_first ? ranks_before(v[jp], pos[jp], v[j], pos[j])
                      : ranks_before(v[j], pos[j], v[jp], pos[jp]))) {
        const float tv = v[j]; v[j] = v[jp]; v[jp] = tv;
        const int ti = id[j]; id[j] = id[jp]; id[jp] = ti;
        const int tp = pos[j]; pos[j] = pos[jp]; pos[jp] = tp;
      }
    } else {
      const int ls = s / N;
      const float ov = __shfl_xor_sync(0xffffffffu, v[j], ls);
      const int oi = __shfl_xor_sync(0xffffffffu, id[j], ls);
      const int op = __shfl_xor_sync(0xffffffffu, pos[j], ls);
      // the lower entry of a pair keeps the better one when the k-block
      // runs best first, the upper one the worse
      const bool keep_better = ((e & s) == 0) == best_first;
      if (keep_better ? ranks_before(ov, op, v[j], pos[j])
                      : ranks_before(v[j], pos[j], ov, op)) {
        v[j] = ov;
        id[j] = oi;
        pos[j] = op;
      }
    }
  }
}

// Bitonic sort of the 32 N entries of one warp (N a power of two), best
// first; no barrier.  All 32 lanes must call it.
template <int N>
__device__ __forceinline__ void warp_sort(float (&v)[N], int (&id)[N],
                                          int (&pos)[N]) {
#pragma unroll
  for (int k = 2; k <= 32 * N; k <<= 1)
#pragma unroll
    for (int s = k >> 1; s > 0; s >>= 1) warp_step<N>(v, id, pos, k, s);
}

// Merges the sorted 32 N entries (bv, bi, bp) of one warp into its sorted
// (v, id, pos), keeping the best 32 N: entry e keeps the better of a[e]
// and b[32N-1-e] (bitonic, as merge_lists folds), then a half-cleaner.
template <int N>
__device__ __forceinline__ void warp_merge(float (&v)[N], int (&id)[N],
                                           int (&pos)[N],
                                           const float (&bv)[N],
                                           const int (&bi)[N],
                                           const int (&bp)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float ov = __shfl_sync(0xffffffffu, bv[N - 1 - j], 31 - lane);
    const int oi = __shfl_sync(0xffffffffu, bi[N - 1 - j], 31 - lane);
    const int op = __shfl_sync(0xffffffffu, bp[N - 1 - j], 31 - lane);
    if (ranks_before(ov, op, v[j], pos[j])) {
      v[j] = ov;
      id[j] = oi;
      pos[j] = op;
    }
  }
#pragma unroll
  for (int s = 16 * N; s > 0; s >>= 1) warp_step<N>(v, id, pos, 32 * N, s);
}

// Loads list slot l (w <= 32 N entries, padded) of the arrays into a
// warp's registers.
template <int N>
__device__ __forceinline__ void warp_load(const float* v, const int* id,
                                          const int* pos, int l, int w,
                                          int pad_id, float (&rv)[N],
                                          int (&ri)[N], int (&rp)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int e = lane * N + j;
    rv[j] = e < w ? v[l * w + e] : -INFINITY;
    ri[j] = e < w ? id[l * w + e] : pad_id;
    rp[j] = e < w ? pos[l * w + e] : PAD_POS;
  }
}

template <int N>
__device__ inline void merge_warps_n(float* v, int* id, int* pos,
                                     int n_lists, int w, int pad_id) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float a[N], bv[N];
  int ai[N], ap[N], bi[N], bp[N];
  for (int l = warp; l < n_lists; l += nwarps) {
    if (l == warp) {
      warp_load<N>(v, id, pos, l, w, pad_id, a, ai, ap);
    } else {
      warp_load<N>(v, id, pos, l, w, pad_id, bv, bi, bp);
      warp_merge<N>(a, ai, ap, bv, bi, bp);
    }
  }
  // the warps' lists in slots of w (their best w is all the merge keeps),
  // halved a level: warp t < m - half merges slot t + half into its own
  int m = min(nwarps, n_lists);
  __syncthreads();  // every list read before the slots overwrite them
  for (;;) {
    if (warp < m) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int e = lane * N + j;
        if (e < w) {
          v[warp * w + e] = a[j];
          id[warp * w + e] = ai[j];
          pos[warp * w + e] = ap[j];
        }
      }
    }
    __syncthreads();
    if (m == 1) return;
    const int half = (m + 1) >> 1;
    if (warp < m - half) {
      warp_load<N>(v, id, pos, warp + half, w, pad_id, bv, bi, bp);
      warp_merge<N>(a, ai, ap, bv, bi, bp);
    }
    m = half;
  }
}

// Merges n_lists consecutive lists of w <= 128 entries each (w a power of
// two, every list sorted best first) into the best w, left in list 0, by
// warps: warp t folds lists t, t + nwarps, ... in registers (warp_merge,
// lists narrower than 32 padded), then the warps' lists merge pairwise,
// a barrier a level.  The caller synchronises after filling the lists;
// this returns after a barrier.
__device__ inline void merge_warps(float* v, int* id, int* pos, int n_lists,
                                   int w, int pad_id) {
  if (w <= 32)
    merge_warps_n<1>(v, id, pos, n_lists, w, pad_id);
  else if (w <= 64)
    merge_warps_n<2>(v, id, pos, n_lists, w, pad_id);
  else
    merge_warps_n<4>(v, id, pos, n_lists, w, pad_id);
}

}  // namespace topk_tie
