// Tie-aware top-k order for the fused IVF kernels, as CUDA device functions.
//
// Counterpart of the tie-aware bitonic networks of the JAX reference
// (src/repro/kernels/sorting.py:124-197: _compare_exchange_tie,
// bitonic_sort_desc_tie, merge_topk_desc_tie, block_topk_desc_tie).
// Candidates are ordered by the composite key (value desc, position asc):
// lax.top_k's order over a flat row, ties going to the smaller source
// position.  Pads carry (-inf, id -1, PAD_POS) and never displace a real
// candidate.  Every real candidate has its own position, so the order is
// total and the kernels' outputs do not depend on the launch shape.
//
// All functions work on three parallel arrays in shared memory (value, id,
// position); every thread of the block must call them.  They are inline
// because several sources of the one library include this header.
#pragma once

#include <climits>

namespace topk_tie {

constexpr int PAD_POS = INT_MAX;

// True when (va, pa) ranks strictly before (vb, pb).
__device__ __forceinline__ bool ranks_before(float va, int pa, float vb,
                                             int pb) {
  return va > vb || (va == vb && pa < pb);
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
    const int hw = w >> 1;
    for (int dist = hw; dist > 0; dist >>= 1) {
      for (int t = threadIdx.x; t < pairs * hw; t += blockDim.x) {
        const int e = t % hw;
        const int lo = (t / hw) * w + 2 * e - (e & (dist - 1));
        const int hi = lo + dist;
        if (ranks_before(v[hi], pos[hi], v[lo], pos[lo]))
          swap3(v, id, pos, lo, hi);
      }
      __syncthreads();
    }
    m = half;
  }
}

}  // namespace topk_tie
