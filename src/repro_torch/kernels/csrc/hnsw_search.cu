// HNSW search for Hopper (sm_90a): one thread block per query, float32.
//
// hnsw_search replaces no Pallas kernel.  It computes the reference's
// XLA while_loop traversal, _search_impl (src/repro/core/hnsw.py:349-388,
// with _greedy_level :282 and _search_layer0 :305), for B queries: the
// greedy descent from the global entry point through the upper levels
// (argmax over a node's neighbours, ties to the first, moving only on a
// strictly larger score), or a caller's entry override per query; then
// the level-0 beam of ef (score, id, expanded) entries: each step expands
// the best unexpanded entry (ties to the first position, jnp.argmax),
// scores its neighbours that are real and not yet visited (tested before
// the step marks them), marks them visited and merges [beam; new] back to
// ef entries in lax.top_k's order (score desc by topk_tie::order_key, so
// +0.0 above -0.0, ties to the lower position), until the reference's
// stop test (:314-323) or max_steps = 4 ef + 16 steps.  Tombstoned ids
// then score -inf, and the top k of the beam come out in lax.top_k's
// order, with ndist: the descent's entry dot and valid neighbours, 1 for
// the level-0 entry and each neighbour that was scored there.  Its plain
// version is kernels/ref.py hnsw_search.
//
// Why a kernel where the reference runs XLA: in eager PyTorch each of up
// to 4 ef + 16 steps is some 15-20 small launches and a host sync for the
// data-dependent stop test, thousands of launches a search; here a search
// is one launch and no sync.
//
// Bound on this card: device-memory bytes.  A query reads the rows it
// scores (ndist x d x 4 B, ~7 MB at ef = 64 and d = 768) and an adjacency
// row a step, 2 FLOP per 4 B read.  The traversal is a chain of dependent
// steps (pick, neighbour row, visited bits, row reads, merge), so one
// query's time is set by the latency of each step, not by bandwidth.
//
// What the design does about it (simple first): the query lives in
// shared memory (d floats, dynamic), the beam in static shared memory,
// kept sorted, so the pick is the first unexpanded entry (one warp
// ballot per 32 entries) and the merge places each entry by its rank
// (a beam entry counts the new ones ranking before it, a new one
// binary-searches the beam), two barriers and no sort network; each warp
// scores one neighbour row at a time: lanes stride over d in float4 and a
// fixed butterfly sums them, so a row's score does not depend on B; the
// visited set is a bitmap of n bits per query in global scratch, cleared
// by the kernel at its start, read through L2 (__ldcg) and set by
// atomicOr.  B blocks run at once, so a batch costs about one query's
// latency while it fits the card's 132 SMs.
//
// Plain C interface (bound with ctypes): returns a cudaError_t as int, 0
// when the launch was accepted.  Ids (the entry point, overrides, and the
// adjacency's non-negative entries) must lie in [0, n): the caller's
// contract.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

#include "fused_common.cuh"
#include "topk_tie.cuh"

namespace {

// Must equal tiling.HNSW_THREADS, HNSW_MAX_EF and HNSW_MAX_DEGREE.
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_EF = 256;
constexpr int MAX_DEGREE = 256;
constexpr unsigned FULL = 0xffffffffu;

// ctl slots: the step's go flag, its node, its count of new entries, the
// descent's current node, whether it moved, and the entry's score (bits).
constexpr int C_GO = 0, C_NODE = 1, C_NEW = 2, C_CUR = 3, C_MOVED = 4,
              C_SCORE = 5;

// Dot of a 16-byte-aligned row of d = 4 d4 floats with the staged query,
// by one warp: lane l sums float4 l, l + 32, ... in order, then a fixed
// xor butterfly; every lane returns the same value.
__device__ __forceinline__ float warp_dot(const float* __restrict__ row,
                                          const float4* q4, int d4,
                                          int lane) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
  for (int c = lane; c < d4; c += 32) {
    const float4 a = __ldg(r4 + c);
    const float4 b = q4[c];
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  return acc;
}

__device__ __forceinline__ bool seen(const unsigned* vis, int id) {
  return (__ldcg(vis + (id >> 5)) >> (id & 31)) & 1u;
}

__global__ void __launch_bounds__(THREADS)
    hnsw_search_kernel(const float* __restrict__ vectors, int d,
                       const int* __restrict__ adj0, int deg,
                       const int* __restrict__ upper, int n_levels, int n,
                       int m, const int* __restrict__ entry_point,
                       const float* __restrict__ queries,
                       const int* __restrict__ entry_override,
                       const unsigned char* __restrict__ deleted, int ef,
                       int k, int max_steps, unsigned* visited, int words,
                       float* __restrict__ out_v, int* __restrict__ out_i,
                       int* __restrict__ out_nd) {
  extern __shared__ float4 q4[];
  __shared__ float bv[MAX_EF];
  __shared__ int bi[MAX_EF];
  __shared__ int be[MAX_EF];
  __shared__ float nv[MAX_DEGREE];
  __shared__ int ni[MAX_DEGREE];
  __shared__ float wv[WARPS];
  __shared__ int wj[WARPS];
  __shared__ int wn[WARPS];
  __shared__ int ctl[8];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d4 = d >> 2;
  const float4* qg = reinterpret_cast<const float4*>(queries + (size_t)b * d);
  for (int c = tid; c < d4; c += THREADS) q4[c] = qg[c];
  unsigned* vis = visited + (size_t)b * words;
  for (int w = tid; w < words; w += THREADS) __stcg(vis + w, 0u);
  __syncthreads();

  int ndist = 0;  // thread 0's count is the query's
  int start;
  if (entry_override != nullptr) {
    start = entry_override[b];
  } else {
    // greedy descent, top level to level 1 (_greedy_level)
    int cur = *entry_point;
    if (warp == 0) {
      const float s = warp_dot(vectors + (size_t)cur * d, q4, d4, lane);
      if (lane == 0) ctl[C_SCORE] = __float_as_int(s);
    }
    __syncthreads();
    float cur_s = __int_as_float(ctl[C_SCORE]);  // thread 0 decides moves
    ndist = 1;
    for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
      const int* adj = upper + (size_t)lvl * n * m;
      while (true) {
        const int* row = adj + (size_t)cur * m;
        float best = -INFINITY;
        int best_j = INT_MAX, valid = 0;
        for (int j = warp; j < m; j += WARPS) {
          const int nb = row[j];
          if (nb < 0) continue;
          ++valid;
          const float s = warp_dot(vectors + (size_t)nb * d, q4, d4, lane);
          if (s > best) {  // j grows: the first maximum stays
            best = s;
            best_j = j;
          }
        }
        if (lane == 0) {
          wv[warp] = best;
          wj[warp] = best_j;
          wn[warp] = valid;
        }
        __syncthreads();
        if (tid == 0) {
          float top = -INFINITY;
          int top_j = INT_MAX;
          for (int w = 0; w < WARPS; ++w) {
            ndist += wn[w];
            if (wv[w] > top || (wv[w] == top && wj[w] < top_j)) {
              top = wv[w];
              top_j = wj[w];
            }
          }
          const bool moved = top_j != INT_MAX && top > cur_s;
          if (moved) {
            cur_s = top;
            ctl[C_CUR] = row[top_j];
          } else {
            ctl[C_CUR] = cur;
          }
          ctl[C_MOVED] = moved;
        }
        __syncthreads();
        cur = ctl[C_CUR];
        const bool moved = ctl[C_MOVED];
        __syncthreads();
        if (!moved) break;
      }
    }
    start = cur;
  }

  // level 0: the beam starts at `start` (_search_layer0)
  if (warp == 0) {
    const float s = warp_dot(vectors + (size_t)start * d, q4, d4, lane);
    if (lane == 0) bv[0] = s;
  }
  for (int p = tid; p < ef; p += THREADS) {
    if (p > 0) bv[p] = -INFINITY;
    bi[p] = p == 0 ? start : -1;
    be[p] = 0;
  }
  if (tid == 0) {
    atomicOr(vis + (start >> 5), 1u << (start & 31));
    ndist += 1;
  }
  __syncthreads();

  int n_real = 1;  // the beam's real entries are its first n_real
  for (int step = 0;; ++step) {
    // the pick: the first unexpanded entry of the sorted beam, which is
    // argmax(where(unexpanded, v, -inf)) with ties to the first index
    if (warp == 0) {
      int pick = -1;
      for (int base = 0; base < n_real; base += 32) {
        const int p = base + lane;
        const unsigned bal = __ballot_sync(FULL, p < n_real && !be[p]);
        if (bal) {
          pick = base + __ffs(bal) - 1;
          break;
        }
      }
      if (lane == 0) {
        // the reference's stop test: nothing left to expand, or the beam
        // full with its best unexpanded entry below its worst
        bool go = pick >= 0 && step < max_steps;
        if (go && n_real >= ef && bv[pick] < bv[n_real - 1]) go = false;
        if (go) {
          be[pick] = 1;
          ctl[C_NODE] = bi[pick];
        }
        ctl[C_GO] = go;
      }
    }
    __syncthreads();
    if (!ctl[C_GO]) break;

    // the node's neighbours that are real and unvisited, in row order,
    // all tested before any is marked
    if (warp == 0) {
      const int* row = adj0 + (size_t)ctl[C_NODE] * deg;
      int c = 0;
      for (int base = 0; base < deg; base += 32) {
        const int j = base + lane;
        const int nb = j < deg ? row[j] : -1;
        const bool ok = nb >= 0 && !seen(vis, nb);
        const unsigned bal = __ballot_sync(FULL, ok);
        if (ok) ni[c + __popc(bal & ((1u << lane) - 1u))] = nb;
        c += __popc(bal);
      }
      __syncwarp();
      for (int j = lane; j < c; j += 32)
        atomicOr(vis + (ni[j] >> 5), 1u << (ni[j] & 31));
      if (lane == 0) ctl[C_NEW] = c;
    }
    __syncthreads();
    const int c = ctl[C_NEW];
    for (int j = warp; j < c; j += WARPS) {
      const float s = warp_dot(vectors + (size_t)ni[j] * d, q4, d4, lane);
      if (lane == 0) nv[j] = s;
    }
    __syncthreads();

    // merge [beam; new] into the best ef by rank: (order_key desc,
    // position asc), the beam's positions before the new ones'
    float mv = 0.f, xv = 0.f;
    int mi = 0, me = 0, mr = INT_MAX, xi = 0, xr = INT_MAX;
    if (tid < ef) {
      mv = bv[tid];
      mi = bi[tid];
      me = be[tid];
      const int key = topk_tie::order_key(mv);
      int r = tid;
      for (int j = 0; j < c; ++j) r += topk_tie::order_key(nv[j]) > key;
      mr = r;
    }
    if (tid < c) {
      xv = nv[tid];
      xi = ni[tid];
      const int key = topk_tie::order_key(xv);
      int lo = 0, hi = ef;  // beam entries ranking before: key >= this
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (topk_tie::order_key(bv[mid]) >= key)
          lo = mid + 1;
        else
          hi = mid;
      }
      int r = lo;
      for (int j = 0; j < c; ++j) {
        const int kj = topk_tie::order_key(nv[j]);
        r += kj > key || (kj == key && j < tid);
      }
      xr = r;
    }
    __syncthreads();
    if (mr < ef) {
      bv[mr] = mv;
      bi[mr] = mi;
      be[mr] = me;
    }
    if (xr < ef) {
      bv[xr] = xv;
      bi[xr] = xi;
      be[xr] = 0;
    }
    n_real = min(ef, n_real + c);
    ndist += c;
    __syncthreads();
  }

  // tombstones score -inf; the top k in lax.top_k's order: the live
  // entries in beam order, then the -inf ones (tombstoned, then pads) in
  // position order
  if (warp == 0) {
    float* ov = out_v + (size_t)b * k;
    int* oi = out_i + (size_t)b * k;
    int at = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int base = 0; base < ef && at < k; base += 32) {
        const int p = base + lane;
        bool live = false;
        if (p < n_real)
          live = deleted == nullptr || !deleted[bi[p]];
        const bool take = p < ef && (pass == 0 ? live : !live);
        const unsigned bal = __ballot_sync(FULL, take);
        const int o = at + __popc(bal & ((1u << lane) - 1u));
        if (take && o < k) {
          ov[o] = pass == 0 ? bv[p] : -INFINITY;
          oi[o] = bi[p];
        }
        at += __popc(bal);
      }
    }
  }
  if (tid == 0) out_nd[b] = ndist;
}

}  // namespace

extern "C" {

// vectors (n, d) float32, rows 16-byte aligned (d % 4 == 0); adj0 (n,
// deg) int32 and upper (n_levels, n, m) int32, -1 pads; entry_point one
// int32 on the device; queries (B, d) float32; entry_override (B,) int32
// or null (then the descent runs); deleted (n,) bytes, nonzero for a
// tombstone, or null.  ef <= 256, deg <= 256, k <= ef, d * 4 bytes of
// shared memory for the query.  visited: B * words scratch words, words
// >= ceil(n / 32), cleared here.  out_v / out_i (B, k) receive the top k
// scores and ids, out_nd (B,) the distance counts.
int hnsw_search(const float* vectors, int n, int d, const int* adj0,
                int deg, const int* upper, int n_levels, int m,
                const int* entry_point, const float* queries, int B,
                const int* entry_override, const unsigned char* deleted,
                int ef, int k, int max_steps, unsigned* visited, int words,
                float* out_v, int* out_i, int* out_nd, void* stream) {
  if (B <= 0) return 0;
  if (ef < 1 || ef > MAX_EF || deg > MAX_DEGREE || m > MAX_DEGREE ||
      k < 1 || k > ef || d % 4 || words < (n + 31) / 32)
    return (int)cudaErrorInvalidValue;
  return (int)fused_common::launch(
      hnsw_search_kernel, dim3(B), THREADS, d * (int)sizeof(float),
      static_cast<cudaStream_t>(stream), vectors, d, adj0, deg, upper,
      n_levels, n, m, entry_point, queries, entry_override, deleted, ef, k,
      max_steps, visited, words, out_v, out_i, out_nd);
}

}  // extern "C"
