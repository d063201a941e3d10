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
// Bound on this card: a query reads the rows it scores (ndist x d x 4 B,
// ~7 MB at ef = 64 and d = 768), 2 FLOP per 4 B read, so bytes; but the
// traversal is a chain of dependent steps, each of which waits for at
// least one device-memory round trip (its rows), so one query's time is
// set by steps x latency (the chain bound), not by bandwidth.
//
// What the design does about it: a step holds one dependent round trip
// to device memory and two barriers.
// - Rows: a warp scores up to ROWS rows at once and issues every float4
//   load of all of them before its first FMA (VEC float4 a lane a pass,
//   so d = 768 is one pass).  Lane l sums float4 l, l + 32, ... of a row
//   in order with fmaf, then a fixed xor butterfly, so a row's score has
//   the same bits whatever the rows in flight or B.  Rows bypass L1
//   (__ldcg): a query scores each at most once.
// - Visited set in shared memory, cleared by the block: a bitmap of n
//   bits, or an open-addressed hash of ids (linear probing, filled by
//   atomicCAS, never more than 11/20 full: a search visits at most
//   min(n, 1 + max_steps deg) ids), the smaller of the two that fits;
//   past both, a bitmap of n bits a query in global scratch, read through
//   L2 (tiling.hnsw_visited chooses; V_* instances).
// - Every warp reads the node's adjacency row and tests its neighbours
//   itself (no barrier between the pick and the rows); the marks are set
//   during the merge, after the barrier that ends every warp's tests.
//   Each new entry's adjacency row is prefetched into L1 while its score
//   is computed: the next pick is most often one of them.
// - Once a step's rows are scored, the next pick is known (the better of
//   the best new entry and the beam's first unexpanded one), so one warp
//   asks L2 for the rows of its neighbours while the others merge: the
//   next step's loads then mostly hit L2 (PERF.md section 6 has what was
//   measured and taken out: a bulk prefetch, rows by clusters of blocks).
// - The beam, kept sorted, is merged by rank (a beam entry counts the new
//   ones ranking before it, a new one binary-searches the beam) from one
//   buffer into the other, so the ranks need no barrier before the
//   writes; the thread that writes an unexpanded entry folds its position
//   into the next step's pick (a warp min, then a shared atomicMin), so
//   the pick costs no barrier and no scan.
// - The descent's warps post their best in one of two slot sets by the
//   step's parity, and every thread folds the 8 alike: one barrier a
//   step.
// B blocks run at once, so a batch costs about one query's latency while
// it fits the card's 132 SMs.
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
constexpr int ROWS = 4;  // rows a warp has in flight
constexpr int VEC = 6;   // float4 a lane loads of a row a pass
constexpr int PF_WARP = 4;  // the warp that prefetches the next step's rows
constexpr unsigned FULL = 0xffffffffu;

// The visited set's instances, in tiling.HNSW_VISITED's order.
constexpr int V_BITMAP = 0, V_HASH = 1, V_GLOBAL = 2;
constexpr int EMPTY = -1;  // a free hash slot

// Dots of up to ROWS rows (id < 0: no row) of 4 d4 floats with the staged
// query, by one warp; every lane's loads of all the rows are issued before
// its first FMA.  Each row: lane l sums float4 l, l + 32, ... in order,
// then a fixed xor butterfly; every lane returns the same values.
template <int R>
__device__ __forceinline__ void warp_dots(const float* __restrict__ vectors,
                                          int d4, const float4* q4,
                                          const int (&id)[R], float (&s)[R],
                                          int lane) {
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < d4; c0 += 32 * VEC) {
    float4 x[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4* r4 = reinterpret_cast<const float4*>(vectors) +
                         (size_t)max(id[r], 0) * d4;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int c = c0 + lane + 32 * i;
        if (id[r] >= 0 && c < d4) x[r][i] = __ldcg(r4 + c);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int c = c0 + lane + 32 * i;
        if (id[r] >= 0 && c < d4) {
          const float4 a = x[r][i];
          const float4 b = q4[c];
          acc[r] = fmaf(a.x, b.x, acc[r]);
          acc[r] = fmaf(a.y, b.y, acc[r]);
          acc[r] = fmaf(a.z, b.z, acc[r]);
          acc[r] = fmaf(a.w, b.w, acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v = acc[r];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    s[r] = v;
  }
}

// The hash's first slot for an id: Fibonacci hashing, then the top bits
// of the product scaled to [0, slots).
__device__ __forceinline__ int hash_slot(int id, int slots) {
  return (int)__umulhi((unsigned)id * 0x9E3779B9u, (unsigned)slots);
}

// Whether id is in the visited set (words: bitmap words or hash slots).
template <int V>
__device__ __forceinline__ bool seen(const unsigned* vis, int words,
                                     int id) {
  if constexpr (V == V_HASH) {
    const int* tab = reinterpret_cast<const int*>(vis);
    for (int h = hash_slot(id, words);; h = h + 1 == words ? 0 : h + 1) {
      const int x = tab[h];
      if (x == id) return true;
      if (x == EMPTY) return false;
    }
  } else if constexpr (V == V_GLOBAL) {
    return (__ldcg(vis + (id >> 5)) >> (id & 31)) & 1u;
  } else {
    return (vis[id >> 5] >> (id & 31)) & 1u;
  }
}

template <int V>
__device__ __forceinline__ void mark(unsigned* vis, int words, int id) {
  if constexpr (V == V_HASH) {
    int* tab = reinterpret_cast<int*>(vis);
    for (int h = hash_slot(id, words);; h = h + 1 == words ? 0 : h + 1) {
      const int x = atomicCAS(tab + h, EMPTY, id);
      if (x == EMPTY || x == id) return;
    }
  } else {
    atomicOr(vis + (id >> 5), 1u << (id & 31));
  }
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <int V>
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
  // the query (d floats), then a shared visited set of `words` words
  extern __shared__ float4 q4[];
  // the beam, two buffers: a step merges one into the other
  __shared__ float bv[2][MAX_EF];
  __shared__ int bi[2][MAX_EF];
  __shared__ int be[2][MAX_EF];
  // a step's new entries: score, id, order key
  __shared__ float nv[MAX_DEGREE];
  __shared__ int ni[MAX_DEGREE];
  __shared__ __align__(16) int nk[MAX_DEGREE];  // pads past c: INT_MIN
  // the descent's warp bests, two slot sets by the step's parity
  __shared__ float wv[2][WARPS];
  __shared__ int wj[2][WARPS];
  __shared__ int wi[2][WARPS];
  __shared__ int wn[2][WARPS];
  // ctl[0..1]: the pick of even / odd steps; ctl[2]: the entry's score
  __shared__ int ctl[4];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d4 = d >> 2;
  const float4* qg = reinterpret_cast<const float4*>(queries + (size_t)b * d);
  for (int c = tid; c < d4; c += THREADS) q4[c] = qg[c];
  unsigned* vis;
  if constexpr (V == V_GLOBAL) {
    vis = visited + (size_t)b * words;
    for (int w = tid; w < words; w += THREADS) __stcg(vis + w, 0u);
  } else {
    vis = reinterpret_cast<unsigned*>(q4 + d4);
    const unsigned fill = V == V_HASH ? ~0u : 0u;
    for (int w = tid; w < words; w += THREADS) vis[w] = fill;
  }
  __syncthreads();

  int ndist = 0;  // thread 0's count is the query's
  int start;
  if (entry_override != nullptr) {
    start = entry_override[b];
    if (warp == 0) {
      const int id[1] = {start};
      float s[1];
      warp_dots<1>(vectors, d4, q4, id, s, lane);
      if (lane == 0) bv[0][0] = s[0];
    }
  } else {
    // greedy descent, top level to level 1 (_greedy_level)
    int cur = *entry_point;
    if (warp == 0) {
      const int id[1] = {cur};
      float s[1];
      warp_dots<1>(vectors, d4, q4, id, s, lane);
      if (lane == 0) ctl[2] = __float_as_int(s[0]);
    }
    __syncthreads();
    float cur_s = __int_as_float(ctl[2]);
    ndist = 1;
    int par = 0;
    for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
      const int* adj = upper + (size_t)lvl * n * m;
      while (true) {
        const int* row = adj + (size_t)cur * m;
        float best = -INFINITY;
        int best_j = INT_MAX, best_id = -1, valid = 0;
        for (int j0 = warp; j0 < m; j0 += WARPS * ROWS) {
          int id[ROWS];
          float s[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const int j = j0 + r * WARPS;
            id[r] = j < m ? __ldg(row + j) : -1;
          }
          warp_dots<ROWS>(vectors, d4, q4, id, s, lane);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (id[r] < 0) continue;
            ++valid;
            if (s[r] > best) {  // j grows: the first maximum stays
              best = s[r];
              best_j = j0 + r * WARPS;
              best_id = id[r];
            }
          }
        }
        if (lane == 0) {
          wv[par][warp] = best;
          wj[par][warp] = best_j;
          wi[par][warp] = best_id;
          wn[par][warp] = valid;
        }
        __syncthreads();
        float top = -INFINITY;
        int top_j = INT_MAX, top_id = -1;
        for (int w = 0; w < WARPS; ++w) {
          ndist += wn[par][w];
          if (wv[par][w] > top || (wv[par][w] == top && wj[par][w] < top_j)) {
            top = wv[par][w];
            top_j = wj[par][w];
            top_id = wi[par][w];
          }
        }
        par ^= 1;
        if (top_j == INT_MAX || !(top > cur_s)) break;
        cur = top_id;
        cur_s = top;
      }
    }
    start = cur;
    if (tid == 0) bv[0][0] = cur_s;  // the start's dot, as scored
  }

  // level 0: the beam starts at `start` (_search_layer0)
  for (int p = tid; p < ef; p += THREADS) {
    if (p > 0) bv[0][p] = -INFINITY;
    bi[0][p] = p == 0 ? start : -1;
    be[0][p] = 0;
  }
  if (tid == 0) {
    mark<V>(vis, words, start);
    ctl[0] = 0;
  }
  ndist += 1;
  __syncthreads();

  int n_real = 1;  // the beam's real entries are its first n_real
  int cb = 0;      // the buffer that holds the beam
  for (int step = 0;; ++step) {
    const float* cv = bv[cb];
    const int* ci = bi[cb];
    int* ce = be[cb];
    // the pick: the first unexpanded entry of the sorted beam, which is
    // argmax(where(unexpanded, v, -inf)) with ties to the first index;
    // the reference's stop test: nothing left to expand, or the beam
    // full with its best unexpanded entry below its worst
    const int pick = ctl[step & 1];
    if (pick >= n_real || step >= max_steps ||
        (n_real >= ef && cv[pick] < cv[n_real - 1]))
      break;
    const int node = ci[pick];
    if (tid == 0) {
      ce[pick] = 1;
      ctl[(step + 1) & 1] = INT_MAX;
    }

    // the node's neighbours that are real and unvisited, in row order,
    // all tested before any is marked; warp w keeps the j-th of them for
    // j % WARPS == w
    const int* row = adj0 + (size_t)node * deg;
    int nb[MAX_DEGREE / 32];  // the row's entries lane, lane + 32, ...
#pragma unroll
    for (int t = 0; t < MAX_DEGREE / 32; ++t) {
      const int j = t * 32 + lane;
      nb[t] = j < deg ? __ldg(row + j) : -1;
    }
    int c = 0;
#pragma unroll
    for (int t = 0; t < MAX_DEGREE / 32; ++t) {
      if (t * 32 >= deg) break;
      const bool ok = nb[t] >= 0 && !seen<V>(vis, words, nb[t]);
      const unsigned bal = __ballot_sync(FULL, ok);
      if (ok) {
        const int at = c + __popc(bal & ((1u << lane) - 1u));
        if (at % WARPS == warp) ni[at] = nb[t];
      }
      c += __popc(bal);
    }
    __syncwarp();

    // ask for the new entries' adjacency rows while their vectors load:
    // the next pick is most often one of them
    const int lines = (deg + 31) >> 5;  // 128-byte lines a row
    const int mine = c > warp ? (c - warp + WARPS - 1) / WARPS : 0;
    for (int x = lane; x < mine * lines; x += 32)
      prefetch_l1(adj0 + (size_t)ni[warp + WARPS * (x / lines)] * deg +
                  (x % lines) * 32);

    for (int j0 = warp; j0 < c; j0 += WARPS * ROWS) {
      int id[ROWS];
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int j = j0 + r * WARPS;
        id[r] = j < c ? ni[j] : -1;
      }
      warp_dots<ROWS>(vectors, d4, q4, id, s, lane);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (id[r] < 0) continue;
          nv[j0 + r * WARPS] = s[r];
          nk[j0 + r * WARPS] = topk_tie::order_key(s[r]);
        }
      }
    }
    // keys of no entry up to a multiple of 4: below every float's key
    if (tid < ((c + 3) & ~3) - c) nk[c + tid] = INT_MIN;
    __syncthreads();

    // the next pick is known now: the better of the best new entry (key
    // desc, index asc) and the beam's first unexpanded entry (the beam
    // wins a tie).  One warp asks the L2 for its neighbours' rows while
    // the others merge, so the next step's loads find them there; the
    // visited test comes then, so a visited neighbour costs bandwidth
    // only
    if (warp == PF_WARP) {
      int bk = INT_MIN, bx = INT_MAX;
      for (int j = lane; j < c; j += 32) {
        if (nk[j] > bk) {  // j grows: the lane's first maximum stays
          bk = nk[j];
          bx = j;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const int ok = __shfl_xor_sync(FULL, bk, o);
        const int ox = __shfl_xor_sync(FULL, bx, o);
        if (ok > bk || (ok == bk && ox < bx)) {
          bk = ok;
          bx = ox;
        }
      }
      int p = INT_MAX;
      for (int base = 0; base < n_real; base += 32) {
        const unsigned bal =
            __ballot_sync(FULL, base + lane < n_real && !ce[base + lane]);
        if (bal) {
          p = base + __ffs(bal) - 1;
          break;
        }
      }
      int next = -1;
      if (bx != INT_MAX &&
          (p == INT_MAX || bk > topk_tie::order_key(cv[p])))
        next = ni[bx];
      else if (p != INT_MAX)
        next = ci[p];
      if (next >= 0) {
        const int* nrow = adj0 + (size_t)next * deg;
        const int vl = (d * 4 + 127) >> 7;  // 128-byte lines of a row
        for (int j = lane; j < deg; j += 32) {
          const int nb = __ldg(nrow + j);
          if (nb < 0) continue;
          const char* v =
              reinterpret_cast<const char*>(vectors + (size_t)nb * d);
          for (int l = 0; l < vl; ++l) prefetch_l2(v + l * 128);
        }
      }
    }

    // merge [beam; new] into the best ef by rank, into the other buffer:
    // (order_key desc, position asc), the beam's positions before the new
    // ones'; the new entries are marked visited here, after every warp's
    // tests
    float* ov = bv[cb ^ 1];
    int* oi = bi[cb ^ 1];
    int* oe = be[cb ^ 1];
    const int n_next = min(ef, n_real + c);
    const int4* nk4 = reinterpret_cast<const int4*>(nk);
    const int c4 = (c + 3) >> 2;
    int first = INT_MAX;  // the lowest unexpanded position this thread writes
    if (tid < ef) {  // beam entry tid, from the first warps
      const float v = cv[tid];
      const int key = topk_tie::order_key(v);
      int r = tid;
#pragma unroll 4
      for (int j = 0; j < c4; ++j) {
        const int4 kj = nk4[j];
        r += (kj.x > key) + (kj.y > key) + (kj.z > key) + (kj.w > key);
      }
      if (r < ef) {
        const int e = ce[tid];
        ov[r] = v;
        oi[r] = ci[tid];
        oe[r] = e;
        if (!e && r < n_next) first = r;
      }
    }
    const int x = THREADS - 1 - tid;  // new entry x, from the last warps
    if (x < c) {
      const int key = nk[x];
      int lo = 0, hi = ef;  // beam entries ranking before: key >= this
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (topk_tie::order_key(cv[mid]) >= key)
          lo = mid + 1;
        else
          hi = mid;
      }
      int r = lo;
#pragma unroll 4
      for (int j = 0; j < c4; ++j) {
        const int4 kj = nk4[j];
        const int at = 4 * j;
        r += (kj.x > key || (kj.x == key && at < x)) +
             (kj.y > key || (kj.y == key && at + 1 < x)) +
             (kj.z > key || (kj.z == key && at + 2 < x)) +
             (kj.w > key || (kj.w == key && at + 3 < x));
      }
      if (r < ef) {
        ov[r] = nv[x];
        oi[r] = ni[x];
        oe[r] = 0;
        if (r < n_next) first = min(first, r);
      }
      mark<V>(vis, words, ni[x]);
    }
    first = __reduce_min_sync(FULL, first);
    if (lane == 0 && first != INT_MAX) atomicMin(&ctl[(step + 1) & 1], first);
    n_real = n_next;
    ndist += c;
    cb ^= 1;
    __syncthreads();
  }

  // tombstones score -inf; the top k in lax.top_k's order: the live
  // entries in beam order, then the -inf ones (tombstoned, then pads) in
  // position order
  if (warp == 0) {
    const float* cv = bv[cb];
    const int* ci = bi[cb];
    float* ov = out_v + (size_t)b * k;
    int* oi = out_i + (size_t)b * k;
    int at = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int base = 0; base < ef && at < k; base += 32) {
        const int p = base + lane;
        bool live = false;
        if (p < n_real)
          live = deleted == nullptr || !deleted[ci[p]];
        const bool take = p < ef && (pass == 0 ? live : !live);
        const unsigned bal = __ballot_sync(FULL, take);
        const int o = at + __popc(bal & ((1u << lane) - 1u));
        if (take && o < k) {
          ov[o] = pass == 0 ? cv[p] : -INFINITY;
          oi[o] = ci[p];
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
// tombstone, or null.  ef <= 256, deg <= 256, k <= ef.  visited_kind
// (tiling.HNSW_VISITED): 0 a bitmap of words >= ceil(n / 32) words in
// shared memory, 1 a hash of words slots in shared memory, words * 11 >=
// 20 min(n, 1 + max_steps deg), 2 a bitmap in global scratch, visited B *
// words words, words >= ceil(n / 32), cleared here.  Shared memory: d * 4
// bytes for the query, and words * 4 for a shared set.  out_v / out_i (B,
// k) receive the top k scores and ids, out_nd (B,) the distance counts.
int hnsw_search(const float* vectors, int n, int d, const int* adj0,
                int deg, const int* upper, int n_levels, int m,
                const int* entry_point, const float* queries, int B,
                const int* entry_override, const unsigned char* deleted,
                int ef, int k, int max_steps, int visited_kind,
                unsigned* visited, int words, float* out_v, int* out_i,
                int* out_nd, void* stream) {
  if (B <= 0) return 0;
  if (ef < 1 || ef > MAX_EF || deg > MAX_DEGREE || m > MAX_DEGREE ||
      k < 1 || k > ef || d % 4 || max_steps < 0)
    return (int)cudaErrorInvalidValue;
  const long long reach = 1 + (long long)max_steps * deg;
  const long long visits = reach < n ? reach : n;
  const int bitmap = (n + 31) / 32;
  int smem = d * (int)sizeof(float);
  void (*kernel)(const float*, int, const int*, int, const int*, int, int,
                 int, const int*, const float*, const int*,
                 const unsigned char*, int, int, int, unsigned*, int,
                 float*, int*, int*);
  if (visited_kind == V_BITMAP && words >= bitmap) {
    kernel = hnsw_search_kernel<V_BITMAP>;
    smem += words * (int)sizeof(unsigned);
  } else if (visited_kind == V_HASH && (long long)words * 11 >= visits * 20) {
    kernel = hnsw_search_kernel<V_HASH>;
    smem += words * (int)sizeof(unsigned);
  } else if (visited_kind == V_GLOBAL && visited != nullptr &&
             words >= bitmap) {
    kernel = hnsw_search_kernel<V_GLOBAL>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)fused_common::launch(
      kernel, dim3(B), THREADS, smem, static_cast<cudaStream_t>(stream),
      vectors, d, adj0, deg, upper, n_levels, n, m, entry_point, queries,
      entry_override, deleted, ef, k, max_steps,
      visited_kind == V_GLOBAL ? visited : nullptr, words, out_v, out_i,
      out_nd);
}

}  // extern "C"
