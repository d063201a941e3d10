"""HNSW index: host-side (numpy) build, one-kernel-per-query search.

Port of ``repro/core/hnsw.py``.  The build follows Malkov & Yashunin
(the paper's [14]): probabilistic level assignment (ml = 1/ln(M)),
ef_construction beam insertion, bidirectional links, degree cap 2M at
level 0 and M above.  It runs in host numpy, as the reference's does,
and builds the reference's graph exactly: ``adj0``, ``upper_adj``,
``entry_point`` and ``node_level`` are equal array for array.  Its
beam keeps the reference's lists in heaps of the same order (see
``_insert_range``), and every similarity is the reference's
``x[ids] @ q`` on the same arrays, so the floats compared are the same
floats.

The index is a NamedTuple of tensors on the caller's device (default
cuda): padded adjacency tensors, level 0 ``(n, 2M) int32`` and the
upper levels stacked ``(L, n, M) int32``, -1 pads.  ``search`` runs the
reference's fixed-width beam (``_search_impl``): the descent from the
global entry point (or a conversation's privileged entry point), then
the level-0 beam of ``ef`` candidates, through ``kernels.ops
.hnsw_search``: one CUDA block per query on CUDA tensors, the plain
batched version (``kernels.ref.hnsw_search``) on CPU tensors.
Distance counters come back per query; they are the
hardware-independent cost evidence of Table 1.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.kernels import ops as _kops


class HNSWIndex(NamedTuple):
    vectors: torch.Tensor       # (n, d) float32
    adj0: torch.Tensor          # (n, 2M) int32, -1 padded: level-0 graph
    upper_adj: torch.Tensor     # (L, n, M) int32, -1 padded: levels 1..L
    entry_point: torch.Tensor   # () int32: node at the top level
    node_level: torch.Tensor    # (n,) int32: max level of each node
    # (n,) bool tombstones, or None.  Deleted nodes keep routing the
    # beam; they are masked out of the result top-k only.
    deleted: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def top_level(self) -> int:
        return self.upper_adj.shape[0]


# ---------------------------------------------------------------------------
# host-side build (offline indexing step)
# ---------------------------------------------------------------------------


def _draw_levels(n: int, m: int, seed: int) -> np.ndarray:
    """Level assignments for nodes 0..n-1.  One sequential uniform draw,
    so ``_draw_levels(n)[:n0] == _draw_levels(n0)``: the prefix property
    ``insert`` relies on to continue the stream."""
    rng = np.random.default_rng(seed)
    ml = 1.0 / np.log(max(m, 2))
    return np.minimum(
        (-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(np.int64), 12)


def _insert_range(x, adj, deg, levels, entry, entry_level, lo, hi, m,
                  ef_construction):
    """Insert nodes ``lo..hi-1`` into the (mutable) adjacency state.

    The reference's loop, with its beam's Python lists kept in heaps of
    the same order:

      * the candidates, a list sorted stably by descending similarity
        before each ``pop(0)``, are a heap keyed ``(-s, seq)``, ``seq``
        counting the insertions: its pop is the largest s, ties going
        to the earliest inserted, as the stable sort's first entry;
      * the results, scanned for ``min(r[0] for r in result)`` and
        trimmed by ``result.remove(min(result))``, are a min-heap of
        ``(s, id, seq)``: its head is ``min(result)`` (ids are distinct,
        so ties go to the smaller id and ``seq`` never decides), and
        the final stable sort by descending s orders ties by insertion,
        which ``seq`` keeps.
    """
    m0 = 2 * m

    def sims_to(q, ids):
        return x[ids] @ q

    def greedy(q, start, level):
        cur, cur_s = start, float(x[start] @ q)
        while True:
            nbrs = adj[level][cur]
            nbrs = nbrs[nbrs >= 0]
            if nbrs.size == 0:
                return cur, cur_s
            s = sims_to(q, nbrs)
            j = int(np.argmax(s))
            if s[j] > cur_s:
                cur, cur_s = int(nbrs[j]), float(s[j])
            else:
                return cur, cur_s

    def search_layer(q, start, level, ef):
        """Classic ef-beam search; returns (sim, id) pairs sorted desc."""
        visited = {start}
        s0 = float(x[start] @ q)
        seq = 0
        cand = [(-s0, seq, start)]
        result = [(s0, start, seq)]
        while cand:
            neg_s, _, c = heapq.heappop(cand)
            if -neg_s < result[0][0] and len(result) >= ef:
                break
            row = adj[level][c]
            nbrs = [v for v in row[row >= 0].tolist() if v not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            # float32 scores as Python floats: the same values, compared
            # exactly as the reference compares them
            s = sims_to(q, np.asarray(nbrs, np.int64)).tolist()
            for sv, nid in zip(s, nbrs):
                if len(result) < ef or sv > result[0][0]:
                    seq += 1
                    heapq.heappush(cand, (-sv, seq, nid))
                    heapq.heappush(result, (sv, nid, seq))
                    if len(result) > ef:
                        heapq.heappop(result)
        result.sort(key=lambda t: (-t[0], t[2]))
        return [(s, nid) for s, nid, _ in result]

    def connect(src, dst_list, level):
        cap = m0 if level == 0 else m
        for dst in dst_list:
            for a, b in ((src, dst), (dst, src)):
                if deg[level][a] < cap:
                    adj[level][a, deg[level][a]] = b
                    deg[level][a] += 1
                else:  # shrink: keep the `cap` nearest neighbours
                    cur = adj[level][a][: deg[level][a]].tolist() + [b]
                    s = sims_to(x[a], np.asarray(cur, np.int64))
                    keep = np.argsort(-s)[:cap]
                    adj[level][a, :cap] = np.asarray(cur, np.int32)[keep]
                    deg[level][a] = cap

    for i in range(lo, hi):
        q = x[i]
        l_i = int(levels[i])
        cur = entry
        for level in range(entry_level, l_i, -1):
            cur, _ = greedy(q, cur, level)
        for level in range(min(l_i, entry_level), -1, -1):
            res = search_layer(q, cur, level, ef_construction)
            nbr = [nid for _, nid in res[: (m0 if level == 0 else m)]]
            connect(i, nbr, level)
            cur = res[0][1]
        if l_i > entry_level:
            entry, entry_level = i, l_i
    return entry, entry_level


def _host(vectors) -> np.ndarray:
    if isinstance(vectors, torch.Tensor):
        vectors = vectors.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(vectors, np.float32)


def _on_device(vectors, x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The index's vectors on ``dev``: the caller's tensor itself when it
    already lies there as contiguous float32 (a prefix view of a corpus
    stays a view), else a copy of the host array."""
    if (isinstance(vectors, torch.Tensor) and vectors.device.type == dev.type
            and vectors.dtype == torch.float32 and vectors.is_contiguous()):
        return vectors
    return torch.tensor(x, device=dev)


def _index(vectors, x, adj, levels, entry, m, dev, deleted=None
           ) -> HNSWIndex:
    n = x.shape[0]
    upper = (np.stack([a[:, :m] for a in adj[1:]], 0)
             if len(adj) > 1 else np.zeros((0, n, m), np.int32))
    return HNSWIndex(
        vectors=_on_device(vectors, x, dev),
        adj0=torch.from_numpy(adj[0]).to(dev),
        upper_adj=torch.from_numpy(np.ascontiguousarray(upper)).to(dev),
        entry_point=torch.tensor(entry, dtype=torch.int32, device=dev),
        node_level=torch.from_numpy(levels.astype(np.int32)).to(dev),
        deleted=deleted)


def build(vectors, m: int = 16, ef_construction: int = 64, seed: int = 0,
          device=None) -> HNSWIndex:
    """Standard HNSW insertion in host numpy, O(n·ef·M·hops): offline.
    ``vectors`` (n, d), a numpy array or a tensor; the index lives on
    ``device`` (default cuda), its vectors the given tensor when that
    already lies there."""
    dev = _device.resolve(device)
    x = _host(vectors)
    n = x.shape[0]
    levels = _draw_levels(n, m, seed)
    top = int(levels.max()) if n else 0
    m0 = 2 * m
    adj = [np.full((n, m0 if l == 0 else m), -1, np.int32)
           for l in range(top + 1)]
    deg = [np.zeros(n, np.int32) for _ in range(top + 1)]
    entry, _ = _insert_range(x, adj, deg, levels, 0, int(levels[0]), 1, n,
                             m, ef_construction)
    return _index(vectors, x, adj, levels, entry, m, dev)


def insert(index: HNSWIndex, new_vectors, *, ef_construction: int = 64,
           seed: int = 0) -> HNSWIndex:
    """Incrementally insert ``new_vectors`` as nodes ``n0..n-1``.

    The level draw continues ``build``'s stream and the insertion loop
    is the same ``_insert_range``, so ``insert(build(x[:n0]), x[n0:])``
    equals ``build(x)`` for the same ``(m, ef_construction, seed)``.
    The result lives on the index's device.
    """
    dev = index.vectors.device
    xb, xn = _host(index.vectors), _host(new_vectors)
    n0, n = xb.shape[0], xb.shape[0] + xn.shape[0]
    x = np.concatenate([xb, xn], 0)
    m0 = index.adj0.shape[1]
    m = m0 // 2
    levels = _draw_levels(n, m, seed)
    if not np.array_equal(levels[:n0],
                          index.node_level.cpu().numpy().astype(np.int64)):
        raise ValueError(
            "insert: level stream mismatch — the index was not built "
            f"with (m={m}, seed={seed}); incremental insertion would "
            "diverge from a from-scratch build")
    top = int(levels.max()) if n else 0
    adj = [np.full((n, m0 if l == 0 else m), -1, np.int32)
           for l in range(top + 1)]
    adj[0][:n0] = index.adj0.cpu().numpy()
    up = index.upper_adj.cpu().numpy()           # (L_old, n0, m)
    for l in range(1, index.top_level + 1):
        adj[l][:n0] = up[l - 1]
    # connect() fills each row as a contiguous prefix, so the stored -1
    # padding encodes the degree state exactly
    deg = [np.sum(a >= 0, axis=1).astype(np.int32) for a in adj]
    entry = int(index.entry_point)
    entry, _ = _insert_range(x, adj, deg, levels, entry, int(levels[entry]),
                             n0, n, m, ef_construction)
    deleted = index.deleted
    if deleted is not None:
        deleted = torch.cat([deleted, torch.zeros(
            (xn.shape[0],), dtype=torch.bool, device=dev)])
    return _index(x, x, adj, levels, entry, m, dev, deleted)


def save(index: HNSWIndex, path: str) -> None:
    """The reference's npz layout: one array per non-None field."""
    np.savez(path, **{k: v.cpu().numpy()
                      for k, v in index._asdict().items() if v is not None})


def load(path: str, device=None) -> HNSWIndex:
    """An index saved by ``save`` (or by the reference's) on ``device``
    (default cuda)."""
    dev = _device.resolve(device)
    z = np.load(path)
    return HNSWIndex(**{k: torch.from_numpy(np.asarray(z[k])).to(dev)
                        for k in z.files})


# ---------------------------------------------------------------------------
# query path
# ---------------------------------------------------------------------------


def search(index: HNSWIndex, queries: torch.Tensor, *, ef: int, k: int,
           entry_override: Optional[torch.Tensor] = None,
           use_entry_override: bool = False,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch HNSW search. queries (B, d).

    Plain HNSW: hierarchy descent from the global entry point, then the
    level-0 ef-beam.  TopLoc_HNSW: ``use_entry_override=True`` starts the
    level-0 beam at ``entry_override`` (B,) (the conversation's
    privileged entry point), skipping the descent: the paper's saving.

    Returns (scores (B, k), ids (B, k) int32, ndist (B,) int32).
    """
    return _kops.hnsw_search(
        index.vectors, index.adj0, index.upper_adj, index.entry_point,
        queries, entry_override if use_entry_override else None, ef=ef, k=k,
        deleted=index.deleted, device=queries.device)
