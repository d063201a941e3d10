"""Graph data substrate: generators, CSR, and a real neighbour sampler
(numpy only; the port's own copy of the reference's ``data/graph.py``,
which gives the same arrays for the same seeds).

The ``minibatch_lg`` shape requires genuine fanout sampling (15-10 over a
114M-edge graph at full scale); ``NeighborSampler`` implements uniform
fanout sampling over CSR on the host (the standard GraphSAGE input
pipeline), emitting fixed-shape padded subgraphs for the GIN forward.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np


class CSRGraph(NamedTuple):
    indptr: np.ndarray      # (N+1,) int64
    indices: np.ndarray     # (E,) int32 — in-neighbours of each node
    n_nodes: int


def edges_to_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSRGraph:
    """CSR over incoming edges: row i lists sources j of edges j→i."""
    order = np.argsort(dst, kind="stable")
    s, d = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, d + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRGraph(indptr, s.astype(np.int32), n_nodes)


def sbm_graph(n_nodes: int, n_edges: int, n_blocks: int, p_in: float = 0.9,
              d_feat: int = 64, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stochastic-block-model-ish graph with block-informative features.

    Returns (src, dst, features (N, d_feat), labels (N,)).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_blocks, n_nodes).astype(np.int32)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    # with prob p_in rewire dst into the same block as src
    same = rng.uniform(size=n_edges) < p_in
    by_block: List[np.ndarray] = [np.where(labels == b)[0]
                                  for b in range(n_blocks)]
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    for b in range(n_blocks):
        m = same & (labels[src] == b)
        if by_block[b].size and m.any():
            dst[m] = rng.choice(by_block[b], size=int(m.sum()))
    proto = rng.normal(size=(n_blocks, d_feat)).astype(np.float32)
    feats = (proto[labels] +
             0.8 * rng.normal(size=(n_nodes, d_feat))).astype(np.float32)
    return src, dst, feats, labels


def molecule_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                   n_classes: int, seed: int = 0):
    """Batched random 'molecules': label = parity of triangle-ish motif."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(batch, n_nodes, d_feat)).astype(np.float32)
    src = rng.integers(0, n_nodes, (batch, n_edges)).astype(np.int32)
    dst = rng.integers(0, n_nodes, (batch, n_edges)).astype(np.int32)
    node_mask = np.ones((batch, n_nodes), bool)
    edge_mask = np.ones((batch, n_edges), bool)
    deg = np.zeros((batch, n_nodes), np.int32)
    for b in range(batch):
        np.add.at(deg[b], dst[b], 1)
    labels = (deg.max(axis=1) % n_classes).astype(np.int32)
    return xs, src, dst, node_mask, edge_mask, labels


class SampledSubgraph(NamedTuple):
    """Fixed-shape padded k-hop subgraph."""
    node_ids: np.ndarray    # (N_sub,) int32 global ids (-1 pad)
    feats: np.ndarray       # (N_sub, d)
    edge_src: np.ndarray    # (E_sub,) int32 local ids
    edge_dst: np.ndarray    # (E_sub,) int32 local ids
    edge_mask: np.ndarray   # (E_sub,) bool
    seed_mask: np.ndarray   # (N_sub,) bool — the labelled seed nodes
    labels: np.ndarray      # (N_sub,) int32 (-1 where not seed)


@dataclasses.dataclass
class NeighborSampler:
    """Uniform fanout sampler over CSR (GraphSAGE-style)."""
    graph: CSRGraph
    feats: np.ndarray
    labels: np.ndarray
    fanouts: Tuple[int, ...] = (15, 10)
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def max_nodes(self, batch_nodes: int) -> int:
        n = batch_nodes
        total = batch_nodes
        for f in self.fanouts:
            n = n * f
            total += n
        return total

    def max_edges(self, batch_nodes: int) -> int:
        n, total = batch_nodes, 0
        for f in self.fanouts:
            total += n * f
            n = n * f
        return total

    def sample(self, seeds: np.ndarray) -> SampledSubgraph:
        g, rng = self.graph, self._rng
        b = seeds.shape[0]
        nodes: List[np.ndarray] = [seeds.astype(np.int32)]
        srcs: List[np.ndarray] = []
        dsts: List[np.ndarray] = []
        masks: List[np.ndarray] = []
        frontier = seeds.astype(np.int64)
        fvalid = np.ones(frontier.size, bool)
        for f in self.fanouts:
            deg = g.indptr[frontier + 1] - g.indptr[frontier]
            can = fvalid & (deg > 0)
            pick = rng.integers(0, 2 ** 62, size=(frontier.size, f))
            off = pick % np.maximum(deg, 1)[:, None]
            nbr = g.indices[(g.indptr[frontier][:, None] + off).clip(
                0, max(g.indices.size - 1, 0))]
            nbr = np.where(can[:, None], nbr, -1).astype(np.int32)
            srcs.append(nbr.reshape(-1))
            dsts.append(np.repeat(frontier.astype(np.int32), f))
            masks.append(np.repeat(can, f))
            nodes.append(nbr.reshape(-1))
            frontier = np.maximum(nbr.reshape(-1), 0).astype(np.int64)
            fvalid = nbr.reshape(-1) >= 0

        n_max, e_max = self.max_nodes(b), self.max_edges(b)
        all_nodes = np.concatenate(nodes)
        all_src = np.concatenate(srcs)
        all_dst = np.concatenate(dsts)
        all_mask = np.concatenate(masks) & (all_src >= 0)

        uniq = np.unique(np.concatenate(
            [seeds.astype(np.int32),
             all_nodes[all_nodes >= 0].astype(np.int32)]))
        # local remap: seeds first (stable order), then the rest
        rest = uniq[~np.isin(uniq, seeds.astype(np.int32))]
        local_ids = np.concatenate([seeds.astype(np.int32), rest])
        sort_order = np.argsort(local_ids)
        sorted_ids = local_ids[sort_order]

        def to_local(a):
            a = np.asarray(a, np.int32)
            pos = np.clip(np.searchsorted(sorted_ids, a), 0,
                          sorted_ids.size - 1)
            found = sorted_ids[pos] == a
            return np.where(found, sort_order[pos], -1).astype(np.int32)

        src_l = to_local(np.where(all_mask, all_src, -1))
        dst_l = to_local(np.where(all_mask, all_dst, -1))
        emask = all_mask & (src_l >= 0) & (dst_l >= 0)

        n_sub = max(n_max, local_ids.size)
        node_ids = np.full(n_sub, -1, np.int32)
        node_ids[: local_ids.size] = local_ids
        feats = np.zeros((n_sub, self.feats.shape[1]), np.float32)
        feats[: local_ids.size] = self.feats[local_ids]
        labels = np.full(n_sub, -1, np.int32)
        labels[: b] = self.labels[seeds]
        seed_mask = np.zeros(n_sub, bool)
        seed_mask[: b] = True

        e_sub = max(e_max, src_l.size)
        es = np.zeros(e_sub, np.int32)
        ed = np.zeros(e_sub, np.int32)
        em = np.zeros(e_sub, bool)
        es[: src_l.size] = np.where(emask, src_l, 0)
        ed[: dst_l.size] = np.where(emask, dst_l, 0)
        em[: emask.size] = emask
        return SampledSubgraph(node_ids, feats, es, ed, em, seed_mask, labels)

    def sample_trees(self, seeds: np.ndarray):
        """Per-seed sampling-tree format (the ``minibatch_lg`` input):
        each seed gets its own padded tree — node 0 is the seed, then
        hop-1 neighbours, then hop-2, …; edges point child → parent.
        Trees are disjoint by construction: a batch of them is one graph
        with no edge between trees.

        Returns dict(x (B, Tn, d), edge_src/edge_dst/edge_mask (B, Te),
        labels (B,)) with Tn = 1+f1+f1·f2+…, Te = Tn-1.
        """
        g, rng = self.graph, self._rng
        b = seeds.shape[0]
        tn = self.max_nodes(1)
        te = tn - 1
        d = self.feats.shape[1]
        x = np.zeros((b, tn, d), np.float32)
        es = np.zeros((b, te), np.int32)
        ed = np.zeros((b, te), np.int32)
        em = np.zeros((b, te), bool)
        labels = self.labels[seeds].astype(np.int32)

        for bi, seed in enumerate(seeds):
            nodes = [int(seed)]
            valid = [True]
            frontier = [(0, int(seed), True)]       # (local id, gid, valid)
            e = 0
            for f in self.fanouts:
                nxt = []
                for (pl, pg, pv) in frontier:
                    lo, hi = g.indptr[pg], g.indptr[pg + 1]
                    deg = hi - lo
                    for _ in range(f):
                        ok = pv and deg > 0
                        gid = int(g.indices[lo + rng.integers(deg)]
                                  ) if ok else 0
                        cl = len(nodes)
                        nodes.append(gid)
                        valid.append(ok)
                        es[bi, e] = cl
                        ed[bi, e] = pl
                        em[bi, e] = ok
                        e += 1
                        nxt.append((cl, gid, ok))
                frontier = nxt
            ids = np.asarray(nodes, np.int64)
            x[bi] = np.where(np.asarray(valid)[:, None],
                             self.feats[ids], 0.0)
        return {"x": x, "edge_src": es, "edge_dst": ed, "edge_mask": em,
                "labels": labels}
