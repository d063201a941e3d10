"""IVF (inverted file) index in the reference's bucketed-padded layout.

Port of ``repro/core/ivf.py``: ``p`` centroids from balanced k-means,
posting lists stored as a dense ``(p, Lmax, d)`` tensor with ``(p,
Lmax)`` doc ids (-1 = pad), so a list scan is a gather plus a dot.
Work counters report real (unpadded) distance computations.

The search paths are the plain PyTorch path of the default
configuration — the reference runs them in XLA, not in a Pallas
kernel.  The build is chunked (``kmeans.CHUNK`` points at a time) so it
runs at collection scale on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import kmeans as _kmeans
from repro_torch.core.topk import topk
from repro_torch.kernels import ref as _ref


class IVFIndex(NamedTuple):
    """Bucketed-padded IVF index; every field lives on one device."""
    centroids: torch.Tensor     # (p, d) float32
    list_vecs: torch.Tensor     # (p, Lmax, d) float32 — padded posting lists
    list_ids: torch.Tensor      # (p, Lmax) int32 — original doc ids, -1 = pad
    list_sizes: torch.Tensor    # (p,) int32 — real sizes

    @property
    def p(self) -> int:
        return self.centroids.shape[0]

    @property
    def d(self) -> int:
        return self.centroids.shape[1]

    @property
    def lmax(self) -> int:
        return self.list_ids.shape[1]

    @property
    def n_docs(self) -> int:
        return int(self.list_sizes.sum())


class SearchStats(NamedTuple):
    """Per-query work counters (the hardware-independent cost model)."""
    centroid_dists: torch.Tensor     # (B,) int32
    list_dists: torch.Tensor         # (B,) int32 — real doc distances
    padded_list_dists: torch.Tensor  # (B,) int32 — incl. padding


def build(vectors, p: int, *, iters: int = 10, seed: int = 0,
          capacity_factor: float = 1.3, device=None,
          chunk: int = _kmeans.CHUNK) -> IVFIndex:
    """Build the index: balanced k-means + bucketed posting-list layout.

    ``vectors`` (n, d): a tensor on ``device`` or a numpy array (copied
    there).  Within a list, docs keep ascending id order, as in the
    reference's host-side bucketing.
    """
    dev = _device.resolve(device)
    if isinstance(vectors, np.ndarray):
        vectors = torch.from_numpy(vectors).to(dev)
    _device.require(dev, vectors)
    vectors = vectors.to(torch.float32)
    n, d = vectors.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = _kmeans.fit_balanced(vectors, p, iters=iters, generator=gen,
                               capacity_factor=capacity_factor, chunk=chunk)
    sizes = res.sizes.to(torch.int64)
    lmax = max(int(sizes.max()), 1)
    order = torch.sort(res.assignment, stable=True).indices
    lists = res.assignment[order].to(torch.int64)
    slot = torch.arange(n, device=dev) - (torch.cumsum(sizes, 0)
                                          - sizes)[lists]
    list_ids = torch.full((p, lmax), -1, dtype=torch.int32, device=dev)
    list_ids[lists, slot] = order.to(torch.int32)
    list_vecs = torch.zeros((p, lmax, d), dtype=torch.float32, device=dev)
    flat = list_vecs.view(p * lmax, d)
    dest = lists * lmax + slot
    for s in range(0, n, chunk):
        flat[dest[s:s + chunk]] = vectors[order[s:s + chunk]]
    return IVFIndex(res.centroids, list_vecs, list_ids, res.sizes)


# ---------------------------------------------------------------------------
# search paths
# ---------------------------------------------------------------------------


def exact_search(vectors: torch.Tensor, queries: torch.Tensor, k: int, *,
                 chunk: int = 1 << 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force top-k over the collection (paper's 'Exact' row),
    ``chunk`` docs at a time; (values (B, k), int32 ids (B, k)).  Each
    query is scored by its own matrix–vector product
    (``kernels.ref.gemv_rows``), so its result does not depend on B: the
    Exact backend's batched turns equal its sequential ones."""
    best_v = best_i = None
    for s in range(0, vectors.shape[0], chunk):
        part = vectors[s:s + chunk]
        v, i = topk(_ref.gemv_rows(part, queries), min(k, part.shape[0]))
        i = i + s
        if best_v is not None:
            # earlier chunks hold lower ids: a stable sort of the
            # concatenation keeps ties in ascending-id order
            v, i = torch.cat([best_v, v], -1), torch.cat([best_i, i], -1)
            o = torch.sort(v, dim=-1, descending=True, stable=True).indices
            v, i = v.gather(-1, o)[:, :k], i.gather(-1, o)[:, :k]
        best_v, best_i = v, i
    return best_v, best_i.to(torch.int32)


def _scan_lists(index: IVFIndex, queries: torch.Tensor, sel: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan the selected posting lists; returns (top_v, top_ids,
    real_dists).  queries (B, d); sel (B, np) centroid indices.

    The same masked scan as the fused kernels' plain version, which the
    reference's f32 contract makes bit-identical to this path."""
    top_v, top_i, _ = _ref.fused_scan_ivf(queries, index.list_vecs,
                                          index.list_ids, sel, None, k=k)
    real = index.list_sizes[sel].sum(-1).to(torch.int32)
    return top_v, top_i, real


def search(index: IVFIndex, queries: torch.Tensor, *, nprobe: int, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """Plain IVF search (the paper's baseline)."""
    b = queries.shape[0]
    _, sel = topk(queries @ index.centroids.T, nprobe)
    top_v, top_i, real = _scan_lists(index, queries, sel, k)
    stats = SearchStats(
        centroid_dists=torch.full((b,), index.p, dtype=torch.int32,
                                  device=queries.device),
        list_dists=real,
        padded_list_dists=torch.full((b,), nprobe * index.lmax,
                                     dtype=torch.int32,
                                     device=queries.device))
    return top_v, top_i, stats


def search_cached(index: IVFIndex, cache_ids: torch.Tensor,
                  cache_vecs: torch.Tensor, queries: torch.Tensor, *,
                  nprobe: int, k: int):
    """TopLoc_IVF search against a cached centroid subset ``C0``.

    Returns (scores, doc_ids, sel_global (B, np) int32, stats).
    """
    b = queries.shape[0]
    h = cache_ids.shape[0]
    _, sel_local = topk(queries @ cache_vecs.T, nprobe)
    sel_global = cache_ids[sel_local]
    top_v, top_i, real = _scan_lists(index, queries, sel_global, k)
    stats = SearchStats(
        centroid_dists=torch.full((b,), h, dtype=torch.int32,
                                  device=queries.device),
        list_dists=real,
        padded_list_dists=torch.full((b,), nprobe * index.lmax,
                                     dtype=torch.int32,
                                     device=queries.device))
    return top_v, top_i, sel_global, stats


def make_cache(index: IVFIndex, q0: torch.Tensor, *, h: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hot-centroid cache from the first utterance: ``C0 = top_h(q0, C)``.
    q0 (d,).  Returns (cache_ids (h,) int32, cache_vecs (h, d))."""
    _, ids = topk(index.centroids @ q0, h)
    return ids.to(torch.int32), index.centroids[ids]
