"""Balanced k-means for IVF index construction, chunked over points.

Port of ``repro/core/kmeans.py``: Lloyd iterations under dot-product
similarity with random or k-means++ initialisation and respawn of
empty clusters, then a capacity-constrained assignment that spills
points to their next-nearest centroids.  Unlike the reference, nothing
here holds an ``(n, p)`` matrix: similarities are formed ``chunk``
points at a time, which is what lets the index build run at collection
scale (8.8M × 16K scores would be 580 GB).

``torch.Generator`` replaces ``jax.random``: the two give different
numbers from one seed, so the port's k-means is held to the reference
by properties, while ``balance_assignment`` on the same points and
centroids is held to it exactly.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.topk import topk

#: points per similarity chunk (chunk × p f32 scores in flight)
CHUNK = 32768


class KMeansResult(NamedTuple):
    centroids: torch.Tensor     # (p, d) float32
    assignment: torch.Tensor    # (n,) int32 — balanced assignment
    sizes: torch.Tensor         # (p,) int32 — cluster sizes after balancing
    inertia: torch.Tensor       # () float — mean max-similarity


def _chunks(n: int, chunk: int):
    for s in range(0, n, chunk):
        yield s, min(n, s + chunk)


def assign(points: torch.Tensor, centroids: torch.Tensor, *,
           chunk: int = CHUNK) -> torch.Tensor:
    """Nearest centroid by dot product (first index on ties), (n,) int64."""
    out = torch.empty(points.shape[0], dtype=torch.int64,
                      device=points.device)
    for s, e in _chunks(points.shape[0], chunk):
        out[s:e] = torch.argmax(points[s:e] @ centroids.T, dim=-1)
    return out


def _plusplus_init(points: torch.Tensor, p: int,
                   generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (Arthur & Vassilvitskii), as the reference's
    ``_plusplus_init``: each next seed is drawn with probability
    proportional to its squared L2 distance from the nearest seed so far.
    Holds (n,) vectors only; ``torch.multinomial`` draws on the device
    (up to 2^24 points), so the p draws need no host sync.  Where every
    distance is 0 (fewer distinct points than seeds) the draw is uniform.
    """
    n = points.shape[0]
    dev = points.device
    sq = (points * points).sum(-1)
    d2 = torch.full((n,), float("inf"), device=dev)
    seeds = torch.empty(p, dtype=torch.int64, device=dev)
    idx = torch.randint(0, n, (1,), generator=generator, device=dev)
    for t in range(p):
        seeds[t:t + 1] = idx
        if t == p - 1:
            break
        c = points[idx][0]
        d2 = torch.minimum(d2, sq + (c * c).sum() - 2.0 * (points @ c))
        probs = d2.clamp_min(0.0)
        probs = probs + (probs.sum() <= 0).to(probs.dtype)
        idx = torch.multinomial(probs, 1, generator=generator)
    return points[seeds]


def kmeans_fit(points: torch.Tensor, p: int, *, iters: int = 10,
               generator: torch.Generator, chunk: int = CHUNK,
               init: str = "random") -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations; returns (centroids (p, d), assignment (n,)).

    ``init``: ``"random"`` (p distinct points) or ``"++"`` (k-means++
    seeding, the PQ codebooks' choice).  Centroid sums use
    ``index_add_``, whose float atomics make the bits of a card build
    vary from run to run (the reference's segment_sum is deterministic);
    the index's quality does not depend on them.
    """
    n, d = points.shape
    dev = points.device
    if init == "++":
        centroids = _plusplus_init(points, p, generator)
    elif init != "random":
        raise ValueError(f"init must be 'random' or '++', got {init!r}")
    elif n >= p:
        centroids = points[torch.randperm(n, generator=generator,
                                          device=dev)[:p]].clone()
    else:
        centroids = points[torch.randint(0, n, (p,), generator=generator,
                                         device=dev)].clone()
    for _ in range(iters):
        a = assign(points, centroids, chunk=chunk)
        sums = torch.zeros((p, d), dtype=points.dtype, device=dev)
        sums.index_add_(0, a, points)
        counts = torch.bincount(a, minlength=p).to(points.dtype)
        centroids = sums / counts.clamp(min=1.0)[:, None]
        # respawn empty clusters from random points (keeps p live lists)
        repl = points[torch.randint(0, n, (p,), generator=generator,
                                    device=dev)]
        centroids = torch.where((counts < 0.5)[:, None], repl, centroids)
    return centroids, assign(points, centroids, chunk=chunk)


def balance_assignment(points: torch.Tensor, centroids: torch.Tensor,
                       p: int, capacity: int, n_choices: int = 4, *,
                       chunk: int = CHUNK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-constrained assignment: greedy spill to next-nearest centroid.

    Same result as the reference: per choice rank, unplaced points are
    taken in similarity-priority order (higher similarity first, lower
    index on ties); a point that does not fit its rank-r centroid waits
    for rank r+1.  The reference ranks a point inside its candidate
    cluster with an (n, p+1) one-hot cumsum; here the same rank comes
    from a stable sort by (candidate cluster, priority order).  Points
    still unplaced after ``n_choices`` ranks go, in index order, to the
    least-loaded cluster (lowest index on ties).

    Returns (assignment (n,) int32, sizes (p,) int32).
    """
    n = points.shape[0]
    dev = points.device
    n_choices = min(n_choices, p)
    choice_sims = torch.empty((n, n_choices), dtype=points.dtype, device=dev)
    choice_ids = torch.empty((n, n_choices), dtype=torch.int64, device=dev)
    for s, e in _chunks(n, chunk):
        choice_sims[s:e], choice_ids[s:e] = topk(points[s:e] @ centroids.T,
                                                 n_choices)

    assignment = torch.full((n,), -1, dtype=torch.int64, device=dev)
    sizes = torch.zeros(p, dtype=torch.int64, device=dev)
    for r in range(n_choices):
        want = torch.nonzero(assignment < 0).squeeze(1)     # ascending
        if want.numel() == 0:
            break
        # priority order: similarity desc, index asc on ties
        o1 = torch.sort(-choice_sims[want, r], stable=True).indices
        pts = want[o1]
        cand = choice_ids[pts, r]
        # group by candidate cluster, keeping priority order inside
        o2 = torch.sort(cand, stable=True).indices
        pts, cand = pts[o2], cand[o2]
        counts = torch.bincount(cand, minlength=p)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(cand.numel(), device=dev) - starts[cand]
        ok = rank < capacity - sizes[cand]
        assignment[pts[ok]] = cand[ok]
        sizes += torch.bincount(cand[ok], minlength=p)

    left = torch.nonzero(assignment < 0).squeeze(1).tolist()
    if left:
        # stragglers, one by one, into the least-loaded cluster
        heap = [(int(s), c) for c, s in enumerate(sizes.tolist())]
        heapq.heapify(heap)
        tgt = []
        for _ in left:
            size, c = heapq.heappop(heap)
            tgt.append(c)
            heapq.heappush(heap, (size + 1, c))
        tgt_t = torch.tensor(tgt, dtype=torch.int64, device=dev)
        assignment[torch.tensor(left, dtype=torch.int64, device=dev)] = tgt_t
        sizes += torch.bincount(tgt_t, minlength=p)
    return assignment.to(torch.int32), sizes.to(torch.int32)


def fit_balanced(points: torch.Tensor, p: int, *, iters: int = 10,
                 generator: torch.Generator, capacity_factor: float = 1.3,
                 chunk: int = CHUNK) -> KMeansResult:
    """End-to-end: Lloyd fit + capacity-balanced final assignment."""
    n = points.shape[0]
    centroids, _ = kmeans_fit(points, p, iters=iters, generator=generator,
                              chunk=chunk)
    capacity = max(1, int(capacity_factor * n / p + 0.9999))
    assignment, sizes = balance_assignment(points, centroids, p, capacity,
                                           chunk=chunk)
    best = torch.zeros((), dtype=torch.float64, device=points.device)
    for s, e in _chunks(n, chunk):
        best += (points[s:e] @ centroids.T).max(-1).values.sum()
    return KMeansResult(centroids, assignment, sizes, (best / n).float())
