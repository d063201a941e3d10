"""Segmented mutable corpus: delta segment + tombstones + compaction.

Port of ``repro/core/segment.py``.  Every index is build-once; a corpus
that changes while sessions are live gets the segmented design on top of
a registered backend (``"ivf"``, ``"ivf_pq"`` or ``"hnsw"``):

  * **delta segment** — an append-only ``(cap, d)`` float32 buffer
    scanned exactly.  New documents take increasing global ids, so delta
    row ``j`` holds id ``n_base + j`` and ids are never renumbered.
  * **tombstone mask** — one bool per global id.  A delete masks base
    and delta at once: IVF / IVF-PQ posting-list entries flip to ``-1``
    (the pad convention the scan kernels already mask, so a deleted
    entry is a hole in the middle of its list) and ``list_sizes`` is
    recomputed; HNSW nodes keep routing the beam but leave the result
    top-k (``hnsw.HNSWIndex.deleted``); delta rows mask through
    ``tombstone[delta_ids]``.
  * **compaction** — ``compact`` folds the delta into the base.  IVF /
    IVF-PQ re-pack their lists on the device: a survivor's new slot is
    its rank among its list's live rows, a delta doc goes after its
    list's survivors in id order, at its nearest frozen centroid (PQ
    re-encodes it with the frozen codebook).  HNSW inserts the added
    docs with ``hnsw.insert``, continuing the build's level stream.  The
    compacted index equals ``rebuild``, the from-scratch construction
    over the same corpus and mutation set, tensor for tensor.

A delta doc's list and PQ code are functions of the row alone (one
matrix–vector product a row, ``kernels.ref.gemv_rows``; one ``pq.encode``
call a row), so they do not depend on how the adds were grouped — the
condition for compact == rebuild.  The delta scan scores each query by
its own matrix–vector product too, so a row's bits do not depend on the
batch.

The merged order is the reference's ``lax.sort`` on ``(-score,
position)``: base rank ``r`` at position ``r``, delta row ``j`` at
``k + j``.  That sort treats +0.0 and -0.0 as equal (it is not
``core.topk``'s bit order), so ties of any sign break base first, then
by append (= id) order, and an empty delta returns the base top-k as it
is.

Every function here returns new tensors and never writes into a tensor
of the index it was given (the reference's "returns new pytrees, never
mutates"): a kernel's cached per-tensor state (``kernels.ops
.group_scales``) stays valid for every tensor that lives on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import hnsw as _hnsw
from repro_torch.core import ivf as _ivf
from repro_torch.core import kmeans as _kmeans
from repro_torch.core import pq as _pq
from repro_torch.core import toploc as _tl
from repro_torch.core.backend import IVFBackend, RetrievalBackend, register
from repro_torch.core.topk import order_key, topk
from repro_torch.kernels import ref as _kref


class SegmentedIndex(NamedTuple):
    """Mutable corpus = frozen base + append-only delta + tombstones.

    ``tombstone`` covers the whole assignable id space ``n_base + cap``,
    so ``n_base`` is ``tombstone.shape[0] - delta_ids.shape[0]`` and
    adds and deletes change no shape; only ``compact`` does.  Every
    tensor lives on the base index's device.
    """
    base: Any                   # the wrapped backend's index
    delta_vecs: torch.Tensor    # (cap, d) float32 — append-only buffer
    delta_ids: torch.Tensor     # (cap,) int32 — global doc ids, -1 = empty
    tombstone: torch.Tensor     # (n_base + cap,) bool — True = deleted


def n_base(index: SegmentedIndex) -> int:
    """Id-space size of the base segment (purged ids included)."""
    return index.tombstone.shape[0] - index.delta_ids.shape[0]


def delta_cap(index: SegmentedIndex) -> int:
    return index.delta_ids.shape[0]


def delta_fill(index: SegmentedIndex) -> int:
    """Occupied delta rows (appends are contiguous from row 0)."""
    return int((index.delta_ids >= 0).sum())


# ---------------------------------------------------------------------------
# delta scan + ordered merge (the query path)
# ---------------------------------------------------------------------------


def _delta_scan(index: SegmentedIndex, q: torch.Tensor, kk: int):
    """Exact masked scan of the delta buffer.  q (B, d).

    Returns (scores (B, kk), rows (B, kk), ids (B, kk) int32, live ()
    int32).  One matrix–vector product a query, so a delta doc scores
    the same bits at any batch size.
    """
    live = (index.delta_ids >= 0) & \
        ~index.tombstone[index.delta_ids.clamp_min(0).long()]
    scores = _kref.gemv_rows(index.delta_vecs, q)
    scores = torch.where(live[None, :], scores,
                         torch.full((), float("-inf"), device=q.device))
    v, rows = topk(scores, kk)
    return v, rows, index.delta_ids[rows], live.sum().to(torch.int32)


def _merge_ordered(base_v, base_i, delta_v, delta_rows, delta_i, k: int):
    """Base-vs-delta merge in the reference's ``lax.sort`` order on
    (-score, position): base rank r at position r, delta row j at k + j.

    Sorted by position first, then stably by score descending, the
    scores keyed by ``order_key(v + 0.0)``: adding +0.0 turns -0.0 into
    +0.0, so the two rank as equal, as under ``lax.sort``, on any sort
    implementation.  Empty delta rows are -inf and fall behind every
    base entry.
    """
    bpos = torch.arange(base_v.shape[-1], device=base_v.device
                        ).expand(base_v.shape)
    all_v = torch.cat([base_v, delta_v], -1)
    all_p = torch.cat([bpos, k + delta_rows], -1)
    all_i = torch.cat([base_i.to(torch.int32), delta_i.to(torch.int32)], -1)
    by_pos = torch.sort(all_p, dim=-1, stable=True).indices
    all_v, all_i = all_v.gather(-1, by_pos), all_i.gather(-1, by_pos)
    by_v = torch.sort(order_key(all_v + 0.0), dim=-1, descending=True,
                      stable=True).indices[..., :k]
    return all_v.gather(-1, by_v), all_i.gather(-1, by_v)


@register
@dataclasses.dataclass(frozen=True)
class SegmentedBackend(RetrievalBackend):
    """Any registered backend + a live delta segment + tombstones.

    Delegates every session / turn method to ``inner`` on ``index.base``
    (sessions — centroid caches, HNSW entry points — come from base
    results only, so no session names a delta id that a compaction moves
    into the base), then merges the exactly scanned delta top-k into the
    ranking.  The delta's live rows are charged to
    ``TurnStats.list_dists``: a float scan the cost model must see.
    """

    name: ClassVar[str] = "segmented"
    index_kwarg: ClassVar[str] = "segmented_index"

    inner: Any = IVFBackend()

    @property
    def stateful(self):  # type: ignore[override]
        return self.inner.stateful

    # ---- merge plumbing ---------------------------------------------------

    def _merge_batch(self, index, q, v, i, stats, k):
        kk = min(k, delta_cap(index))
        dv, drows, di, live = _delta_scan(index, q, kk)
        mv, mi = _merge_ordered(v, i, dv, drows, di, k)
        return mv, mi, stats._replace(list_dists=stats.list_dists + live)

    def _merge_one(self, index, q, v, i, stats, k):
        mv, mi, st = self._merge_batch(
            index, q[None], v[None], i[None],
            _tl.TurnStats(*(a[None] for a in stats)), k)
        return mv[0], mi[0], _tl.TurnStats(*(a[0] for a in st))

    # ---- driver surface ---------------------------------------------------

    def start(self, index, q0, *, k):
        v, i, sess, st = self.inner.start(index.base, q0, k=k)
        mv, mi, st = self._merge_one(index, q0, v, i, st, k)
        return mv, mi, sess, st

    def step(self, index, sess, q, *, k):
        v, i, sess, st = self.inner.step(index.base, sess, q, k=k)
        mv, mi, st = self._merge_one(index, q, v, i, st, k)
        return mv, mi, sess, st

    def start_batch(self, index, q0, *, k):
        v, i, sess, st = self.inner.start_batch(index.base, q0, k=k)
        mv, mi, st = self._merge_batch(index, q0, v, i, st, k)
        return mv, mi, sess, st

    def step_batch(self, index, sess, q, *, k, is_first=None):
        v, i, sess, st = self.inner.step_batch(index.base, sess, q, k=k,
                                               is_first=is_first)
        mv, mi, st = self._merge_batch(index, q, v, i, st, k)
        return mv, mi, sess, st

    def plain_batch(self, index, q, *, k):
        v, i, st = self.inner.plain_batch(index.base, q, k=k)
        return self._merge_batch(index, q, v, i, st, k)

    def session_template(self, index):
        return self.inner.session_template(index.base)

    def corpus_vectors(self, index):
        base = self.inner.corpus_vectors(index.base)
        if base is None:
            return None
        # delta row j holds global id n_base + j, so plain concatenation
        # keeps the id -> row mapping the result cache gathers by
        return torch.cat([base, index.delta_vecs], 0)

    def query_dim(self, index) -> int:
        return self.inner.query_dim(index.base)

    def fetch_limit(self, index) -> int:
        return self.inner.fetch_limit(index.base)


# ---------------------------------------------------------------------------
# per-inner-backend compaction adapters (on the index's device)
# ---------------------------------------------------------------------------


def nearest_centroids(centroids: torch.Tensor, vecs: torch.Tensor
                      ) -> torch.Tensor:
    """Frozen-quantiser assignment, (n,) int64: the first maximum of
    ``centroids @ v`` per row, one matrix–vector product a row, so a
    doc's list does not depend on the docs beside it."""
    if vecs.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int64, device=vecs.device)
    return _kref.gemv_rows(centroids, vecs).argmax(1)


def encode_rows(book: _pq.PQCodebook, vecs: torch.Tensor) -> torch.Tensor:
    """PQ codes (n, m) uint8 with the frozen codebook, one
    ``pq.encode`` call a row, so a doc's code does not depend on the
    docs beside it (a batched encode picks its product's reduction by
    shape)."""
    out = torch.empty((vecs.shape[0], book.codewords.shape[0]),
                      dtype=torch.uint8, device=vecs.device)
    for j in range(vecs.shape[0]):
        out[j] = _pq.encode(book, vecs[j:j + 1])[0]
    return out


def _live_delta(delta_vecs, delta_ids, tomb):
    """(ids (n,) int32, vectors (n, d)) of the live delta docs, in id
    (= append) order."""
    rows = torch.nonzero((delta_ids >= 0)
                         & ~tomb[delta_ids.clamp_min(0).long()])[:, 0]
    return delta_ids[rows], delta_vecs[rows]


def _masked_lists(list_ids: torch.Tensor, tomb: torch.Tensor):
    """Tombstoned posting-list entries flipped to the -1 pad convention,
    and the lists' new sizes."""
    dead = (list_ids >= 0) & tomb[list_ids.clamp_min(0).long()]
    ids = torch.where(dead, -1, list_ids).to(torch.int32)
    return ids, (ids >= 0).sum(1).to(torch.int32)


def _repack(list_ids, payload, new_ids, new_lists, new_payload,
            chunk=_kmeans.CHUNK):
    """Posting lists with their holes squeezed out and new entries
    appended.

    ``list_ids`` (p, L) with -1 holes and pads, ``payload`` (p, L, ...)
    its rows; ``new_ids`` (n,) in id order, going to lists ``new_lists``
    (n,) with payload rows ``new_payload`` (n, ...).  A survivor keeps
    its order (its slot is its rank among its list's live rows); a new
    entry lands after its list's survivors, in id order.  Lmax is the
    largest list (at least 1).  Payload rows are copied, never
    recomputed.  Returns (ids (p, Lmax') int32, payload, sizes (p,)
    int32).
    """
    p, L = list_ids.shape
    dev = list_ids.device
    live = list_ids >= 0
    surv = live.sum(1)
    counts = torch.bincount(new_lists, minlength=p)
    sizes = surv + counts
    lmax = max(1, int(sizes.max())) if p else 1
    # survivors: flat source slot -> flat destination slot
    src = torch.nonzero(live.view(-1))[:, 0]
    dst = (src // L) * lmax + (live.cumsum(1) - 1).view(-1)[src]
    # new entries: a stable sort by list keeps id order within a list
    order = torch.sort(new_lists, stable=True).indices
    lists_sorted = new_lists[order]
    rank = torch.arange(order.shape[0], device=dev) - \
        (torch.cumsum(counts, 0) - counts)[lists_sorted]
    new_dst = torch.empty_like(order)
    new_dst[order] = lists_sorted * lmax + surv[lists_sorted] + rank
    ids = torch.full((p * lmax,), -1, dtype=torch.int32, device=dev)
    ids[dst] = list_ids.reshape(-1)[src]
    ids[new_dst] = new_ids.to(torch.int32)
    rows = payload.shape[2:]
    out = torch.zeros((p * lmax,) + rows, dtype=payload.dtype, device=dev)
    flat = payload.reshape((p * L,) + rows)
    for s in range(0, src.shape[0], chunk):
        out[dst[s:s + chunk]] = flat[src[s:s + chunk]]
    out[new_dst] = new_payload.to(payload.dtype)
    return (ids.view(p, lmax), out.view((p, lmax) + rows),
            sizes.to(torch.int32))


class _IVFAdapter:
    """IVF: delete = -1 masking of the posting lists; compact = purge +
    append at the nearest frozen centroid, re-packed on the device."""

    def size(self, base) -> int:
        return int(base.list_sizes.sum())

    def delete(self, base, tomb_base: torch.Tensor):
        ids, sizes = _masked_lists(base.list_ids, tomb_base)
        return base._replace(list_ids=ids, list_sizes=sizes)

    def _delta_payload(self, base, vecs):
        return vecs

    def _repacked(self, base, payload, delta_vecs, delta_ids, tomb):
        ids, vecs = _live_delta(delta_vecs, delta_ids, tomb)
        return _repack(base.list_ids, payload, ids,
                       nearest_centroids(base.centroids, vecs),
                       self._delta_payload(base, vecs))

    def compact(self, base, delta_vecs, delta_ids, tomb):
        ids, vecs, sizes = self._repacked(base, base.list_vecs, delta_vecs,
                                          delta_ids, tomb)
        return _ivf.IVFIndex(base.centroids, vecs, ids, sizes)

    def rebuild(self, pristine, added_vecs, tomb):
        n0 = self.size(pristine)
        added_ids = torch.arange(n0, n0 + added_vecs.shape[0],
                                 dtype=torch.int32, device=tomb.device)
        return self.compact(self.delete(pristine, tomb[:n0]),
                            added_vecs, added_ids, tomb)


class _PQAdapter(_IVFAdapter):
    """IVF-PQ: the same list machinery over uint8 code rows; delta docs
    are encoded with the frozen codebook; ``doc_vecs`` grows by every
    added row (dead rows stay: ids index it directly)."""

    def size(self, base) -> int:
        return base.doc_vecs.shape[0]

    def _delta_payload(self, base, vecs):
        return encode_rows(base.book, vecs)

    def compact(self, base, delta_vecs, delta_ids, tomb):
        ids, codes, sizes = self._repacked(base, base.list_codes,
                                           delta_vecs, delta_ids, tomb)
        fill = int((delta_ids >= 0).sum())
        doc_vecs = torch.cat([base.doc_vecs, delta_vecs[:fill]], 0)
        return _pq.IVFPQIndex(base.centroids, base.codewords, codes, ids,
                              sizes, doc_vecs)


class _HNSWAdapter:
    """HNSW: delete = result mask only (nodes keep routing the beam);
    compact = incremental insertion continuing the build's level stream,
    so the compacted graph is the from-scratch graph."""

    def __init__(self, ef_construction: int = 64, seed: int = 0):
        self.ef_construction = ef_construction
        self.seed = seed

    def size(self, base) -> int:
        return base.vectors.shape[0]

    def delete(self, base, tomb_base: torch.Tensor):
        return base._replace(deleted=tomb_base.clone())

    def compact(self, base, delta_vecs, delta_ids, tomb):
        fill = int((delta_ids >= 0).sum())
        # every added doc joins the graph, deleted ones included: the
        # from-scratch build inserts the whole corpus, and deletions are
        # a query-time mask, not a graph edit
        new = _hnsw.insert(base, delta_vecs[:fill],
                           ef_construction=self.ef_construction,
                           seed=self.seed)
        return new._replace(deleted=tomb[:new.n].clone())

    def rebuild(self, pristine, added_vecs, tomb):
        x = torch.cat([pristine.vectors, added_vecs], 0)
        idx = _hnsw.build(x, m=pristine.adj0.shape[1] // 2,
                          ef_construction=self.ef_construction,
                          seed=self.seed, device=x.device)
        return idx._replace(deleted=tomb[:idx.n].clone())


def _adapter(inner: RetrievalBackend, **build_kw):
    name = type(inner).name
    makers: Dict[str, Any] = {
        "ivf": _IVFAdapter,
        "ivf_pq": _PQAdapter,
        "hnsw": _HNSWAdapter,
    }
    if name not in makers:
        raise NotImplementedError(
            f"segmented corpus does not support inner backend {name!r}; "
            f"supported: {', '.join(sorted(makers))}")
    if name != "hnsw" and build_kw:
        raise TypeError(
            f"build kwargs {sorted(build_kw)} only apply to hnsw "
            f"compaction (got inner backend {name!r})")
    return makers[name](**build_kw)


def _vectors(x, d: int, dev: torch.device) -> torch.Tensor:
    """Documents as a (n, d) float32 tensor on ``dev`` (numpy or tensor
    in; a 1-D row is one document)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(dev, torch.float32)
    else:
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    return x.reshape(-1, d)


def _host_ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(ids, np.int64))


# ---------------------------------------------------------------------------
# public mutation API (returns new tensors, never writes into the index)
# ---------------------------------------------------------------------------


def make_segmented(inner: RetrievalBackend, base_index, *, cap: int
                   ) -> SegmentedIndex:
    """Wrap a built base index with an empty ``cap``-row delta segment
    on the base's device."""
    if cap < 1:
        raise ValueError(f"segment cap must be >= 1, got {cap}")
    ad = _adapter(inner)
    n0 = ad.size(base_index)
    d = inner.query_dim(base_index)
    dev = _tl.index_tensor(base_index).device
    return SegmentedIndex(
        base=base_index,
        delta_vecs=torch.zeros((cap, d), dtype=torch.float32, device=dev),
        delta_ids=torch.full((cap,), -1, dtype=torch.int32, device=dev),
        tombstone=torch.zeros((n0 + cap,), dtype=torch.bool, device=dev))


def add_documents(index: SegmentedIndex, vectors
                  ) -> Tuple[SegmentedIndex, np.ndarray]:
    """Append documents to the delta segment.  Returns (index', ids):
    ids are assigned in order (``n_base + row``), so replicas that apply
    the same adds agree."""
    vecs = _vectors(vectors, index.delta_vecs.shape[1],
                    index.delta_vecs.device)
    fill, cap = delta_fill(index), delta_cap(index)
    b = vecs.shape[0]
    if fill + b > cap:
        raise ValueError(
            f"delta segment overflow: {fill} + {b} > cap {cap}; "
            f"compact() first")
    n0 = n_base(index)
    ids = np.arange(n0 + fill, n0 + fill + b, dtype=np.int32)
    dv = torch.cat([index.delta_vecs[:fill], vecs,
                    index.delta_vecs[fill + b:]], 0)
    di = torch.cat([index.delta_ids[:fill],
                    torch.from_numpy(ids).to(index.delta_ids.device),
                    index.delta_ids[fill + b:]], 0)
    return index._replace(delta_vecs=dv, delta_ids=di), ids


def delete_documents(inner: RetrievalBackend, index: SegmentedIndex,
                     ids) -> SegmentedIndex:
    """Tombstone documents by global id (base or delta; idempotent)."""
    ids = _host_ids(ids)
    n0, fill = n_base(index), delta_fill(index)
    bad = ids[(ids < 0) | (ids >= n0 + fill)]
    if bad.size:
        raise ValueError(
            f"delete of unassigned doc id(s) {bad.tolist()} "
            f"(assigned id space: 0..{n0 + fill - 1})")
    tomb = index.tombstone.clone()
    tomb[torch.from_numpy(ids).to(tomb.device)] = True
    new_base = _adapter(inner).delete(index.base, tomb[:n0])
    return index._replace(base=new_base, tombstone=tomb)


def compact(inner: RetrievalBackend, index: SegmentedIndex,
            **build_kw) -> SegmentedIndex:
    """Fold the delta segment into the base and empty it.

    ``build_kw`` (hnsw only): ``ef_construction`` / ``seed`` must match
    the original ``hnsw.build`` call for the insertion to continue its
    level stream (``hnsw.insert`` checks and raises).  The result equals
    ``rebuild`` tensor for tensor; dead ids stay tombstoned (ids are
    never reused), the delta resets to empty, and shapes change only
    here.
    """
    ad = _adapter(inner, **build_kw)
    tomb = index.tombstone
    new_base = ad.compact(index.base, index.delta_vecs, index.delta_ids,
                          tomb)
    n_new = n_base(index) + delta_fill(index)
    cap = delta_cap(index)
    return SegmentedIndex(
        base=new_base,
        delta_vecs=torch.zeros_like(index.delta_vecs),
        delta_ids=torch.full_like(index.delta_ids, -1),
        tombstone=torch.cat([tomb[:n_new], torch.zeros(
            (cap,), dtype=torch.bool, device=tomb.device)]))


def rebuild(inner: RetrievalBackend, pristine_base, added_vecs,
            deleted_ids, *, cap: int, **build_kw) -> SegmentedIndex:
    """From-scratch construction — the compaction oracle.

    Given the pre-mutation base index, the whole add history (in id
    order) and the set of deleted ids, derive the final segmented index
    directly (HNSW: ``hnsw.build`` over the concatenated corpus).
    ``compact`` after any add / delete / compact sequence with the same
    net history equals it.
    """
    ad = _adapter(inner, **build_kw)
    dev = _tl.index_tensor(pristine_base).device
    d = int(inner.query_dim(pristine_base))
    added = _vectors(added_vecs, d, dev)
    n_new = ad.size(pristine_base) + added.shape[0]
    tomb = torch.zeros((n_new + cap,), dtype=torch.bool, device=dev)
    dead = _host_ids(deleted_ids)
    if dead.size:
        tomb[torch.from_numpy(dead).to(dev)] = True
    return SegmentedIndex(
        base=ad.rebuild(pristine_base, added, tomb),
        delta_vecs=torch.zeros((cap, d), dtype=torch.float32, device=dev),
        delta_ids=torch.full((cap,), -1, dtype=torch.int32, device=dev),
        tombstone=tomb)
