"""RetrievalBackend registry — the port's seam for ANN backends.

Port of ``repro/core/backend.py``.  A backend is a frozen dataclass
holding its knobs (h, nprobe, alpha, ef, …); the index is an argument.
``register`` / ``get`` / ``make`` behave as the reference's (strict and
lenient knob checking).  Registered: ``"ivf"``, ``"ivf_pq"``,
``"hnsw"`` (TopLoc_HNSW over ``core.hnsw``) and ``"exact"`` (stateless
brute force over the bare corpus).

The Eq. 1 session machinery is written once (``_ivf_family_*``) and
parameterised by ``list_scan``: float lists and PQ lists differ only
there.  Where the reference gates work with ``lax.cond`` on a traced
predicate, the port syncs the predicate to the host (``if
bool(...)``): the IVF refresh (one host sync per follow-up turn when
TopLoc_IVF+ is on, one a batched wave) and the HNSW batch's first-turn
search (one a batched wave).
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import hnsw as _hnsw
from repro_torch.core import ivf as _ivf
from repro_torch.core import toploc as _tl
from repro_torch.core.topk import intersect_count, topk
from repro_torch.kernels import ref as _kref

# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type["RetrievalBackend"]] = {}


def register(cls: Type["RetrievalBackend"]) -> Type["RetrievalBackend"]:
    """Class decorator: make ``cls`` resolvable by ``get``/``make``."""
    _REGISTRY[cls.name] = cls
    return cls


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> Type["RetrievalBackend"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown retrieval backend {name!r}; registered: "
            f"{', '.join(names())}") from None


def _knob_fields(cls: Type["RetrievalBackend"]) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def make(name: str, *, strict: bool = False,
         **knobs: Any) -> "RetrievalBackend":
    """Build a backend from a flat knob mapping; knobs the backend does
    not declare are ignored unless ``strict``, but a knob that no
    registered backend declares raises (a typo, not a cross-backend
    knob)."""
    cls = get(name)
    fields = _knob_fields(cls)
    if strict:
        unknown = sorted(set(knobs) - fields)
        if unknown:
            raise TypeError(
                f"make({name!r}, strict=True): unknown knob(s) "
                f"{', '.join(unknown)}; {cls.__name__} declares "
                f"{', '.join(sorted(fields))}")
        return cls(**knobs)
    union = set().union(*(_knob_fields(c) for c in _REGISTRY.values()))
    unknown = sorted(set(knobs) - union)
    if unknown:
        raise TypeError(
            f"make({name!r}): knob(s) {', '.join(unknown)} match no "
            f"registered backend's fields (likely a typo); known knobs: "
            f"{', '.join(sorted(union))}")
    return cls(**{k: v for k, v in knobs.items() if k in fields})


# ---------------------------------------------------------------------------
# shared IVF-family implementation
#
# ``list_scan(index, q (B,d), sel (B,np), k)`` -> (top_v (B,k),
# top_i (B,k), list_dists (B,), code_dists (B,)).
# ---------------------------------------------------------------------------


def _i32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=dev)


def _full(b: int, x, dev, dtype=torch.int32) -> torch.Tensor:
    return torch.full((b,), x, dtype=dtype, device=dev)


def _refresh_threshold(alpha: float, nprobe: int) -> float:
    # the reference compares |I0| with jnp.asarray(alpha * nprobe), a
    # float32: round the same way so an integer-adjacent product
    # (e.g. 0.1 * 30) refreshes on the same turns
    return float(np.float32(alpha * nprobe))


def _ivf_family_start(index, q0, *, h, nprobe, k, list_scan):
    """First utterance: full centroid scan, C0 = top_h(q0, C), answer."""
    dev = q0.device
    cache_ids, cache_vecs = _ivf.make_cache(index, q0, h=h)
    # top_np(q0, C0) == top_np(q0, C): C0 holds q0's h best centroids
    anchor_sel = cache_ids[:nprobe]
    top_v, top_i, list_d, code_d = list_scan(index, q0[None],
                                             anchor_sel[None], k)
    sess = _tl.IVFSession(cache_ids, cache_vecs, anchor_sel, _i32(0, dev),
                          _i32(1, dev))
    stats = _tl.TurnStats(
        centroid_dists=_i32(index.p, dev), list_dists=list_d[0],
        graph_dists=_i32(0, dev), code_dists=code_d[0],
        i0=_i32(-1, dev), refreshed=torch.tensor(True, device=dev))
    return top_v[0], top_i[0], sess, stats


def _ivf_family_step(index, sess, q, *, nprobe, k, alpha, list_scan):
    """Follow-up utterance: cached centroid selection, Eq. 1 drift check
    (``alpha < 0`` static cache, ``alpha >= 0`` refresh), one list scan.
    A refreshed turn pays (h + p) centroid distances but one scan."""
    dev = q.device
    h = sess.cache_ids.shape[0]
    # 1. centroid selection against the cached set C0  (cost: h)
    _, sel_local = topk(sess.cache_vecs @ q, nprobe)
    sel_cached = sess.cache_ids[sel_local]
    # 2. drift proxy |I0| = |top_np(qj, C0) ∩ top_np(q0, C0)|   (Eq. 1)
    i0 = intersect_count(sel_cached, sess.anchor_sel)
    need_refresh = alpha >= 0.0 and bool(
        i0 < _refresh_threshold(alpha, nprobe))
    # 3. optional refresh: rescan the full centroid set, re-anchor on qj
    if need_refresh:
        cache_ids, cache_vecs = _ivf.make_cache(index, q, h=h)
        anchor_sel = sel = cache_ids[:nprobe]
    else:
        cache_ids, cache_vecs = sess.cache_ids, sess.cache_vecs
        anchor_sel, sel = sess.anchor_sel, sel_cached
    # 4. one posting-list scan with the final selection
    top_v, top_i, list_d, code_d = list_scan(index, q[None], sel[None], k)
    new_sess = _tl.IVFSession(cache_ids, cache_vecs, anchor_sel,
                              sess.refreshes + int(need_refresh),
                              sess.turn + 1)
    stats = _tl.TurnStats(
        centroid_dists=_i32(h + int(need_refresh) * index.p, dev),
        list_dists=list_d[0], graph_dists=_i32(0, dev),
        code_dists=code_d[0], i0=i0,
        refreshed=torch.tensor(need_refresh, device=dev))
    return top_v[0], top_i[0], new_sess, stats


def _ivf_family_start_batch(index, q0, *, h, nprobe, k, list_scan):
    """Batched first utterances."""
    b, dev = q0.shape[0], q0.device
    cache_ids, cache_vecs = _tl.make_cache_batch(index, q0, h=h)
    anchor_sel = cache_ids[:, :nprobe]
    top_v, top_i, list_d, code_d = list_scan(index, q0, anchor_sel, k)
    sess = _tl.IVFSession(cache_ids, cache_vecs, anchor_sel,
                          _full(b, 0, dev), _full(b, 1, dev))
    stats = _tl.TurnStats(
        centroid_dists=_full(b, index.p, dev), list_dists=list_d,
        graph_dists=_full(b, 0, dev), code_dists=code_d,
        i0=_full(b, -1, dev), refreshed=_full(b, True, dev, torch.bool))
    return top_v, top_i, sess, stats


def _ivf_family_step_batch(index, sess, q, *, nprobe, k, alpha, is_first,
                           list_scan):
    """Batched follow-ups over B concurrent conversations.

    ``is_first`` rows ignore the slot contents, pay a full centroid scan
    and re-anchor (first-turn semantics as a forced refresh).  Per-row
    logic is select-only; the refresh scan runs only when some row of
    the batch needs it (one host sync).
    """
    b, h = sess.cache_ids.shape
    dev = q.device
    _, sel_local = topk(_kref.gemv_rows(sess.cache_vecs, q), nprobe)
    sel_cached = sess.cache_ids.gather(1, sel_local)
    i0 = intersect_count(sel_cached, sess.anchor_sel)
    drift = (i0 < _refresh_threshold(alpha, nprobe)) if alpha >= 0.0 \
        else torch.zeros(b, dtype=torch.bool, device=dev)
    first = (torch.zeros(b, dtype=torch.bool, device=dev)
             if is_first is None else is_first.to(torch.bool))
    refresh = first | drift

    cache_ids, cache_vecs = sess.cache_ids, sess.cache_vecs
    anchor_sel, sel = sess.anchor_sel, sel_cached
    if (is_first is not None or alpha >= 0.0) and bool(refresh.any()):
        fresh_ids, fresh_vecs = _tl.make_cache_batch(index, q, h=h)
        r1 = refresh[:, None]
        cache_ids = torch.where(r1, fresh_ids, cache_ids)
        cache_vecs = torch.where(r1[..., None], fresh_vecs, cache_vecs)
        anchor_sel = torch.where(r1, fresh_ids[:, :nprobe], anchor_sel)
        sel = torch.where(r1, fresh_ids[:, :nprobe], sel)

    top_v, top_i, list_d, code_d = list_scan(index, q, sel, k)

    step_refresh = (drift & ~first).to(torch.int32)  # first turns don't count
    new_sess = _tl.IVFSession(
        cache_ids, cache_vecs, anchor_sel,
        torch.where(first, 0, sess.refreshes + step_refresh).to(torch.int32),
        torch.where(first, 1, sess.turn + 1).to(torch.int32))
    stats = _tl.TurnStats(
        centroid_dists=torch.where(first, index.p,
                                   h + step_refresh * index.p
                                   ).to(torch.int32),
        list_dists=list_d, graph_dists=_full(b, 0, dev), code_dists=code_d,
        i0=torch.where(first, -1, i0).to(torch.int32), refreshed=refresh)
    return top_v, top_i, new_sess, stats


def _ivf_family_plain_batch(index, q, *, nprobe, k, list_scan):
    """Stateless baseline turn: full centroid scan, one list scan."""
    b, dev = q.shape[0], q.device
    _, sel = topk(_tl._bcast_centroid_scores(index.centroids, q), nprobe)
    top_v, top_i, list_d, code_d = list_scan(index, q, sel, k)
    stats = _tl.TurnStats(
        centroid_dists=_full(b, index.p, dev), list_dists=list_d,
        graph_dists=_full(b, 0, dev), code_dists=code_d,
        i0=_full(b, -1, dev), refreshed=_full(b, False, dev, torch.bool))
    return top_v, top_i, stats


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class RetrievalBackend:
    """Shared glue for registered backends.  Subclasses are frozen
    dataclasses exposing ``start / step / plain_batch / start_batch /
    step_batch`` as in the reference, and the hooks the session store
    and the result cache read (``session_template``, ``corpus_vectors``,
    ``query_dim``, ``fetch_limit``)."""

    name: ClassVar[str] = "?"
    index_kwarg: ClassVar[str] = "?"       # engine kwarg holding the index
    stateful: ClassVar[bool] = True        # has per-conversation sessions

    def plain(self, index, q, *, k):
        """Single-query plain turn: B=1 through the batch-size-stable
        batched path."""
        v, i, st = self.plain_batch(index, q[None], k=k)
        return v[0], i[0], _tl.TurnStats(*(x[0] for x in st))

    def session_template(self, index) -> Optional[Any]:
        """One session's state, zeroed (no leading batch dim): the layout
        of the session store's slab.  None for stateless backends."""
        return None

    def corpus_vectors(self, index) -> Optional[torch.Tensor]:
        """The flat (n, d) corpus the result cache re-scores against, if
        the index keeps one."""
        return None

    def query_dim(self, index) -> int:
        """Embedding dimensionality queries against ``index`` must have."""
        raise NotImplementedError

    def fetch_limit(self, index) -> int:
        """Largest per-query result depth a turn can request while
        running the *same* turn a plain k-request would (same candidate
        pool, so the top-k prefix is unchanged).  The result cache
        clamps its over-fetch depth to this."""
        raise NotImplementedError


@register
@dataclasses.dataclass(frozen=True)
class IVFBackend(RetrievalBackend):
    """TopLoc_IVF / TopLoc_IVF+ over float posting lists.

    ``alpha < 0`` → static centroid cache (TopLoc_IVF); ``alpha >= 0`` →
    Eq. 1 refresh at ``|I0| < alpha·nprobe`` (TopLoc_IVF+).  ``fused``
    (a ``toploc.FusedTurn``) routes the scan — and, on the stateless
    path, the whole turn — through the fused CUDA kernels.
    """

    name: ClassVar[str] = "ivf"
    index_kwarg: ClassVar[str] = "ivf_index"

    h: int = 1024
    nprobe: int = 64
    alpha: float = -1.0
    fused: Any = None

    def _list_scan(self, index, q, sel, k):
        if self.fused is not None:
            v, i, real = self.fused.list_scan_ivf(index, q, sel, k)
        else:
            v, i, real = _ivf._scan_lists(index, q, sel, k)
        return v, i, real, torch.zeros_like(real)

    def start(self, index, q0, *, k):
        return _ivf_family_start(index, q0, h=self.h, nprobe=self.nprobe,
                                 k=k, list_scan=self._list_scan)

    def step(self, index, sess, q, *, k):
        return _ivf_family_step(index, sess, q, nprobe=self.nprobe, k=k,
                                alpha=self.alpha, list_scan=self._list_scan)

    def start_batch(self, index, q0, *, k):
        return _ivf_family_start_batch(index, q0, h=self.h,
                                       nprobe=self.nprobe, k=k,
                                       list_scan=self._list_scan)

    def step_batch(self, index, sess, q, *, k, is_first=None):
        return _ivf_family_step_batch(index, sess, q, nprobe=self.nprobe,
                                      k=k, alpha=self.alpha,
                                      is_first=is_first,
                                      list_scan=self._list_scan)

    def plain_batch(self, index, q, *, k):
        if self.fused is not None:
            # whole turn in the fused kernels: centroid scoring, probe
            # selection and list scan/merge
            b, dev = q.shape[0], q.device
            v, i, _sel, real = self.fused.turn_ivf(index, q,
                                                   nprobe=self.nprobe, k=k)
            stats = _tl.TurnStats(
                centroid_dists=_full(b, index.p, dev), list_dists=real,
                graph_dists=_full(b, 0, dev), code_dists=_full(b, 0, dev),
                i0=_full(b, -1, dev),
                refreshed=_full(b, False, dev, torch.bool))
            return v, i, stats
        return _ivf_family_plain_batch(index, q, nprobe=self.nprobe, k=k,
                                       list_scan=self._list_scan)

    def session_template(self, index):
        dev = index.centroids.device
        return _tl.IVFSession(
            cache_ids=torch.zeros((self.h,), dtype=torch.int32, device=dev),
            cache_vecs=torch.zeros((self.h, index.d),
                                   dtype=index.centroids.dtype, device=dev),
            anchor_sel=torch.zeros((self.nprobe,), dtype=torch.int32,
                                   device=dev),
            refreshes=torch.zeros((), dtype=torch.int32, device=dev),
            turn=torch.zeros((), dtype=torch.int32, device=dev))

    def query_dim(self, index) -> int:
        return index.d

    def fetch_limit(self, index) -> int:
        # the float scan's candidate pool: every slot of every probed list
        return self.nprobe * index.lmax


@register
@dataclasses.dataclass(frozen=True)
class IVFPQBackend(IVFBackend):
    """TopLoc_IVFPQ: the same session machinery over PQ-compressed lists.

    Lists are ADC-scanned (``kernels.ops.pq_adc_scan``, or
    ``fused_scan_pq`` / ``fused_turn_pq`` through ``fused``) and the top
    ``R = max(k, min(rerank, nprobe·Lmax))`` candidates exact-re-ranked
    against the float corpus; ``list_dists`` counts the R re-rank dots,
    ``code_dists`` the ADC table sums.
    """

    name: ClassVar[str] = "ivf_pq"
    index_kwarg: ClassVar[str] = "ivf_pq_index"

    rerank: int = 64

    def _list_scan(self, index, q, sel, k):
        if self.fused is not None:
            v, i, code_d, rerank_d = self.fused.list_scan_pq(
                index, q, sel, k, self.rerank)
        else:
            v, i, code_d, rerank_d = _tl._scan_lists_pq(index, q, sel, k,
                                                        self.rerank)
        return v, i, rerank_d, code_d

    def plain_batch(self, index, q, *, k):
        if self.fused is not None:
            # whole turn in the fused kernels: centroid scoring, probe
            # selection, ADC scan/merge and exact re-rank
            b, dev = q.shape[0], q.device
            v, i, _sel, code_d, rerank_d = self.fused.turn_pq(
                index, q, nprobe=self.nprobe, k=k, rerank=self.rerank)
            stats = _tl.TurnStats(
                centroid_dists=_full(b, index.p, dev), list_dists=rerank_d,
                graph_dists=_full(b, 0, dev), code_dists=code_d,
                i0=_full(b, -1, dev),
                refreshed=_full(b, False, dev, torch.bool))
            return v, i, stats
        return _ivf_family_plain_batch(index, q, nprobe=self.nprobe, k=k,
                                       list_scan=self._list_scan)

    def corpus_vectors(self, index):
        return index.doc_vecs

    def fetch_limit(self, index) -> int:
        # asking for k beyond this would widen the exact re-rank pool
        # (``r = max(k, min(rerank, np·Lmax))`` in ``_scan_lists_pq``),
        # changing which candidates the top-k is drawn from
        return min(self.rerank, self.nprobe * index.lmax)


@register
@dataclasses.dataclass(frozen=True)
class HNSWBackend(RetrievalBackend):
    """TopLoc_HNSW: privileged entry point, first-turn ef upscaling.

    The first turn searches from the global entry point with a beam of
    ``up·ef`` and keeps its top-1 as the conversation's entry point;
    follow-ups start the level-0 beam of ``ef`` there, skipping the
    descent.  ``adaptive=True`` (beyond the paper) re-anchors the entry
    point at every turn's top-1.  ``search`` optionally replaces
    ``hnsw.search`` (a sharded search, ROADMAP Queue 1, item 6).
    """

    name: ClassVar[str] = "hnsw"
    index_kwarg: ClassVar[str] = "hnsw_index"

    ef: int = 64
    up: int = 2
    adaptive: bool = False
    search: Any = None

    def _search(self):
        return self.search or _hnsw.search

    @staticmethod
    def _stats(nd, first) -> _tl.TurnStats:
        b, dev = nd.shape[0], nd.device
        z = _full(b, 0, dev)
        return _tl.TurnStats(z, z, nd, z, _full(b, -1, dev), first)

    def start(self, index, q0, *, k):
        dev = q0.device
        v, i, nd = self._search()(index, q0[None], ef=self.up * self.ef,
                                  k=k)
        sess = _tl.HNSWSession(entry_point=i[0, 0].to(torch.int32),
                               turn=_i32(1, dev))
        stats = _tl._zero_stats(dev)._replace(
            graph_dists=nd[0], refreshed=torch.tensor(True, device=dev))
        return v[0], i[0], sess, stats

    def step(self, index, sess, q, *, k):
        v, i, nd = self._search()(
            index, q[None], ef=self.ef, k=k,
            entry_override=sess.entry_point[None], use_entry_override=True)
        new_entry = (i[0, 0].to(torch.int32) if self.adaptive
                     else sess.entry_point)
        sess = _tl.HNSWSession(entry_point=new_entry, turn=sess.turn + 1)
        stats = _tl._zero_stats(q.device)._replace(graph_dists=nd[0])
        return v[0], i[0], sess, stats

    def start_batch(self, index, q0, *, k):
        b, dev = q0.shape[0], q0.device
        v, i, nd = self._search()(index, q0, ef=self.up * self.ef, k=k)
        sess = _tl.HNSWSession(entry_point=i[:, 0].to(torch.int32),
                               turn=_full(b, 1, dev))
        return v, i, sess, self._stats(nd, _full(b, True, dev, torch.bool))

    def step_batch(self, index, sess, q, *, k, is_first=None):
        b, dev = q.shape[0], q.device
        do_search = self._search()
        v, i, nd = do_search(index, q, ef=self.ef, k=k,
                             entry_override=sess.entry_point,
                             use_entry_override=True)
        first = (_full(b, False, dev, torch.bool) if is_first is None
                 else is_first.to(torch.bool))
        # batch-wide gate (one host sync): waves with no first turn skip
        # the full-descent upscaled search
        if is_first is not None and bool(first.any()):
            v0, i_0, nd0 = do_search(index, q, ef=self.up * self.ef, k=k)
            f1 = first[:, None]
            v = torch.where(f1, v0, v)
            i = torch.where(f1, i_0, i)
            nd = torch.where(first, nd0, nd)
        top1 = i[:, 0].to(torch.int32)
        new_entry = top1 if self.adaptive else torch.where(
            first, top1, sess.entry_point)
        new_sess = _tl.HNSWSession(
            entry_point=new_entry,
            turn=torch.where(first, 1, sess.turn + 1).to(torch.int32))
        return v, i, new_sess, self._stats(nd, first)

    def plain_batch(self, index, q, *, k):
        b, dev = q.shape[0], q.device
        v, i, nd = self._search()(index, q, ef=self.ef, k=k)
        return v, i, self._stats(nd, _full(b, False, dev, torch.bool))

    def session_template(self, index):
        dev = index.vectors.device
        return _tl.HNSWSession(
            entry_point=torch.zeros((), dtype=torch.int32, device=dev),
            turn=torch.zeros((), dtype=torch.int32, device=dev))

    def corpus_vectors(self, index):
        return index.vectors

    def query_dim(self, index) -> int:
        return index.vectors.shape[1]

    def fetch_limit(self, index) -> int:
        # the level-0 beam holds ef candidates; a top-k beyond that is
        # unsatisfiable (first turns search wider at up·ef, but every
        # follow-up is capped at ef)
        return self.ef


@register
@dataclasses.dataclass(frozen=True)
class ExactBackend(RetrievalBackend):
    """Brute-force top-k over the full collection (the paper's 'Exact'
    row, ``ivf.exact_search``).  Stateless: the engines route every
    strategy through ``plain``; its index is the bare ``(n, d)`` corpus
    tensor."""

    name: ClassVar[str] = "exact"
    index_kwarg: ClassVar[str] = "doc_vecs"
    stateful: ClassVar[bool] = False

    def plain_batch(self, index, q, *, k):
        b, dev = q.shape[0], q.device
        v, i = _ivf.exact_search(index, q, k)
        z = _full(b, 0, dev)
        stats = _tl.TurnStats(z, z, z, z, _full(b, -1, dev),
                              _full(b, False, dev, torch.bool))
        return v, i, stats

    def corpus_vectors(self, index):
        return index

    def query_dim(self, index) -> int:
        return index.shape[1]

    def fetch_limit(self, index) -> int:
        return index.shape[0]
