"""Session-level historical-embedding result cache.

Port of ``repro/serving/result_cache.py`` (Frieder et al., *Caching
Historical Embeddings in Conversational Search*): within a
conversation, consecutive utterances are near-duplicates in embedding
space, so the documents retrieved for turn j-1 usually contain the
answer for turn j.  This module caches, per session, the previous
answering turn:

    q_vec      (d,)    — the query embedding the entry is anchored to
    doc_ids    (k,)    — the turn's top-k document ids (-1 = empty)
    doc_scores (k,)    — their scores under ``q_vec``
    doc_vecs   (k, d)  — the *historical embeddings* of those documents
    valid      ()      — entry holds real state

A new turn first probes the cache: when ``cos(q_new, q_vec) >=
threshold`` the turn is answered **without touching the backend** by
re-scoring the cached document embeddings under the new query (or, when
the backend keeps no flat corpus, by replaying the cached ranking);
otherwise the backend runs and the entry is refreshed with the new
turn's results.  ``threshold <= 0`` disables the cache entirely — the
engines then run the exact uncached turn, bit for bit.

Batch-size stability.  A CUDA reduction picks its block shape by the
number of outputs, so ``sum(-1)`` over (1, d) and over (B, d) add in
different orders and the bits of a row would drift with B.  ``probe``
therefore always reduces ``PROBE_ROWS`` rows at once: a batch is cut
into chunks of ``PROBE_ROWS``, the last one padded with zero rows, so
the sequential engine (B = 1) and the batched engine (a whole wave)
run the same reductions on every row.  The top-k is ``core.topk.topk``
(``lax.top_k``'s order on ties and ±0).

Storage reuses ``sessions.SessionStore`` as the slab container: the
batched engine keys cache rows by the *same* slot ids as the session
slab and registers a slot-freed listener so an evicted/released
conversation can never leak its entries to the slot's next occupant.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.concurrency import guarded_by
from repro_torch.core import toploc as _tl
from repro_torch.core.topk import topk
from repro_torch.serving import sessions as _sessions

#: rows a probe reduces at once (see the module docstring)
PROBE_ROWS = 32


class CacheEntry(NamedTuple):
    """One session's cached turn (device resident)."""
    q_vec: torch.Tensor       # (d,) float — anchor query embedding
    doc_ids: torch.Tensor     # (k,) int32 — cached top-k ids, -1 = empty
    doc_scores: torch.Tensor  # (k,) float — scores under q_vec
    doc_vecs: torch.Tensor    # (k, d) float — historical doc embeddings
    valid: torch.Tensor       # () bool


def entry_template(d: int, k: int, dtype=torch.float32,
                   device=None) -> CacheEntry:
    return CacheEntry(
        q_vec=torch.zeros((d,), dtype=dtype, device=device),
        doc_ids=torch.full((k,), -1, dtype=torch.int32, device=device),
        doc_scores=torch.zeros((k,), dtype=dtype, device=device),
        doc_vecs=torch.zeros((k, d), dtype=dtype, device=device),
        valid=torch.zeros((), dtype=torch.bool, device=device))


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def _probe_chunk(entries: CacheEntry, q: torch.Tensor, *, out_k: int,
                 threshold: float, rescore: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``probe`` on exactly ``PROBE_ROWS`` rows."""
    qq = (q * q).sum(-1)
    cc = (entries.q_vec * entries.q_vec).sum(-1)
    dot = (entries.q_vec * q).sum(-1)
    sim = dot * torch.rsqrt(torch.clamp(qq * cc, min=1e-30))
    hit = entries.valid & (sim >= threshold)
    if rescore:
        scores = (entries.doc_vecs * q[:, None, :]).sum(-1)
        scores = torch.where(entries.doc_ids >= 0, scores,
                             torch.full_like(scores, float("-inf")))
        v, pos = topk(scores, out_k)
        ids = entries.doc_ids.gather(-1, pos)
    else:
        # cached scores are already sorted — the prefix is the top-out_k
        v = entries.doc_scores[..., :out_k]
        ids = entries.doc_ids[..., :out_k]
    return hit, v, ids


def probe(entries: CacheEntry, q: torch.Tensor, *, out_k: int,
          threshold: float, rescore: bool
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe a batch of cache entries. entries: leading (B,); q: (B, d).

    Returns (hit (B,) bool, scores (B, out_k), ids (B, out_k)).  A hit
    requires a valid entry whose anchor query's cosine similarity to the
    new query reaches ``threshold``.  With ``rescore`` the cached
    document embeddings (``depth`` per entry, depth >= out_k) are
    re-scored under the new query (exact dot products) and the best
    out_k returned; without, the cached ranking is replayed as-is.  Each
    row's bits are the same at any B (chunks of ``PROBE_ROWS``).
    """
    b = q.shape[0]
    outs = []
    for s in range(0, b, PROBE_ROWS):
        n = min(PROBE_ROWS, b - s)
        chunk = CacheEntry(*(_pad_rows(a[s:s + n], PROBE_ROWS)
                             for a in entries))
        hit, v, ids = _probe_chunk(chunk, _pad_rows(q[s:s + n], PROBE_ROWS),
                                   out_k=out_k, threshold=threshold,
                                   rescore=rescore)
        outs.append((hit[:n], v[:n], ids[:n]))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _make_entries_rescore(q: torch.Tensor, v: torch.Tensor, ids: torch.Tensor,
                          corpus: torch.Tensor) -> CacheEntry:
    ids = ids.to(torch.int32)
    vecs = corpus[ids.clamp_min(0).to(torch.int64)]
    vecs = torch.where((ids >= 0)[..., None], vecs, torch.zeros_like(vecs))
    return CacheEntry(q, ids, v, vecs,
                      torch.ones(q.shape[:-1], dtype=torch.bool,
                                 device=q.device))


def _make_entries_static(q: torch.Tensor, v: torch.Tensor, ids: torch.Tensor
                         ) -> CacheEntry:
    b, k = ids.shape
    d = q.shape[-1]
    return CacheEntry(q, ids.to(torch.int32), v,
                      q.new_zeros((b, k, d)),
                      torch.ones((b,), dtype=torch.bool, device=q.device))


def fuse_wave(entries: CacheEntry, q: torch.Tensor, v: torch.Tensor,
              i: torch.Tensor, sess_old: Any, sess_new: Any,
              stats: _tl.TurnStats, corpus: Optional[torch.Tensor], *,
              out_k: int, threshold: float, rescore: bool):
    """One cache pass for a batched wave.

    ``v``/``i`` are the backend's depth-wide results (depth >= out_k).
    Probes the gathered ``entries`` against the wave queries and, per
    hit row, substitutes the cached answer, zeroes the work counters (a
    hit pays no backend work), keeps the *old* session state (the
    sequential engine never steps a session on a hit), and keeps the old
    cache entry; miss rows adopt the backend results (returned sliced to
    out_k) and a refreshed depth-wide entry.

    Returns (v (B, out_k), i (B, out_k), sess, stats, entries, hit).
    """
    hit, cv, ci = probe(entries, q, out_k=out_k, threshold=threshold,
                        rescore=rescore)
    fresh = (_make_entries_rescore(q, v, i, corpus) if rescore
             else _make_entries_static(q, v, i))
    h1 = hit[:, None]
    v = torch.where(h1, cv.to(v.dtype), v[..., :out_k])
    i = torch.where(h1, ci.to(i.dtype), i[..., :out_k])
    zero = _tl._zero_stats(q.device)
    stats = _tl.TurnStats(*(torch.where(hit, z.to(s.dtype), s)
                            for z, s in zip(zero, stats)))

    def row_sel(old, new):
        mask = hit.reshape((hit.shape[0],) + (1,) * (new.dim() - 1))
        return torch.where(mask, old, new)

    sess = _sessions.tree_map(row_sel, sess_old, sess_new)
    entries = _sessions.tree_map(row_sel, entries, fresh)
    return v, i, sess, stats, entries, hit


@guarded_by("_lock", "hits", "misses", "_entries")
class ResultCache:
    """Per-session result cache for both serving engines.

    Sequential mode (``n_slots=None``): entries keyed by conversation id
    in a host dict (one device row each).  Batched mode: a slab of
    ``n_slots`` rows + trash slot, addressed by the engine's session
    slot ids (``gather``/``fuse``/``scatter``), on the engine's stream;
    ``clear_slot`` is the ``SessionStore`` slot-freed listener.

    ``corpus`` (n, d) enables historical-embedding re-scoring on hits;
    without it the cache replays the stored ranking.  ``depth >= k``
    rows are cached per session (the engines over-fetch the backend to
    depth and serve/record only the top-k).  ``threshold <= 0`` never
    hits (``enabled`` False) — the engines then skip the cache path.

    Thread safety: the hit/miss counters and the sequential-mode entry
    dict are guarded by an internal lock — ``count_hits`` runs on the
    flusher at wave retirement while ``invalidate_docs`` may arrive on
    client threads.  Device work runs outside the lock; slab-mode rows
    are guarded by the underlying ``SessionStore``'s own lock.
    """

    def __init__(self, *, d: int, k: int, threshold: float,
                 depth: Optional[int] = None,
                 corpus: Optional[torch.Tensor] = None,
                 n_slots: Optional[int] = None, mesh: Any = None,
                 dtype=torch.float32, device=None,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.threshold = float(threshold)
        self.k = int(k)
        self.depth = max(int(depth or k), int(k))
        self.corpus = corpus
        self.rescore = corpus is not None
        if device is None:
            device = corpus.device if corpus is not None else "cpu"
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self._template = entry_template(d, self.depth, dtype, device)
        self._entries: Dict[str, CacheEntry] = {}
        self._slab: Optional[_sessions.SessionStore] = None
        if n_slots is not None:
            self._slab = _sessions.SessionStore(self._template, n_slots,
                                                mesh=mesh, stream=stream)

    @property
    def enabled(self) -> bool:
        return self.threshold > 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {"hits": self.hits, "misses": self.misses,
                    "hit_rate": (self.hits / total) if total else 0.0}

    def count_hits(self, hit: np.ndarray, b: int) -> None:
        """Fold a wave's host hit mask (first ``b`` rows are real
        requests) into the counters.  Separate from ``fuse`` so the
        batched engine reads the mask at wave retirement, not at
        launch."""
        n_hit = int(np.asarray(hit)[:b].sum())
        with self._lock:
            self.hits += n_hit
            self.misses += b - n_hit

    # -- sequential (dict) mode ---------------------------------------

    def lookup(self, conv_id: str, q: torch.Tensor
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Probe ``conv_id``'s entry with q (d,); (scores (k,), ids (k,))
        on a hit, None (counted as a miss) otherwise.  Reads the hit
        flag on the host (one sync)."""
        with self._lock:
            entry = self._entries.get(conv_id)
        if entry is None:
            with self._lock:
                self.misses += 1
            return None
        batched = CacheEntry(*(a[None] for a in entry))
        hit, v, ids = probe(batched, q[None], out_k=self.k,
                            threshold=self.threshold, rescore=self.rescore)
        if bool(hit[0]):
            with self._lock:
                self.hits += 1
            return v[0], ids[0]
        with self._lock:
            self.misses += 1
        return None

    def update(self, conv_id: str, q: torch.Tensor, v: torch.Tensor,
               ids: torch.Tensor) -> None:
        """Refresh ``conv_id``'s entry with the turn's backend answer
        (``v``/``ids`` depth-wide)."""
        fresh = (_make_entries_rescore(q[None], v[None], ids[None],
                                       self.corpus) if self.rescore
                 else _make_entries_static(q[None], v[None], ids[None]))
        row = CacheEntry(*(a[0] for a in fresh))
        with self._lock:
            self._entries[conv_id] = row

    def invalidate(self, conv_id: str) -> None:
        with self._lock:
            self._entries.pop(conv_id, None)

    def invalidate_docs(self, doc_ids) -> int:
        """Corpus-tombstone sweep: drop every entry whose cached
        candidate pool intersects ``doc_ids``, in both storage modes —
        after this, no later hit can serve or re-score a deleted
        document.  Returns entries/rows dropped.  The engines call it
        from ``delete_documents``, inside the mutation scope.
        """
        dead = np.atleast_1d(np.asarray(doc_ids, np.int64))
        if dead.size == 0:
            return 0
        n = 0
        with self._lock:                               # sequential mode
            drop = [cid for cid, e in self._entries.items()
                    if np.isin(e.doc_ids.cpu().numpy(), dead).any()]
            for cid in drop:
                del self._entries[cid]
            n += len(drop)
        if self._slab is not None:                     # slab mode
            with _sessions.on_stream(self._slab.stream):
                slab = self._slab.slab
                ids = slab.doc_ids.cpu().numpy()
                valid = slab.valid.cpu().numpy()
            rows = np.flatnonzero(valid & np.isin(ids, dead).any(axis=-1))
            if rows.size:
                self._slab.clear(rows.tolist())
            n += int(rows.size)
        return n

    # -- batched (slab) mode ------------------------------------------

    def gather(self, slots) -> CacheEntry:
        return self._slab.gather(slots)

    def scatter(self, slots, entries: CacheEntry) -> None:
        self._slab.scatter(slots, entries)

    def clear_slot(self, slot: int) -> None:
        """Slot-freed listener: wipe the slot's cache row."""
        self._slab.clear([slot])

    def fuse(self, slots, q, v, i, sess_old, sess_new, stats):
        """Batched-wave cache pass (see ``fuse_wave``); scatters the
        selected entries back and returns (v (B, k), i (B, k), sess,
        stats, hit (B,) bool tensor on the device)."""
        entries = self.gather(slots)
        v, i, sess, stats, entries, hit = fuse_wave(
            entries, q, v, i, sess_old, sess_new, stats, self.corpus,
            out_k=self.k, threshold=self.threshold, rescore=self.rescore)
        self.scatter(slots, entries)
        return v, i, sess, stats, hit
