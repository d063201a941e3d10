"""Conversational serving engine — TopLoc as a first-class feature.

Port of ``repro/serving/engine.py``: per-conversation TopLoc state held
on the device between turns, the retrieval backend resolved once from
the ``core.backend`` registry, an optional session-level
historical-embedding **result cache** (``serving.result_cache``: a turn
whose query is cosine-close to the session's cached query is answered
from the cached documents without touching the backend), and work +
latency accounting per turn.

Two engines share the accounting:

``ConversationalSearchEngine`` — one turn per call, sessions in a
Python dict.  The oracle the batched path is tested against.

``BatchedConversationalSearchEngine`` — the serving-scale path: requests
enter a ``scheduler.MicroBatcher``; each flush drains up to
``max_batch`` requests, pads to the next shape bucket, gathers the
sessions from a ``sessions.SessionStore`` slab, runs ONE batched TopLoc
step (``toploc.step_batch``) with an ``is_first`` mask for rows whose
conversation has no cached state, and scatters the updated sessions
back.  A flush holding several turns of one conversation is split into
consecutive waves, so one device batch never holds a conversation
twice.  With the result cache on, each wave adds one cache pass over
the cache slab (same slot ids as the session slab); hit rows take the
cached answer, keep their session untouched and report zero backend
work, as the sequential engine does when it skips the backend — so the
two engines stay bit-identical with the cache on as well as off.

Where the reference relies on JAX's async dispatch, the batched engine
queues every wave (gather, step, cache pass, scatter, and the copy of
the results into pinned host buffers) on one CUDA stream of its own and
records an event; the wave's results are read when the batcher retires
it, after that event.  The gate of ``step_batch`` (IVF's refresh,
HNSW's first-turn search: ``bool(....any())``) still syncs the host once
a wave.

``ServingConfig`` keeps every field and default of the reference.  The
knobs whose modules are not ported yet raise ``NotImplementedError``:
corpus sharding (``shards > 1``, ``mesh``; ROADMAP Queue 1, item 6) and
the mutable corpus (``segment_cap > 0``; item 5).  A fused
configuration whose fetch depth needs a top-k wider than the CUDA
kernels keep (``tiling.MAX_PAD``) raises at construction (ROADMAP
Queue 3, item 1), as does an HNSW configuration past the HNSW kernel's
caps (``tiling.check_hnsw``, item 4).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import backend as _backend
from repro_torch.core import hnsw as _hnsw
from repro_torch.core import ivf as _ivf
from repro_torch.core import pq as _pq
from repro_torch.core import toploc
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import tiling as _tiling
from repro_torch.serving import result_cache as _result_cache
from repro_torch.serving import sessions as _sessions
from repro_torch.serving.scheduler import MicroBatcher, Request


@dataclasses.dataclass
class ServingConfig:
    backend: str = "ivf"          # any core.backend registry name
    strategy: str = "toploc"      # "toploc" | "toploc+" | "plain"
    k: int = 10
    # IVF / IVF-PQ
    nprobe: int = 64
    h: int = 1024                 # cached centroids (TopLoc_IVF)
    alpha: float = 0.1            # refresh threshold (TopLoc_IVF+)
    rerank: int = 64              # exact re-rank depth (IVF-PQ)
    # fused turn (core.toploc.FusedTurn over the CUDA kernels of
    # kernels/csrc/): "f32" equals the unfused path; "bf16" / "int8"
    # score quantised and re-rank in float32 inside the kernel
    fused: bool = False
    precision: str = "f32"
    # HNSW
    ef_search: int = 64
    up: int = 2                   # first-turn ef upscaling
    # corpus sharding (not ported)
    shards: int = 0
    mesh: Any = None
    shard_axis: str = "model"
    # session-level historical-embedding result cache
    # (serving/result_cache.py): a turn whose query reaches this cosine
    # similarity to the session's cached query is answered from the
    # cached documents without touching the backend.  <= 0 disables the
    # cache.  cache_depth > k over-fetches the backend to that depth
    # (clamped to the backend's fetch limit) and caches the deeper pool;
    # only the top-k is ever served/recorded; 0 caches exactly the top-k.
    cache_threshold: float = 0.0
    cache_depth: int = 0
    # mutable corpus (not ported)
    segment_cap: int = 0


@dataclasses.dataclass
class TurnRecord:
    conv_id: str
    turn: int
    latency_s: float              # service time (dispatch -> result)
    centroid_dists: int
    list_dists: int
    graph_dists: int
    refreshed: bool
    i0: int
    code_dists: int = 0
    cache_hit: bool = False       # answered from the result cache
    # time queued before dispatch (batched engine; 0 for the sequential
    # engine).  latency_s + queue_wait_s is the client-observed request
    # latency
    queue_wait_s: float = 0.0


def _refuse_unported(cfg: ServingConfig) -> None:
    if (cfg.shards and cfg.shards > 1) or cfg.mesh is not None:
        raise NotImplementedError(
            "corpus sharding (shards > 1 / mesh) is not ported yet: "
            "ROADMAP Queue 1, item 6")
    if cfg.segment_cap > 0:
        raise NotImplementedError(
            "the mutable corpus (segment_cap > 0) is not ported yet: "
            "ROADMAP Queue 1, item 5")


def _host_query(qvec) -> np.ndarray:
    """A query as a float32 host array (a tensor is read on the caller's
    current stream)."""
    if isinstance(qvec, torch.Tensor):
        qvec = qvec.detach().to("cpu", torch.float32).numpy()
    return np.asarray(qvec, np.float32)


class _EngineAccounting:
    """Shared per-turn records + summary (sequential and batched)."""

    records: List[TurnRecord]

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        lat = np.asarray([r.latency_s for r in self.records])
        wait = np.asarray([r.queue_wait_s for r in self.records])
        return {
            "turns": len(self.records),
            "mean_latency_ms": float(lat.mean() * 1e3),
            "p95_latency_ms": float(np.percentile(lat, 95) * 1e3),
            "mean_queue_wait_ms": float(wait.mean() * 1e3),
            # client-observed request latency: queue wait + service time
            "p95_request_ms": float(np.percentile(lat + wait, 95) * 1e3),
            "mean_centroid_dists": float(np.mean(
                [r.centroid_dists for r in self.records])),
            "mean_list_dists": float(np.mean(
                [r.list_dists for r in self.records])),
            "mean_graph_dists": float(np.mean(
                [r.graph_dists for r in self.records])),
            "mean_code_dists": float(np.mean(
                [r.code_dists for r in self.records])),
            # refresh is defined from each conversation's second turn on
            "refresh_rate": float(np.mean(
                [r.refreshed for r in self.records if r.turn > 0]
                or [0.0])),
            "cache_hit_rate": float(np.mean(
                [r.cache_hit for r in self.records])),
        }


class _EngineBase(_EngineAccounting):
    """Backend/index/cache resolution shared by both engines."""

    _cache: Optional[_result_cache.ResultCache]

    def _setup(self, config: ServingConfig, *, ivf_index, ivf_pq_index,
               hnsw_index, doc_vecs, device) -> None:
        _refuse_unported(config)
        self.cfg = config
        self.device = _device.resolve(device)
        alpha = config.alpha if config.strategy == "toploc+" else -1.0
        fused = (toploc.FusedTurn(precision=config.precision)
                 if config.fused else None)
        # make() drops the knobs a backend does not declare, as the
        # reference's does
        self.backend = _backend.make(
            config.backend, h=config.h, nprobe=config.nprobe, alpha=alpha,
            rerank=config.rerank, ef=config.ef_search, up=config.up,
            fused=fused)
        if doc_vecs is not None and not isinstance(doc_vecs, torch.Tensor):
            doc_vecs = torch.from_numpy(
                np.asarray(doc_vecs, np.float32)).to(self.device)
        # Exact's index is the flat corpus itself
        provided = {"ivf_index": ivf_index, "hnsw_index": hnsw_index,
                    "ivf_pq_index": ivf_pq_index, "doc_vecs": doc_vecs}
        self.index = provided.get(self.backend.index_kwarg)
        if self.index is None:
            raise ValueError(f"{config.backend} backend needs "
                             f"{self.backend.index_kwarg}")
        _device.require(self.device, toploc.index_tensor(self.index),
                        doc_vecs)
        if isinstance(self.index, _pq.IVFPQIndex):
            _pq.check_index(self.index)
        self.doc_vecs = doc_vecs
        self.turn_count: Dict[str, int] = {}
        self.records: List[TurnRecord] = []

    @property
    def _sessioned(self) -> bool:
        """Per-conversation state in play this deployment?"""
        return self.backend.stateful and self.cfg.strategy != "plain"

    def _cache_corpus(self) -> Optional[torch.Tensor]:
        """Flat (n, d) corpus for historical-embedding re-scoring."""
        return (self.doc_vecs if self.doc_vecs is not None
                else self.backend.corpus_vectors(self.index))

    def _make_cache(self, n_slots: Optional[int] = None, stream=None
                    ) -> Optional[_result_cache.ResultCache]:
        """Result cache iff enabled and the deployment is sessioned (the
        cache is session-level state — plain serving has no session to
        anchor an entry to)."""
        cfg = self.cfg
        if cfg.cache_threshold <= 0.0 or not self._sessioned:
            return None
        # clamp the over-fetch to the backend's candidate pool: a wider
        # request would change which candidates the top-k is drawn from
        # (IVF-PQ: the re-rank pool widens with k)
        depth = min(max(cfg.cache_depth or cfg.k, cfg.k),
                    self.backend.fetch_limit(self.index))
        return _result_cache.ResultCache(
            d=self.backend.query_dim(self.index), k=cfg.k,
            threshold=cfg.cache_threshold, depth=depth,
            corpus=self._cache_corpus(), n_slots=n_slots,
            device=self.device, stream=stream)

    @property
    def _k_fetch(self) -> int:
        """Result depth requested from the backend: the cache depth when
        the cache is on (the entry stores the deeper pool; only the top-k
        is served), plain k otherwise."""
        return self._cache.depth if self._cache is not None else self.cfg.k

    def _check_kernel_width(self) -> None:
        """Refuse, at construction, a configuration past the CUDA
        kernels' caps: HNSW's beams of ef and up·ef, the fetch depth
        within them (``tiling.check_hnsw``), or a fused configuration
        whose fetch depth needs a top-k wider than the kernels keep: the
        quantised IVF scan keeps the top r = depth·over, the PQ scan its
        re-rank pool r = max(depth, min(rerank, nprobe·Lmax))."""
        if isinstance(self.backend, _backend.HNSWBackend):
            bk, index = self.backend, self.index
            for ef in (bk.ef, bk.up * bk.ef):
                _tiling.check_hnsw(index.vectors.shape[1], ef,
                                   max(index.adj0.shape[1],
                                       index.upper_adj.shape[2]),
                                   self._k_fetch)
            return
        fused = getattr(self.backend, "fused", None)
        if fused is None:
            return
        depth, cap = self._k_fetch, self.cfg.nprobe * self.index.lmax
        if isinstance(self.backend, _backend.IVFPQBackend):
            r = _kops._fused_depth(depth, cap, self.backend.rerank)
        elif fused.precision == "f32":
            r = depth
        else:
            r = _kops._fused_depth(depth, cap, depth * fused.over)
        if _tiling.next_pow2(r) > _tiling.MAX_PAD:
            raise ValueError(
                f"fetch depth {depth} needs a top-{r} in the fused "
                f"{self.cfg.backend} kernels ({fused.precision}); they keep "
                f"at most {_tiling.MAX_PAD}: ROADMAP Queue 3, item 1")

    def cache_stats(self) -> Dict[str, float]:
        """Result-cache hit/miss counters ({} when the cache is off)."""
        return self._cache.stats() if self._cache is not None else {}


class ConversationalSearchEngine(_EngineBase):
    """One turn per call, sessions in a Python dict.

    The index (``ivf_index`` for ``backend="ivf"``, ``ivf_pq_index`` for
    ``"ivf_pq"``, ``hnsw_index`` for ``"hnsw"``, ``doc_vecs`` for
    ``"exact"``) and ``doc_vecs`` (the flat corpus the result cache
    re-scores against; IVF-PQ and HNSW keep their own) must live on
    ``device`` (default cuda); queries may be numpy arrays or tensors and
    are moved there.
    """

    def __init__(self, config: ServingConfig, *,
                 ivf_index: Optional[_ivf.IVFIndex] = None,
                 hnsw_index: Optional[_hnsw.HNSWIndex] = None,
                 ivf_pq_index: Optional[_pq.IVFPQIndex] = None,
                 doc_vecs=None, device=None):
        self._setup(config, ivf_index=ivf_index, ivf_pq_index=ivf_pq_index,
                    hnsw_index=hnsw_index, doc_vecs=doc_vecs, device=device)
        self.sessions: Dict[str, Any] = {}
        self._cache = self._make_cache()
        self._check_kernel_width()

    def query(self, conv_id: str, qvec) -> Tuple[np.ndarray, np.ndarray]:
        """One conversational turn. qvec (d,). Returns (scores, doc_ids)."""
        t0 = time.perf_counter()
        k, kf, dev = self.cfg.k, self._k_fetch, self.device
        q = torch.as_tensor(qvec, dtype=torch.float32).to(dev)
        turn = self.turn_count.get(conv_id, 0)
        cached = (self._cache.lookup(conv_id, q)
                  if self._cache is not None else None)
        if cached is not None:
            v, i = cached
            stats = toploc._zero_stats(dev)
        elif not self._sessioned:
            v, i, stats = toploc.plain(self.backend, self.index, q, k=kf,
                                       device=dev)
        elif turn == 0 or conv_id not in self.sessions:
            v, i, sess, stats = toploc.start(self.backend, self.index, q,
                                             k=kf, device=dev)
            self.sessions[conv_id] = sess
        else:
            v, i, sess, stats = toploc.step(self.backend, self.index,
                                            self.sessions[conv_id], q, k=kf,
                                            device=dev)
            self.sessions[conv_id] = sess
        if cached is None and self._cache is not None:
            self._cache.update(conv_id, q, v, i)
            v, i = v[:k], i[:k]
        # one device→host copy ends the turn (and synchronises the card)
        host = torch.stack([s.to(torch.int64) for s in stats]).cpu()
        v = v.cpu().numpy()
        i = i.cpu().numpy()
        dt = time.perf_counter() - t0
        st = dict(zip(toploc.TurnStats._fields, host.tolist()))
        self.turn_count[conv_id] = turn + 1
        self.records.append(TurnRecord(
            conv_id, turn, dt, st["centroid_dists"], st["list_dists"],
            st["graph_dists"], bool(st["refreshed"]), st["i0"],
            st["code_dists"], cache_hit=cached is not None))
        return v, i

    def end_conversation(self, conv_id: str) -> None:
        self.sessions.pop(conv_id, None)
        self.turn_count.pop(conv_id, None)
        if self._cache is not None:
            self._cache.invalidate(conv_id)


class _HostCopy:
    """A wave's outputs copied into host memory without blocking the
    host: on CUDA, pinned buffers filled by non-blocking copies queued on
    the current stream, then an event; ``wait`` syncs on the event."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._event = None
        if tensors[0].device.type != "cuda":
            self._host = [t.numpy() for t in tensors]
            return
        self._host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            self._host.append(h)
        self._event = torch.cuda.Event()
        self._event.record()

    def wait(self) -> List[np.ndarray]:
        if self._event is None:
            return self._host
        self._event.synchronize()
        return [h.numpy() for h in self._host]


class BatchedConversationalSearchEngine(_EngineBase):
    """Continuously micro-batched multi-conversation serving front door.

    Requests flow ``submit() → MicroBatcher queue → flush → one padded
    device batch → scatter sessions → resolve futures``.  See the module
    docstring for the flush/wave semantics.

    Batches run as a **continuous-batching loop**: ``flush`` only
    *launches* a wave — its device work queued on the engine's CUDA
    stream, its results copied to pinned host memory behind an event —
    and hands the MicroBatcher a completion thunk that waits on that
    event; with ``max_inflight=2`` the host drains, pads and launches
    wave N+1 while wave N may still run on the device.  Correctness under
    overlap comes from stream ordering through the session slab: wave
    N's scatter is queued before wave N+1's gather, so a conversation in
    consecutive launches observes its own updated state.

    ``n_slots`` bounds resident conversations; the LRU conversation is
    evicted when a new one arrives at full occupancy and is rebuilt
    (first-turn semantics) if it ever returns.  Runs on ``device``
    (default cuda), as the sequential engine does.
    """

    def __init__(self, config: ServingConfig, *,
                 ivf_index: Optional[_ivf.IVFIndex] = None,
                 hnsw_index: Optional[_hnsw.HNSWIndex] = None,
                 ivf_pq_index: Optional[_pq.IVFPQIndex] = None,
                 doc_vecs=None, n_slots: int = 256, max_batch: int = 32,
                 max_wait_s: float = 0.002,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 max_inflight: int = 2, device=None):
        self._setup(config, ivf_index=ivf_index, ivf_pq_index=ivf_pq_index,
                    hnsw_index=hnsw_index, doc_vecs=doc_vecs, device=device)
        # a wave holds up to max_batch distinct conversations, each
        # needing its own live slot — fewer slots would make acquire()
        # evict a conversation acquired earlier in the SAME wave and
        # scatter two rows into one slot (silent session corruption)
        if self.backend.stateful and n_slots < max_batch:
            raise ValueError(
                f"n_slots ({n_slots}) must be >= max_batch ({max_batch})")
        buckets = tuple(sorted(set(buckets) | {max_batch}))
        self._stream = None
        if self.device.type == "cuda":
            # every wave runs on this stream; it first waits for what the
            # caller queued (the index, the corpus)
            self._stream = torch.cuda.Stream(device=self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self.store = _sessions.store_for_backend(
            self.backend, self.index, n_slots=n_slots, stream=self._stream)
        self._cache = self._make_cache(n_slots=n_slots, stream=self._stream)
        self._check_kernel_width()
        if self._cache is not None:
            # a freed session slot must also drop its cache row, or the
            # slot's next conversation could hit another user's entry
            self.store.add_slot_freed_listener(self._cache.clear_slot)
        self.batcher = MicroBatcher(dispatch_batch=self._dispatch_batch,
                                    max_batch=max_batch,
                                    max_wait_s=max_wait_s, buckets=buckets,
                                    max_inflight=max_inflight)

    # -- public API ---------------------------------------------------

    def submit(self, conv_id: str, qvec):
        """Enqueue one conversational turn; resolves at the next flush.

        Returns a ``concurrent.futures.Future`` of (scores, doc_ids).
        """
        return self.batcher.submit(Request(conv_id, _host_query(qvec)))

    def flush(self) -> int:
        """Launch one micro-batch from the queue (serving-loop tick).

        Returns the number of requests launched; their futures resolve
        once the batch is retired (after ``max_inflight`` later
        launches, or at ``sync``/``drain``).
        """
        return self.batcher.flush_loop_once()

    def sync(self) -> None:
        """Retire every in-flight batch (resolves outstanding futures)."""
        self.batcher.sync()

    def drain(self) -> int:
        """Flush until the queue is empty and all launches retired;
        returns turns served."""
        served = 0
        while True:
            n = self.batcher.flush_loop_once()
            if n == 0:
                self.batcher.sync()
                if self.batcher.flush_loop_once() == 0:
                    return served
                continue
            served += n

    def query(self, conv_id: str, qvec) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous single-turn convenience (submit + flush + sync)."""
        fut = self.submit(conv_id, qvec)
        while not fut.done():
            if self.batcher.flush_loop_once() == 0:
                self.batcher.sync()
        return fut.result()

    def close(self) -> None:
        """Quiesce: retire in-flight launches so no future is left
        pending.  Idempotent; also reachable as a context manager."""
        self.batcher.sync()

    def __enter__(self) -> "BatchedConversationalSearchEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def end_conversation(self, conv_id: str) -> None:
        # release under the paused batcher: a launched wave's scatter
        # still targets this conversation's slot (freeing the slot now
        # could hand it to a conversation in the *next* launch before
        # the scatter executes), and turn_count is otherwise only
        # touched by launches under the drain lock
        with self.batcher.paused():
            if self.store is not None:
                self.store.release(conv_id)
            self.turn_count.pop(conv_id, None)

    # -- batch execution ----------------------------------------------

    def _dispatch_batch(self, reqs: List[Request]) -> Any:
        """MicroBatcher dispatch callback: launch a drained micro-batch.

        Splits the batch into waves holding at most one turn per
        conversation (turn t+1 must gather the session state turn t
        scattered), launches each wave without blocking, and returns a
        completion thunk that reads the results and writes the
        ``TurnRecord``s.  The batcher's trailing pad requests are dropped
        here — each wave re-pads itself to its own bucket with trash-slot
        rows, so pad rows never acquire a session slot or emit a record.
        """
        remaining = [(j, r) for j, r in enumerate(reqs)
                     if r.conv_id != MicroBatcher.PAD_ID]
        finishers = []
        while remaining:
            seen, wave, deferred = set(), [], []
            for item in remaining:
                if item[1].conv_id in seen:
                    deferred.append(item)
                else:
                    seen.add(item[1].conv_id)
                    wave.append(item)
            finishers.append(self._launch_wave(wave))
            remaining = deferred

        def complete() -> List[Any]:
            results: List[Any] = [None] * len(reqs)
            for finish in finishers:
                finish(results)
            return results
        return complete

    def _launch_wave(self, wave):
        """Queue one wave's device work on the engine's stream and return
        a ``finish(results)`` closure that reads it.

        Gather, step_batch, the cache pass, the scatter and the copies of
        the results into pinned host memory are all queued on the stream;
        the closure waits on the event recorded after them, when the
        batcher retires this launch.
        """
        b = len(wave)
        bb = self.batcher.bucket(b)          # padded (bucketed) batch size
        qs = [r.payload for _, r in wave]
        q_host = np.stack(qs + [np.zeros_like(qs[0])] * (bb - b))
        dev = self.device
        hit = None
        with _sessions.on_stream(self._stream):
            q = _sessions.to_device(q_host, dev)
            if not self._sessioned:
                v, i, stats = toploc.plain_batch(self.backend, self.index, q,
                                                 k=self.cfg.k, device=dev)
            else:
                # padded rows run against the trash slot with
                # is_first=False: their zeroed trash session never trips
                # the drift check, so the batch-wide refresh gate stays
                # closed on steady-state flushes; the scatter writes them
                # back to the trash row, never a live session
                slots = np.full((bb,), self.store.trash_slot, np.int64)
                is_first = np.zeros((bb,), bool)
                for row, (_, r) in enumerate(wave):
                    slots[row], is_first[row] = self.store.acquire(r.conv_id)
                slots = _sessions.to_device(slots, dev)
                sess = self.store.gather(slots)
                v, i, new_sess, stats = toploc.step_batch(
                    self.backend, self.index, sess, q, k=self._k_fetch,
                    is_first=_sessions.to_device(is_first, dev), device=dev)
                if self._cache is not None:
                    # hit rows take the cached answer, zero their work
                    # counters and keep the pre-step session (the
                    # sequential engine skips the backend on a hit)
                    v, i, new_sess, stats, hit = self._cache.fuse(
                        slots, q, v, i, sess, new_sess, stats)
                self.store.scatter(slots, new_sess)
            # the counters as one (6, B) tensor: one copy, not six
            counts = torch.stack([s.to(torch.int32) for s in stats])
            out = _HostCopy([v, i, counts] + ([hit] if hit is not None
                                              else []))

        # turn numbers are claimed at LAUNCH: a later launch holding the
        # same conversation must see this wave's increment even though
        # its records are written at retirement
        turns = []
        for _, r in wave:
            t = self.turn_count.get(r.conv_id, 0)
            self.turn_count[r.conv_id] = t + 1
            turns.append(t)
        t_dispatch = time.perf_counter()

        def finish(results) -> None:
            host = out.wait()
            vh, ih = host[0], host[1]
            st = toploc.TurnStats(*host[2])
            hh = host[3] if hit is not None else None
            if hh is not None:
                self._cache.count_hits(hh, b)
            now = time.perf_counter()
            for row, ((j, r), turn) in enumerate(zip(wave, turns)):
                self.records.append(TurnRecord(
                    r.conv_id, turn, now - t_dispatch,
                    int(st.centroid_dists[row]), int(st.list_dists[row]),
                    int(st.graph_dists[row]), bool(st.refreshed[row]),
                    int(st.i0[row]), int(st.code_dists[row]),
                    cache_hit=bool(hh[row]) if hh is not None else False,
                    queue_wait_s=t_dispatch - r.enqueue_t))
                results[j] = (vh[row], ih[row])
        return finish
