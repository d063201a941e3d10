"""Replica router: session-affine serving over a (replica, shard) mesh.

Port of ``repro/serving/router.py``.  Where ``distributed.retrieval``
shards the *corpus* over the ``model`` axis of a mesh, this module
scales *throughput* by running R independent
``BatchedConversationalSearchEngine`` replicas, each on its own
per-replica submesh (``distributed.retrieval.replica_submeshes``) —
every replica group holds a full sharded corpus, its own
``SessionStore`` slab, its own ``ResultCache`` and its own CUDA stream
(the batched engine's).  Two replicas may share a card: on one card
they are two engines on ``cuda:0``, their waves on two streams.

Routing rule — stateful vs. stateless:

  * **Stateful** deployments (TopLoc strategies on stateful backends):
    the session slab and cache rows are per-replica device state, so a
    conversation is **pinned** to one replica for its lifetime
    (least-loaded assignment at first turn, sticky until
    ``end_conversation``).  Turn t's scatter and turn t+1's gather must
    hit the same slab; migrating mid-conversation would orphan the C0
    cache.  An eviction *inside* a replica's LRU slab does NOT unpin —
    the conversation rebuilds first-turn state on the same replica,
    exactly like the single-engine eviction path, so routed results
    stay bit-identical to a single engine serving that conversation.
  * **Stateless** deployments (``strategy="plain"`` or a stateless
    backend): no session anchors the request, so any replica can serve
    it and duplicate dispatch is *safe* — requests route through a
    ``scheduler.HedgedExecutor`` (Dean & Barroso): the p95-adaptive
    hedge re-issues a straggling request on the next replica and the
    first successful result wins.  Results are bit-identical regardless
    of the winning replica (each replica runs the same code on an
    identical full corpus), which is precisely why
    hedging is restricted to stateless traffic: a hedged *stateful*
    turn would step two divergent session copies.

Pinning + per-drain wave splitting compose into the global wave
invariant: a conversation's turns all flow through one replica's
batcher, which never puts two of them in one device batch.

Hedged calls block on the target engine's futures, so hedged traffic
needs the per-replica pump threads running (``start()`` — called
lazily on first hedged submit).  Pinned traffic works either threaded
(``start()``/``close()``) or single-threaded via ``drain()``.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import device as _device
from repro_torch.concurrency import guarded_by
from repro_torch.distributed import retrieval as _retrieval
from repro_torch.serving.engine import (BatchedConversationalSearchEngine,
                                        ServingConfig, _EngineAccounting)
from repro_torch.serving.scheduler import HedgedExecutor


@guarded_by("_route_lock", "_replica_of", "_load", "_rr",
            "_pumps", "_closed")
class ReplicatedSearchEngine:
    """R replica ``BatchedConversationalSearchEngine``s behind one
    session-affine front door (module docstring has the routing rule).

    Thread safety: the routing table, load counters, pump-thread list,
    and the closed flag are guarded by ``_route_lock`` — submits arrive
    on arbitrary client threads while pumps run and ``close()`` may race
    a lazy ``start()``.  After ``close()`` every ``submit``/``query``/
    mutation raises ``RuntimeError`` instead of dispatching to dead pump
    threads; ``close()`` itself is idempotent.

    ``config.mesh`` may be a prebuilt 2-D ``(replica, shard)`` mesh
    (split into per-replica submeshes; its replica count must match
    ``replicas``); with ``config.shards > 1`` and no mesh the 2-D mesh
    is built from the visible cards (on the CPU, the CPU device
    repeated); otherwise each replica runs unsharded on ``device``
    (default cuda).  A replica's engine runs on its submesh's leader.
    Engine kwargs (slots, batching)
    apply per replica — total session capacity is ``replicas *
    n_slots``, which is the capacity story behind fig7: a session
    population that thrashes one replica's LRU slab sits fully resident
    across two.
    """

    def __init__(self, config: ServingConfig, *, replicas: int = 1,
                 ivf_index: Any = None, hnsw_index: Any = None,
                 ivf_pq_index: Any = None, doc_vecs: Any = None,
                 n_slots: int = 256, max_batch: int = 32,
                 max_wait_s: float = 0.002,
                 buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32),
                 max_inflight: int = 2,
                 hedge_quantile: float = 0.95,
                 hedge_floor_s: float = 0.005, device=None):
        if replicas < 1:
            raise ValueError(f"replicas={replicas} must be >= 1")
        device = _device.resolve(device)
        submeshes = self._resolve_submeshes(config, replicas, device)
        self.replicas = replicas
        self.engines: List[BatchedConversationalSearchEngine] = []
        for sm in submeshes:
            # shards=0: the submesh (when any) already encodes the shard
            # count; a per-replica engine must never rebuild its own mesh
            cfg_r = dataclasses.replace(config, mesh=sm, shards=0)
            self.engines.append(BatchedConversationalSearchEngine(
                cfg_r, ivf_index=ivf_index, hnsw_index=hnsw_index,
                ivf_pq_index=ivf_pq_index, doc_vecs=doc_vecs,
                n_slots=n_slots, max_batch=max_batch,
                max_wait_s=max_wait_s, buckets=buckets,
                max_inflight=max_inflight,
                device=device if sm is None else sm.leader))
        self.stateful = self.engines[0]._sessioned
        self._route_lock = threading.Lock()
        self._replica_of: Dict[str, int] = {}
        self._load = [0] * replicas            # pinned sessions / replica
        self._rr = 0                           # round-robin tie-break
        self._hedge: Optional[HedgedExecutor] = None
        self._hedge_pool: Optional[ThreadPoolExecutor] = None
        if not self.stateful:
            self._hedge = HedgedExecutor(
                [self._replica_call(r) for r in range(replicas)],
                hedge_quantile=hedge_quantile, hedge_floor_s=hedge_floor_s)
            # hedge.call blocks; this pool turns it back into a Future
            self._hedge_pool = ThreadPoolExecutor(
                max_workers=2 * replicas,
                thread_name_prefix="hedge-front")
        self._pumps: List[threading.Thread] = []
        self._stop = threading.Event()
        self._closed = False

    # -- construction helpers -----------------------------------------

    @staticmethod
    def _resolve_submeshes(config: ServingConfig, replicas: int,
                           device) -> List:
        mesh = config.mesh
        if mesh is not None:
            subs = _retrieval.replica_submeshes(mesh)
            if len(subs) != replicas:
                raise ValueError(
                    f"config.mesh has {len(subs)} replica group(s) but "
                    f"replicas={replicas}")
            return subs
        if config.shards and config.shards > 1:
            return _retrieval.replica_submeshes(_retrieval.engine_mesh(
                config.shards, device, replicas=replicas))
        return [None] * replicas

    def _replica_call(self, r: int):
        """Hedge-target callable: run one stateless turn on replica r
        end to end (submit + block on the future)."""
        def call(payload: Tuple[str, Any]):
            conv_id, qvec = payload
            return self.engines[r].submit(conv_id, qvec).result()
        return call

    # -- routing -------------------------------------------------------

    def replica_of(self, conv_id: str) -> Optional[int]:
        """The replica a conversation is pinned to (None if unseen)."""
        with self._route_lock:
            return self._replica_of.get(conv_id)

    def _acquire_replica(self, conv_id: str) -> int:
        with self._route_lock:
            r = self._replica_of.get(conv_id)
            if r is None:
                # least-loaded pinning, round-robin among ties so a cold
                # start spreads sessions instead of piling on replica 0
                order = [(self._load[i], (i - self._rr) % self.replicas, i)
                         for i in range(self.replicas)]
                r = min(order)[2]
                self._rr = (r + 1) % self.replicas
                self._replica_of[conv_id] = r
                self._load[r] += 1
            return r

    # -- public API ----------------------------------------------------

    def _ensure_open(self) -> None:
        with self._route_lock:
            if self._closed:
                raise RuntimeError(
                    "ReplicatedSearchEngine is closed; build a new "
                    "router to serve further traffic")

    def _pumps_running(self) -> bool:
        with self._route_lock:
            return bool(self._pumps)

    def submit(self, conv_id: str, qvec) -> Future:
        """Enqueue one turn; Future of (scores, doc_ids).

        Stateful traffic goes to the conversation's pinned replica;
        stateless traffic is hedged across replicas.  Raises
        ``RuntimeError`` after ``close()``.
        """
        self._ensure_open()
        if self.stateful:
            r = self._acquire_replica(conv_id)
            return self.engines[r].submit(conv_id, qvec)
        # no-op once running; atomically spawns the pumps on first use
        # (two concurrent first submits must not double-spawn)
        self.start()
        return self._hedge_pool.submit(self._hedge.call, (conv_id, qvec))

    def query(self, conv_id: str, qvec) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous single-turn convenience."""
        fut = self.submit(conv_id, qvec)
        if self.stateful and not self._pumps_running():
            # read the pin under the route lock (replica_of); a racing
            # end_conversation may have already dropped it between
            # submit() and here, in which case the turn was enqueued on
            # whichever replica held the pin at submit time — drain all
            # replicas until the future lands instead of KeyError-ing
            r = self.replica_of(conv_id)
            engines = [self.engines[r]] if r is not None else self.engines
            while not fut.done():
                if sum(eng.flush() for eng in engines) == 0:
                    for eng in engines:
                        eng.sync()
        return fut.result()

    def end_conversation(self, conv_id: str) -> None:
        with self._route_lock:
            r = self._replica_of.pop(conv_id, None)
            if r is not None:
                self._load[r] -= 1
        if r is not None:
            self.engines[r].end_conversation(conv_id)

    # -- mutable corpus (core.segment) ---------------------------------

    def add_documents(self, vectors) -> np.ndarray:
        """Broadcast an ingest batch to every replica.  Full-corpus
        replicas must stay identical for pinning (and stateless
        hedging) to be safe; id assignment is deterministic (``n_base +
        delta row``), so every replica assigns the same ids — asserted
        here.  Returns the assigned global ids.
        """
        self._ensure_open()
        ids: Optional[np.ndarray] = None
        for eng in self.engines:
            got = eng.add_documents(vectors)
            if ids is not None and not np.array_equal(ids, got):
                raise RuntimeError(
                    "replica divergence: add_documents assigned "
                    f"{got.tolist()} vs {ids.tolist()}")
            ids = got
        return ids

    def delete_documents(self, ids) -> None:
        """Broadcast tombstones to every replica (each invalidates its
        own result-cache entries intersecting the deleted ids)."""
        self._ensure_open()
        for eng in self.engines:
            eng.delete_documents(ids)

    def compact(self, **build_kw) -> None:
        """Compact the delta segment on every replica (replicas fold
        the identical delta into the identical base, so they remain
        bit-identical afterwards — the core.segment rebuild contract)."""
        self._ensure_open()
        for eng in self.engines:
            eng.compact(**build_kw)

    @property
    def corpus_epoch(self) -> int:
        """Corpus mutation epoch (identical across replicas — every
        mutation broadcasts)."""
        return self.engines[0].corpus_epoch

    def drain(self) -> int:
        """Single-threaded serving: drain every replica's queue and
        retire all launches; returns turns served."""
        served = 0
        while True:
            n = sum(e.drain() for e in self.engines)
            if n == 0:
                return served
            served += n

    # -- serving-loop threads ------------------------------------------

    def start(self) -> "ReplicatedSearchEngine":
        """Spawn one pump (serving-loop) thread per replica.  No-op when
        already running or closed; safe to call concurrently (the pump
        list is built under the route lock, so two racing first submits
        can never double-spawn)."""
        with self._route_lock:
            if self._pumps or self._closed:
                return self
            self._stop.clear()
            for r, eng in enumerate(self.engines):
                t = threading.Thread(target=self._pump_loop, args=(eng,),
                                     name=f"replica-pump-{r}", daemon=True)
                t.start()
                self._pumps.append(t)
        return self

    def _pump_loop(self, eng: BatchedConversationalSearchEngine) -> None:
        while not self._stop.is_set():
            # flush blocks on the batcher condvar up to max_wait_s, so
            # an idle pump parks instead of spinning; an empty tick
            # retires in-flight launches so tail futures resolve even
            # when no new traffic pushes them out
            if eng.flush() == 0:
                eng.sync()

    def close(self) -> None:
        """Quiesce and tear down.  Order matters: the hedge front pool
        drains first (its calls need live pumps to resolve), then the
        hedge executor's replica pool, then the pumps, then the engines.
        Idempotent — the closed flag flips exactly once under the route
        lock, so a second (or concurrent) close returns immediately."""
        with self._route_lock:
            if self._closed:
                return
            self._closed = True
        if self._hedge_pool is not None:
            self._hedge_pool.shutdown(wait=True)
        if self._hedge is not None:
            self._hedge.close()
        self._stop.set()
        with self._route_lock:
            pumps, self._pumps = list(self._pumps), []
        for t in pumps:
            t.join(timeout=10.0)
        for eng in self.engines:
            eng.close()

    def __enter__(self) -> "ReplicatedSearchEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- merged accounting ---------------------------------------------

    @property
    def records(self) -> List:
        """All replicas' TurnRecords (hedged duplicates included — a
        hedge that loses still did the work)."""
        return [rec for eng in self.engines for rec in eng.records]

    def summary(self) -> Dict[str, float]:
        acc = _EngineAccounting()
        acc.records = self.records
        return acc.summary()

    def cache_stats(self) -> Dict[str, float]:
        merged: Dict[str, float] = {"hits": 0, "misses": 0}
        for eng in self.engines:
            s = eng.cache_stats()
            merged["hits"] += s.get("hits", 0)
            merged["misses"] += s.get("misses", 0)
        total = merged["hits"] + merged["misses"]
        merged["hit_rate"] = (merged["hits"] / total) if total else 0.0
        return merged

    def hedge_stats(self) -> Dict[str, float]:
        return self._hedge.stats() if self._hedge is not None else {}

    def load_stats(self) -> Dict[str, Any]:
        """Per-replica load + imbalance (max/mean served turns)."""
        turns = [len(eng.records) for eng in self.engines]
        with self._route_lock:
            sessions = list(self._load)
        mean = float(np.mean(turns)) if any(turns) else 0.0
        return {
            "per_replica_turns": turns,
            "per_replica_sessions": sessions,
            "imbalance": (max(turns) / mean) if mean else 1.0,
        }
