"""Serving scheduler: continuous micro-batching + hedged dispatch.

Port of ``repro/serving/scheduler.py`` (framework-free: the port keeps
its own copy).  ``MicroBatcher`` — the serving front door: requests
accumulate until ``max_batch`` or ``max_wait_s`` (deadline-based
flush), then execute as one device batch.  Padding to the next bucket
keeps every batch at a size from the bucket table.  Two execution modes
share the drain/pad logic:

  * **synchronous** (``process_batch``): the callback computes the
    results before the flush returns — the one-wave-at-a-time loop,
    still used by tests and simple tools.
  * **continuous** (``dispatch_batch``): the callback only *launches*
    the device work (queued on a CUDA stream) and returns a completion
    thunk; the batcher keeps up to ``max_inflight`` launched batches
    outstanding and resolves their futures when it retires them.  The
    host therefore assembles wave N+1 while wave N runs on the device.

All queue and stats state is guarded by one lock (``submit`` may be
called from any number of client threads); the drain/retire path is
single-owner (``_drain_lock``), so two serving-loop threads calling
``flush_loop_once`` concurrently serialize instead of interleaving a
drain mid-pad.  Waiting for work uses a condition variable — a submit
wakes the flusher immediately, and an idle flusher sleeps instead of
hot-spinning the deadline poll.

``HedgedExecutor`` — tail-latency mitigation for multi-replica serving:
after an adaptive p95-based deadline, the slowest in-flight call is
re-issued on a second replica and the first result wins (Dean &
Barroso, "The Tail at Scale").  It owns a thread pool, so it is a
context manager — call ``close()`` (or use ``with``) when tearing an
engine or benchmark down, or every rebuild leaks 2x``len(replicas)``
threads.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.concurrency import guarded_by, holds


@dataclasses.dataclass
class Request:
    conv_id: str
    payload: Any
    enqueue_t: float = dataclasses.field(default_factory=time.perf_counter)


@guarded_by("_lock", "_queue", "batch_sizes", "padded_sizes")
@guarded_by("_drain_lock", "_inflight")
class MicroBatcher:
    """Deadline-based micro-batching with shape bucketing.

    Every flush is padded up to ``bucket(n)`` with trailing **pad
    requests** (``conv_id == PAD_ID``, payload cloned from the first real
    request) before reaching the batch callback — so the callback only
    ever sees batch sizes from the bucket table, and the device step
    runs at a few shapes only.  Pad results are discarded (no futures exist for them);
    batch-aware callbacks such as the batched engine route pad rows to
    the session store's trash slot.  ``batch_sizes`` records the raw
    drained sizes, ``padded_sizes`` the dispatched (bucketed) sizes —
    both appended under the lock, so concurrent flusher threads cannot
    interleave the two lists out of step.

    Exactly one of ``process_batch`` (synchronous) and
    ``dispatch_batch`` (continuous) must be given.  ``dispatch_batch``
    receives the padded request list, launches the device work without
    blocking, and returns a zero-argument completion thunk yielding the
    per-request results; the batcher retires the oldest outstanding
    launch whenever ``max_inflight`` would be exceeded, and ``sync()``
    retires everything (serving-loop quiesce / ``drain``).
    """

    PAD_ID = "__pad__"   # reserved conv_id marking padding requests

    def __init__(self, process_batch: Optional[
                     Callable[[List[Request]], List[Any]]] = None,
                 *, dispatch_batch: Optional[
                     Callable[[List[Request]], Callable[[], List[Any]]]] = None,
                 max_batch: int = 32, max_wait_s: float = 0.002,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 max_inflight: int = 2):
        if (process_batch is None) == (dispatch_batch is None):
            raise ValueError(
                "exactly one of process_batch / dispatch_batch required")
        self._process = process_batch
        self._dispatch = dispatch_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_inflight = max(1, int(max_inflight))
        # the table must cover max_batch, else a drain larger than the
        # top bucket would dispatch ragged (bucket() would return a
        # bucket *smaller* than n and the pad range would be empty)
        self.buckets = sorted(set(buckets) | {max_batch})
        self._queue: "collections.deque[Tuple[Request, Future]]" = \
            collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        # single-owner drain/retire: two flusher threads serialize here
        self._drain_lock = threading.Lock()
        self._inflight: "collections.deque[Tuple[List, Callable]]" = \
            collections.deque()
        self.batch_sizes: List[int] = []
        self.padded_sizes: List[int] = []

    def submit(self, req: Request) -> Future:
        fut: Future = Future()
        with self._work:
            self._queue.append((req, fut))
            self._work.notify()
        return fut

    def bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @property
    def inflight(self) -> int:
        """Launched-but-unretired batches (continuous mode)."""
        with self._drain_lock:
            return len(self._inflight)

    def _wait_and_drain(self) -> List[Tuple[Request, Future]]:
        """Wait (condvar, not poll) until max_batch or the deadline,
        then pop up to max_batch items."""
        deadline = time.perf_counter() + self.max_wait_s
        with self._work:
            while len(self._queue) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._work.wait(timeout=remaining)
            take = min(len(self._queue), self.max_batch)
            return [self._queue.popleft() for _ in range(take)]

    @holds("_drain_lock")
    def _retire_oldest_locked(self) -> None:
        """Complete the oldest in-flight launch and resolve its futures.
        Caller holds ``_drain_lock``."""
        items, complete = self._inflight.popleft()
        try:
            results = complete()
            # pads are trailing: zip over items covers exactly the real
            # requests and drops pad results
            for (_, fut), res in zip(items, results):
                fut.set_result(res)
        except BaseException as e:
            for _, fut in items:
                fut.set_exception(e)

    def flush_loop_once(self) -> int:
        """Drain one micro-batch (call from the serving loop).

        Continuous mode returns once the batch is *launched* (futures
        resolve when the launch is retired — after ``max_inflight``
        later launches, or at ``sync()``); synchronous mode returns with
        the futures already resolved.  Returns the number of real
        requests drained.
        """
        with self._drain_lock:
            items = self._wait_and_drain()
            if not items:
                return 0
            reqs = [r for r, _ in items]
            # pad to the bucket so the batch callback always dispatches
            # a bucketed batch; pad payloads clone a
            # real request so any payload-shape assumptions hold
            bb = self.bucket(len(reqs))
            padded = reqs + [Request(self.PAD_ID, reqs[0].payload)
                             for _ in range(bb - len(reqs))]
            with self._lock:
                self.batch_sizes.append(len(reqs))
                self.padded_sizes.append(len(padded))
            if self._dispatch is None:
                try:
                    results = self._process(padded)
                    for (_, fut), res in zip(items, results):
                        fut.set_result(res)
                except BaseException as e:
                    for _, fut in items:
                        fut.set_exception(e)
                return len(items)
            try:
                complete = self._dispatch(padded)
            except BaseException as e:
                for _, fut in items:
                    fut.set_exception(e)
                return len(items)
            self._inflight.append((items, complete))
            # two-in-flight steady state: launching wave N+1 retires
            # wave N — its device work overlapped this launch's host
            # assembly, so the (blocking) completion is cheap by now
            while len(self._inflight) >= self.max_inflight:
                self._retire_oldest_locked()
            return len(items)

    def sync(self) -> None:
        """Retire every outstanding launch (continuous mode quiesce)."""
        with self._drain_lock:
            while self._inflight:
                self._retire_oldest_locked()

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Quiesce AND hold the drain path closed for the scope.

        ``sync()`` alone is not enough for a caller about to mutate
        state a wave reads (the corpus index, the session slab): between
        ``sync()`` returning and the mutation landing, a concurrent
        ``flush_loop_once`` can drain the queue and *launch* a wave
        against the pre-mutation state — whose futures then resolve
        after the mutation call returned (the delete-vs-wave race the
        schedule explorer replays).  ``paused()`` retires every
        outstanding launch and keeps ``_drain_lock`` held until the
        scope exits, so no wave can launch while the caller swaps state
        underneath the batcher.  Queued requests are untouched — they
        dispatch on the first flush after resume, observing the mutated
        state.
        """
        with self._drain_lock:
            while self._inflight:
                self._retire_oldest_locked()
            yield


@guarded_by("_lock", "_lat", "_rr", "calls", "hedges_issued",
            "hedges_won", "failovers")
class HedgedExecutor:
    """First-*successful*-result-wins duplicate dispatch across replicas.

    Winner selection is deterministic: among completed futures the
    primary is considered before the hedge (``wait`` returns an
    unordered set, so ``next(iter(done))`` would make ``hedges_won`` —
    and, worse, *which exception propagates* — depend on set iteration
    order).  A failed completion never wins while another replica is
    still running or succeeded: a primary that fails *before* the hedge
    deadline triggers an immediate failover dispatch to the backup
    (counted in ``failovers``, not ``hedges_issued``), and the call
    raises only when every issued replica failed (then the primary's
    exception propagates).  ``hedges_won`` counts only hedges that
    strictly beat a still-pending primary — a hedge or failover that
    merely rescued a failed primary is not a latency win.

    The latency history backing the adaptive p95 deadline is a bounded
    deque (``lat_window``), so ``_deadline()`` stays O(window) instead
    of percentile-over-all-time-calls, and the deadline tracks the
    *recent* latency distribution at sustained traffic.

    Owns a ``ThreadPoolExecutor`` — ``close()`` (idempotent; also via
    ``with``) shuts it down, or every engine/benchmark rebuild leaks
    2x``len(replicas)`` threads.  ``call`` after ``close`` raises
    ``RuntimeError`` immediately — nothing is ever queued on the
    shut-down pool.

    ``call`` may be invoked from any number of threads concurrently
    (the replica router fronts it with a 2R-worker pool), so the
    round-robin cursor, the counters, and the latency window are
    guarded by ``_lock``; the replica dispatch and the wait loop run
    outside it (holding a lock across a cross-replica RPC would
    serialize the hedging this class exists to provide).
    """

    def __init__(self, replicas: Sequence[Callable[[Any], Any]], *,
                 hedge_quantile: float = 0.95, min_history: int = 8,
                 hedge_floor_s: float = 0.005, lat_window: int = 1024):
        assert len(replicas) >= 1
        self.replicas = list(replicas)
        self.hedge_quantile = hedge_quantile
        self.hedge_floor_s = hedge_floor_s
        self.min_history = min_history
        self._lat: "collections.deque[float]" = collections.deque(
            maxlen=lat_window)
        self._pool = ThreadPoolExecutor(max_workers=2 * len(replicas),
                                        thread_name_prefix="hedge")
        self._lock = threading.Lock()
        self._closed = False
        self._rr = 0
        self.calls = 0
        self.hedges_issued = 0
        self.hedges_won = 0
        self.failovers = 0

    def close(self) -> None:
        """Shut the replica thread pool down (waits for in-flight
        calls).  Idempotent."""
        if not self._closed:
            self._closed = True
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "HedgedExecutor":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def _deadline(self) -> float:
        with self._lock:
            if len(self._lat) < self.min_history:
                return self.hedge_floor_s
            lat = list(self._lat)
        return max(self.hedge_floor_s,
                   float(np.percentile(lat, 100 * self.hedge_quantile)))

    def call(self, payload: Any) -> Any:
        if self._closed:
            raise RuntimeError("HedgedExecutor is closed")
        t0 = time.perf_counter()
        with self._lock:
            self.calls += 1
            primary_idx = self._rr % len(self.replicas)
            self._rr += 1
        primary = self._pool.submit(self.replicas[primary_idx], payload)
        done, _ = wait([primary], timeout=self._deadline())
        futures = [primary]
        backup_idx = (primary_idx + 1) % len(self.replicas)
        hedged: Optional[Future] = None
        if not done and len(self.replicas) > 1:
            hedged = self._pool.submit(self.replicas[backup_idx], payload)
            futures.append(hedged)
            with self._lock:
                self.hedges_issued += 1
        elif (done and len(self.replicas) > 1
              and primary.exception() is not None):
            # primary failed before the hedge deadline: fail over to the
            # backup immediately rather than raising with a healthy
            # replica untried
            hedged = self._pool.submit(self.replicas[backup_idx], payload)
            futures.append(hedged)
            with self._lock:
                self.failovers += 1
        winner: Optional[Future] = None
        pending = set(futures)
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            # deterministic preference: primary before hedge
            ok = [f for f in futures if f in done and f.exception() is None]
            if ok:
                winner = ok[0]
                if winner is hedged and primary in pending:
                    with self._lock:
                        self.hedges_won += 1
                break
        if winner is None:       # every issued replica failed
            winner = primary
        result = winner.result()
        with self._lock:
            self._lat.append(time.perf_counter() - t0)
        return result

    def stats(self) -> Dict[str, float]:
        with self._lock:
            lat = np.asarray(self._lat) if self._lat else np.zeros(1)
            return {"calls": self.calls,
                    "hedges_issued": self.hedges_issued,
                    "hedges_won": self.hedges_won,
                    "failovers": self.failovers,
                    "mean_ms": float(lat.mean() * 1e3),
                    "p99_ms": float(np.percentile(lat, 99) * 1e3)}
