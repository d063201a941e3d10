"""The port's scheduler: ``MicroBatcher`` and ``HedgedExecutor``.

``tests/test_serving.py``'s scheduler cases, run against
``repro_torch.serving.scheduler`` (the port keeps its own copy of the
framework-free module): flushes by size and deadline, errors into the
futures, padding to the bucket table (past the largest bucket too), the
condition-variable wake-up, the stats of concurrent flushers, the
continuous mode with two launches in flight and its error paths; hedged
dispatch against a straggler, failing replicas, deterministic winners,
the bounded latency history and ``close``.  The port's classes carry the
reference's ``@guarded_by`` / ``@holds`` declarations.
"""
import time

import pytest

from repro.serving import scheduler as rsched
from repro_torch.concurrency import guard_map
from repro_torch.serving.scheduler import (HedgedExecutor, MicroBatcher,
                                           Request)


@pytest.mark.parametrize("name", ["MicroBatcher", "HedgedExecutor"])
def test_guard_declarations_match_the_reference(name):
    """The same fields guarded by the same locks as the reference's."""
    import repro_torch.serving.scheduler as tsched
    assert guard_map(getattr(tsched, name)) == \
        guard_map(getattr(rsched, name))
    assert guard_map(getattr(tsched, name))


def test_micro_batcher_flushes():
    seen = []

    def process(reqs):
        seen.append(len(reqs))
        return [r.payload * 2 for r in reqs]

    mb = MicroBatcher(process, max_batch=4, max_wait_s=0.01)
    futs = [mb.submit(Request("c", i)) for i in range(6)]
    mb.flush_loop_once()
    mb.flush_loop_once()
    assert [f.result(timeout=1) for f in futs] == [0, 2, 4, 6, 8, 10]
    assert seen[0] == 4 and seen[1] == 2


def test_micro_batcher_propagates_errors():
    def process(reqs):
        raise RuntimeError("boom")

    mb = MicroBatcher(process, max_batch=2, max_wait_s=0.001)
    fut = mb.submit(Request("c", 1))
    mb.flush_loop_once()
    with pytest.raises(RuntimeError):
        fut.result(timeout=1)


def test_micro_batcher_pads_flushes_to_bucket():
    """Every flush reaching the process callback is padded to the next
    bucket with trailing PAD_ID requests — ragged sizes never reach the
    device step."""
    seen = []

    def process(reqs):
        seen.append([r.conv_id for r in reqs])
        return [r.payload * 2 for r in reqs]

    mb = MicroBatcher(process, max_batch=8, max_wait_s=0.001,
                      buckets=(1, 2, 4, 8))
    futs = [mb.submit(Request(f"c{i}", i)) for i in range(3)]
    mb.flush_loop_once()
    assert [f.result(timeout=1) for f in futs] == [0, 2, 4]
    # raw 3 → dispatched 4: one trailing pad row
    assert mb.batch_sizes == [3] and mb.padded_sizes == [4]
    assert len(seen[0]) == 4
    assert seen[0][3] == MicroBatcher.PAD_ID
    assert seen[0][:3] == ["c0", "c1", "c2"]


def test_micro_batcher_bucket_stability():
    """Dispatched batch sizes stay inside the bucket table across ragged
    arrival patterns."""
    lens = []
    mb = MicroBatcher(lambda reqs: [r.payload for r in reqs],
                      max_batch=8, max_wait_s=0.0, buckets=(1, 2, 4, 8))
    for n in (1, 3, 5, 2, 7, 6):
        futs = [mb.submit(Request("c", j)) for j in range(n)]
        mb.flush_loop_once()
        lens.append(n)
        for f in futs:
            f.result(timeout=1)
    assert mb.batch_sizes == lens
    assert set(mb.padded_sizes) <= {1, 2, 4, 8}
    assert mb.padded_sizes == [mb.bucket(n) for n in lens]


def test_hedged_executor_mitigates_straggler():
    def fast(x):
        return ("fast", x)

    def slow(x):
        time.sleep(0.25)
        return ("slow", x)

    # round-robin alternates; hedging should rescue calls landing on slow
    ex = HedgedExecutor([fast, slow], hedge_quantile=0.5, min_history=4,
                        hedge_floor_s=0.02)
    results = [ex.call(i) for i in range(12)]
    st = ex.stats()
    assert st["hedges_issued"] > 0
    assert st["hedges_won"] > 0
    # every call returned a correct payload
    assert all(r[1] == i for i, r in enumerate(results))
    # p99 stays well under the slow replica's latency x2
    assert st["p99_ms"] < 600


def test_hedged_executor_survives_failing_fast_replica():
    """A replica that fails *after* the hedge fired must not poison the
    call: the surviving replica's result is returned, and the rescue is
    not miscounted as a latency win (the hedge did not beat a pending
    primary — the primary completed, with an exception)."""
    def failing(x):
        time.sleep(0.05)
        raise RuntimeError("replica down")

    def slow_ok(x):
        time.sleep(0.12)
        return ("ok", x)

    ex = HedgedExecutor([failing, slow_ok], hedge_floor_s=0.01,
                        min_history=99)
    assert ex.call(7) == ("ok", 7)
    st = ex.stats()
    assert st["hedges_issued"] == 1
    assert st["hedges_won"] == 0


def test_hedged_executor_hedge_win_is_deterministic():
    """hedges_won counts exactly the hedges that strictly beat a
    still-pending primary; a successful primary always wins over a
    hedge that completed in the same wait wake-up."""
    def very_slow(x):
        time.sleep(0.3)
        return ("slow", x)

    def instant(x):
        return ("fast", x)

    ex = HedgedExecutor([very_slow, instant], hedge_floor_s=0.01,
                        min_history=99)
    assert ex.call(1) == ("fast", 1)       # hedge rescued the straggler
    assert ex.stats()["hedges_won"] == 1


def test_hedged_executor_raises_only_when_all_replicas_fail():
    def bad_a(x):
        time.sleep(0.03)
        raise ValueError("a")

    def bad_b(x):
        time.sleep(0.03)
        raise ValueError("b")

    ex = HedgedExecutor([bad_a, bad_b], hedge_floor_s=0.005,
                        min_history=99)
    with pytest.raises(ValueError, match="a"):   # primary's exception
        ex.call(0)
    assert ex.stats()["calls"] == 1


def test_hedged_executor_fails_over_on_fast_primary_failure():
    """A primary that fails *before* the hedge deadline triggers an
    immediate failover to the backup instead of raising with a healthy
    replica untried."""
    def instant_crash(x):
        raise ConnectionError("refused")

    def healthy(x):
        return ("ok", x)

    ex = HedgedExecutor([instant_crash, healthy], hedge_floor_s=0.05,
                        min_history=99)
    assert ex.call(3) == ("ok", 3)
    st = ex.stats()
    assert st["failovers"] == 1
    assert st["hedges_issued"] == 0 and st["hedges_won"] == 0


def test_micro_batcher_pads_drains_beyond_largest_bucket():
    """max_batch above the bucket table gets its own bucket inside the
    batcher itself, so an oversized drain still dispatches bucketed."""
    seen = []
    mb = MicroBatcher(lambda reqs: (seen.append(len(reqs)),
                                    [r.payload for r in reqs])[1],
                      max_batch=64, max_wait_s=0.0, buckets=(1, 2, 4, 8,
                                                            16, 32))
    assert mb.bucket(50) == 64
    futs = [mb.submit(Request("c", j)) for j in range(50)]
    mb.flush_loop_once()
    for f in futs:
        f.result(timeout=1)
    assert seen == [64]
    assert mb.batch_sizes == [50] and mb.padded_sizes == [64]


def test_hedged_executor_latency_history_is_bounded():
    """The adaptive-deadline history is a maxlen deque: _deadline() cost
    stays O(window) and reflects recent traffic, while the calls counter
    keeps the all-time total."""
    ex = HedgedExecutor([lambda x: x], lat_window=4, min_history=2,
                        hedge_floor_s=0.001)
    for i in range(10):
        assert ex.call(i) == i
    assert len(ex._lat) == 4
    assert ex.stats()["calls"] == 10
    assert ex._deadline() >= 0.001


def test_micro_batcher_empty_flush_is_a_noop():
    """An empty queue drains nothing: no callback, no recorded sizes,
    return value 0 — the serving loop can spin on flush_loop_once."""
    calls = []
    mb = MicroBatcher(lambda reqs: (calls.append(len(reqs)),
                                    [r.payload for r in reqs])[1],
                      max_batch=4, max_wait_s=0.0005)
    assert mb.flush_loop_once() == 0
    assert calls == []
    assert mb.batch_sizes == [] and mb.padded_sizes == []


def test_micro_batcher_exact_max_batch_needs_no_padding():
    """A drain of exactly max_batch sits on the bucket boundary: the
    dispatched batch is the raw batch — no pad requests at all."""
    seen_ids = []
    mb = MicroBatcher(lambda reqs: (seen_ids.append(
        [r.conv_id for r in reqs]), [r.payload for r in reqs])[1],
        max_batch=8, max_wait_s=0.0, buckets=(1, 2, 4, 8))
    futs = [mb.submit(Request(f"c{j}", j)) for j in range(8)]
    assert mb.flush_loop_once() == 8
    assert [f.result(timeout=1) for f in futs] == list(range(8))
    assert mb.batch_sizes == [8] and mb.padded_sizes == [8]
    assert MicroBatcher.PAD_ID not in seen_ids[0]


def test_hedged_executor_single_replica_never_hedges():
    """One replica = zero configured hedges: a slow call still returns
    (no backup to race), and nothing is counted as hedge or failover."""
    def slow(x):
        time.sleep(0.02)
        return x * 2

    ex = HedgedExecutor([slow], hedge_floor_s=0.001, min_history=2)
    assert [ex.call(i) for i in range(3)] == [0, 2, 4]
    assert ex.hedges_issued == 0 and ex.failovers == 0
    assert ex.hedges_won == 0


def test_hedged_executor_single_failing_replica_raises():
    """With no backup replica, the primary's exception must propagate
    instead of hanging or hedging."""
    def bad(x):
        raise RuntimeError("replica down")

    ex = HedgedExecutor([bad], hedge_floor_s=0.001)
    with pytest.raises(RuntimeError, match="replica down"):
        ex.call(1)
    assert ex.hedges_issued == 0 and ex.failovers == 0


def test_micro_batcher_stats_consistent_under_concurrent_flushers():
    """Two serving-loop threads hammering flush_loop_once while clients
    submit: the drain path is single-owner and the stats lists are
    guarded by the lock, so batch_sizes/padded_sizes stay zipped
    (len equal, every padded >= raw, all results correct)."""
    import threading

    mb = MicroBatcher(lambda reqs: [r.payload for r in reqs],
                      max_batch=8, max_wait_s=0.0, buckets=(1, 2, 4, 8))
    futs = []
    stop = threading.Event()

    def flusher():
        while not stop.is_set():
            mb.flush_loop_once()

    threads = [threading.Thread(target=flusher) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for j in range(300):
            futs.append((j, mb.submit(Request(f"c{j}", j))))
        assert [f.result(timeout=5) for _, f in futs] == list(range(300))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    while mb.flush_loop_once():
        pass
    assert len(mb.batch_sizes) == len(mb.padded_sizes)
    assert sum(mb.batch_sizes) == 300
    assert all(p >= b and p in (1, 2, 4, 8)
               for b, p in zip(mb.batch_sizes, mb.padded_sizes))


def test_micro_batcher_condvar_wakeup_no_hot_spin():
    """A flusher blocked in flush_loop_once with an empty queue wakes on
    submit (condition variable), and max_wait_s=0 returns immediately
    instead of hot-spinning."""
    import threading

    mb = MicroBatcher(lambda reqs: [r.payload for r in reqs],
                      max_batch=4, max_wait_s=5.0)
    out = []

    def flusher():
        out.append(mb.flush_loop_once())

    t = threading.Thread(target=flusher)
    t.start()
    time.sleep(0.05)                  # flusher is parked on the condvar
    t0 = time.perf_counter()
    futs = [mb.submit(Request("c", j)) for j in range(4)]
    [f.result(timeout=2) for f in futs]
    # the full batch released the flusher long before the 5 s deadline
    assert time.perf_counter() - t0 < 2.0
    t.join(timeout=5)
    assert out == [4]
    # and max_wait_s=0 with an empty queue returns without spinning
    mb0 = MicroBatcher(lambda reqs: [r.payload for r in reqs],
                       max_batch=4, max_wait_s=0.0)
    t0 = time.perf_counter()
    assert mb0.flush_loop_once() == 0
    assert time.perf_counter() - t0 < 0.5


def test_micro_batcher_dispatch_mode_two_in_flight():
    """Continuous mode: a launch's futures resolve only when the batcher
    retires it (max_inflight later launches, or sync()), and the
    completion thunks run in launch order."""
    completed = []

    def dispatch(reqs):
        payloads = [r.payload for r in reqs]

        def complete():
            completed.append(payloads[0])
            return payloads
        return complete

    mb = MicroBatcher(dispatch_batch=dispatch, max_batch=2,
                      max_wait_s=0.0, buckets=(2,), max_inflight=2)
    f01 = [mb.submit(Request(f"c{j}", j)) for j in (0, 1)]
    assert mb.flush_loop_once() == 2
    # one launch in flight: nothing completed, futures pending
    assert mb.inflight == 1 and completed == []
    assert not f01[0].done()
    f23 = [mb.submit(Request(f"c{j}", j)) for j in (2, 3)]
    assert mb.flush_loop_once() == 2
    # second launch hit max_inflight: the FIRST launch retired
    assert mb.inflight == 1 and completed == [0]
    assert [f.result(timeout=1) for f in f01] == [0, 1]
    assert not f23[0].done()
    mb.sync()                          # quiesce retires the rest
    assert mb.inflight == 0 and completed == [0, 2]
    assert [f.result(timeout=1) for f in f23] == [2, 3]


def test_micro_batcher_dispatch_mode_error_paths():
    """Continuous mode errors: a throwing dispatch fails the batch's
    futures immediately; a throwing completion fails them at
    retirement."""
    def bad_dispatch(reqs):
        raise RuntimeError("launch failed")

    mb = MicroBatcher(dispatch_batch=bad_dispatch, max_batch=2,
                      max_wait_s=0.0)
    fut = mb.submit(Request("c", 1))
    mb.flush_loop_once()
    with pytest.raises(RuntimeError, match="launch failed"):
        fut.result(timeout=1)
    assert mb.inflight == 0

    def bad_complete(reqs):
        def complete():
            raise RuntimeError("device error")
        return complete

    mb2 = MicroBatcher(dispatch_batch=bad_complete, max_batch=2,
                       max_wait_s=0.0)
    fut2 = mb2.submit(Request("c", 1))
    mb2.flush_loop_once()
    assert not fut2.done()             # still in flight
    mb2.sync()
    with pytest.raises(RuntimeError, match="device error"):
        fut2.result(timeout=1)


def test_micro_batcher_requires_exactly_one_callback():
    with pytest.raises(ValueError):
        MicroBatcher()
    with pytest.raises(ValueError):
        MicroBatcher(lambda reqs: [], dispatch_batch=lambda reqs: None)


def test_hedged_executor_close_shuts_the_pool_down():
    """close() shuts the replica pool down (idempotently); calls after
    close fail loudly instead of hanging; the context-manager form
    closes on exit."""
    ex = HedgedExecutor([lambda x: x])
    assert ex.call(1) == 1
    ex.close()
    ex.close()                         # idempotent
    assert ex._pool._shutdown
    with pytest.raises(RuntimeError, match="HedgedExecutor is closed"):
        ex.call(2)
    with HedgedExecutor([lambda x: x * 2]) as ex2:
        assert ex2.call(3) == 6
    assert ex2._pool._shutdown
