"""Seeded deterministic-schedule exploration for the tsan harness.

Port of ``repro/analysis/schedules.py`` (framework-free: the port keeps
its own copy).

Systematic schedule exploration needs two properties the plain OS
scheduler lacks: *coverage* (interleavings you would wait weeks to see
under natural timing) and *replay* (the same seed must produce the same
interleaving, or a found bug cannot be reproduced).  The explorer gets
both by injecting **deterministic preemptions** at the sanitizer's
instrumented boundaries (lock acquire, event wait, guarded-field
access — ``tsan.Runtime.maybe_preempt``):

  * the decision at the *n*-th boundary of thread *T* is a pure
    function of ``(seed, T.name, n, boundary kind)`` — a stable
    ``crc32`` hash, NOT Python's per-process-randomized ``hash()``
    and NOT wall-clock anything;
  * a "preempt" decision sleeps the thread for a hash-derived duration
    (0 .. ``max_sleep_s``), widening the race window exactly where a
    context switch would hurt;
  * every decision is recorded in a per-thread **trace**, so a test
    can pin determinism by replaying a seed twice and comparing
    traces, and a failure report can name the exact boundary.

Determinism caveat: traces are keyed by thread *name*.  Explicitly
named threads (test clients) replay exactly;
anonymous pool threads get arrival-order names from the pool, so their
traces are only comparable when the scenario drives the pool
deterministically.

``replay`` wires one seed end to end: build a ``tsan.Runtime`` with
the explorer attached, run the scenario under ``instrument`` (+
optional ``watch``), assert no violation was observed, and hand back
the scenario result + the explorer for trace/identity assertions.
The fixed seed matrix ``SEEDS`` (20 schedules) is what
tests/test_torch_concurrency.py replays over the overlapped-wave
batched engine (the reference's scenario A) and a delete racing its
waves (scenario B), and tests/test_torch_router.py over add / delete /
compact broadcast by ``serving.router.ReplicatedSearchEngine`` while
pinned clients query (scenario C).
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import _thread

from repro_torch.analysis import tsan

#: the fixed seed matrix replayed by the CI concurrency job
SEEDS: Tuple[int, ...] = tuple(range(20))


class ScheduleExplorer:
    """Deterministic preemption injector (see module docstring).

    ``hook(kind)`` is called by the instrumented primitives at every
    boundary; it must be cheap when the decision is "run on" (the
    common case) — one counter bump + one crc32.
    """

    def __init__(self, seed: int, *, preempt_prob: float = 0.15,
                 max_sleep_s: float = 5e-4):
        self.seed = int(seed)
        self.preempt_prob = float(preempt_prob)
        self.max_sleep_s = float(max_sleep_s)
        self._mu = _thread.allocate_lock()
        self._counters: Dict[str, int] = {}
        #: thread name -> [(boundary #, kind, preempted)]
        self.traces: Dict[str, List[Tuple[int, str, bool]]] = {}

    def decision(self, tname: str, n: int, kind: str
                 ) -> Tuple[bool, float]:
        """(preempt?, sleep seconds) — pure function of the inputs."""
        h = zlib.crc32(f"{self.seed}|{tname}|{n}|{kind}".encode())
        preempt = (h % 1000) / 1000.0 < self.preempt_prob
        sleep_s = (((h >> 10) % 97) / 96.0) * self.max_sleep_s \
            if preempt else 0.0
        return preempt, sleep_s

    def hook(self, kind: str) -> None:
        # NOT threading.current_thread(): during thread bootstrap the
        # thread is not yet in ``threading._active``, and for such a
        # thread current_thread() constructs a _DummyThread whose
        # __init__ sets an (instrumented) Event — infinite recursion
        # back into this hook.  Resolve the registry directly and skip
        # the bootstrap/teardown boundaries instead; their dummy names
        # would be nondeterministic trace noise anyway.
        t = threading._active.get(_thread.get_ident())
        if t is None:
            return
        tname = t.name
        with self._mu:
            n = self._counters.get(tname, 0)
            self._counters[tname] = n + 1
        preempt, sleep_s = self.decision(tname, n, kind)
        with self._mu:
            self.traces.setdefault(tname, []).append((n, kind, preempt))
        if preempt:
            time.sleep(sleep_s)


def run_threads(targets: Sequence[Callable[[], Any]], *,
                names: Optional[Sequence[str]] = None) -> None:
    """Run ``targets`` on named threads, join all, re-raise the first
    failure.  Under ``tsan.instrument`` the threads are instrumented
    (start/join happens-before edges); deterministic names keep the
    explorer's traces replayable."""
    errs: List[BaseException] = []

    def _wrap(fn: Callable[[], Any]) -> Callable[[], None]:
        def go() -> None:
            try:
                fn()
            except BaseException as e:    # noqa: BLE001 - re-raised
                errs.append(e)
        return go

    threads = [
        threading.Thread(target=_wrap(fn),
                         name=(names[i] if names else f"client-{i}"))
        for i, fn in enumerate(targets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]


def replay(seed: int, scenario: Callable[[tsan.Runtime], Any], *,
           watch_classes: Sequence[type] = (),
           preempt_prob: float = 0.15,
           max_sleep_s: float = 5e-4,
           ) -> Tuple[Any, ScheduleExplorer, tsan.Runtime]:
    """Run ``scenario`` under one seeded schedule, assert race-freedom.

    ``scenario(runtime)`` executes with ``threading`` instrumented (so
    every object it *builds* gets recording locks) and the classes in
    ``watch_classes`` under guarded-field interception.  Raises
    ``AssertionError`` listing every violation if the schedule exposed
    a data race, lock-order inversion, or lockset break; otherwise
    returns (scenario result, explorer, runtime) for bit-identity and
    trace-determinism assertions.
    """
    explorer = ScheduleExplorer(seed, preempt_prob=preempt_prob,
                                max_sleep_s=max_sleep_s)
    rt = tsan.Runtime(schedule=explorer)
    with tsan.instrument(rt):
        if watch_classes:
            with tsan.watch(rt, *watch_classes):
                result = scenario(rt)
        else:
            result = scenario(rt)
    tsan.assert_clean(rt)
    return result, explorer, rt
