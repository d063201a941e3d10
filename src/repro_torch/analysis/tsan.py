"""Dynamic concurrency sanitizer: instrumented ``threading`` shim.

Port of ``repro/analysis/tsan.py`` (framework-free: the port keeps its
own copy).  The static passes (``lock_order`` / ``guarded_fields``,
in both packages) reason about the AST; this module checks the same
invariants on a *live* schedule, the way TSan does for native code:

  * ``instrument(runtime)`` monkeypatches ``threading.Lock`` /
    ``RLock`` / ``Event`` / ``Thread`` with recording wrappers (the
    stdlib ``Condition`` composes with the wrapped locks through its
    documented fallback protocol, so ``Condition(self._lock)`` is
    instrumented for free).  Every acquisition records (a) the
    **lock-order graph** — an edge L→K whenever K is acquired while L
    is held; a new edge that closes a cycle is reported as a
    lock-order inversion — and (b) **happens-before** edges via vector
    clocks: release→acquire on the same lock, thread start→run and
    exit→join, event set→wait.
  * ``watch(runtime, Cls, …)`` patches ``__getattribute__`` /
    ``__setattr__`` on classes annotated with
    ``repro_torch.concurrency.guarded_by`` so every access to a declared
    field is checked two ways: FastTrack-style vector-clock **race
    detection** (two accesses, ≥ one write, unordered by
    happens-before) and a **lockset check** (the declared owning lock
    must actually be held once the object is shared between threads).
  * ``runtime.schedule`` may hold a ``schedules.ScheduleExplorer``;
    the wrappers call its ``hook`` at every instrumented boundary, so
    the explorer can inject deterministic preemptions (sleeps) and
    steer the interleaving — seeded schedule replay.

Wrappers go inert the moment ``instrument`` exits (``runtime.active``
flips off and the real classes are restored), so objects that outlive
the context keep working at full speed.

Usage::

    rt = Runtime(schedule=ScheduleExplorer(seed=7))
    with instrument(rt):
        eng = BatchedConversationalSearchEngine(...)   # built inside!
        with watch(rt, MicroBatcher, SessionStore):
            ... run threaded traffic ...
    assert_clean(rt)
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

import _thread

from repro_torch.concurrency import GUARD_ATTR

_RawLock = _thread.allocate_lock
_get_ident = threading.get_ident

# real classes, captured at import so wrappers survive the patch
_RealLock = threading.Lock
_RealRLock = threading.RLock
_RealEvent = threading.Event
_RealThread = threading.Thread


@dataclasses.dataclass(frozen=True)
class Report:
    """One observed violation (data race / inversion / lockset)."""

    kind: str       # "race" | "lock-order" | "lockset"
    message: str

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return f"[{self.kind}] {self.message}"


def _join(dst: Dict[int, int], src: Dict[int, int]) -> None:
    for t, c in src.items():
        if dst.get(t, 0) < c:
            dst[t] = c


def _creation_site(depth: int = 3) -> str:
    f = sys._getframe(depth)
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


class _VarState:
    """FastTrack-lite per-(object, field) access history."""

    __slots__ = ("w", "reads")

    def __init__(self) -> None:
        self.w: Optional[Tuple[int, int]] = None   # (tid, clock)
        self.reads: Dict[int, int] = {}            # tid -> clock


class Runtime:
    """Shared state of one sanitizer session (vector clocks, lock
    graph, reports).  All mutation happens under one raw internal lock
    (``_thread.allocate_lock`` — the patched ``threading.Lock`` must
    never be used here, or instrumentation would recurse)."""

    def __init__(self, schedule: Any = None):
        self.schedule = schedule
        self.active = False
        self.reports: List[Report] = []
        self._mu = _RawLock()
        self._vc: Dict[int, Dict[int, int]] = {}
        self._held: Dict[int, List[Any]] = {}        # tid -> lock stack
        self._edges: Dict[int, Set[int]] = {}        # lock-id graph
        self._edge_seen: Set[Tuple[int, int]] = set()
        self._lock_names: Dict[int, str] = {}
        self._vars: Dict[Tuple[int, str], _VarState] = {}
        self._obj_tids: Dict[int, Set[int]] = {}
        self._reported: Set[Tuple] = set()
        self._tls = threading.local()
        # OS thread idents are recycled the moment a thread exits; two
        # short-lived threads can share one ident, which would fuse
        # their vector clocks and hide real races.  All bookkeeping
        # therefore runs on *logical* tids: allocated on first sight of
        # an ident, retired at child_end so a recycled ident gets a
        # fresh logical identity.
        self._logical: Dict[int, int] = {}
        self._next_tid = 0

    # -- schedule hook -------------------------------------------------

    def maybe_preempt(self, kind: str) -> None:
        """Give the schedule explorer a preemption opportunity.  Never
        called while ``_mu`` is held (the injected sleep must extend
        *application* critical sections, not the sanitizer's).  A
        per-thread reentrancy guard keeps the hook from recursing when
        the explorer itself touches an instrumented primitive."""
        sched = self.schedule
        if sched is None or not self.active:
            return
        if getattr(self._tls, "in_hook", False):
            return
        self._tls.in_hook = True
        try:
            sched.hook(kind)
        finally:
            self._tls.in_hook = False

    # -- reporting -----------------------------------------------------

    def _report(self, key: Tuple, kind: str, message: str) -> None:
        if key in self._reported:
            return
        self._reported.add(key)
        self.reports.append(Report(kind=kind, message=message))

    # -- vector clocks -------------------------------------------------

    def _tid_locked(self) -> int:
        """Logical tid for the calling thread (``_mu`` must be held)."""
        ident = _get_ident()
        t = self._logical.get(ident)
        if t is None:
            t = self._logical[ident] = self._next_tid
            self._next_tid += 1
        return t

    def _vc_of(self, tid: int) -> Dict[int, int]:
        vc = self._vc.get(tid)
        if vc is None:
            vc = self._vc[tid] = {tid: 1}
        return vc

    def fork_vc(self) -> Dict[int, int]:
        """Parent side of a thread start: snapshot + advance."""
        with self._mu:
            tid = self._tid_locked()
            vc = self._vc_of(tid)
            snap = dict(vc)
            vc[tid] = vc.get(tid, 0) + 1
        return snap

    def child_begin(self, parent_vc: Optional[Dict[int, int]]) -> None:
        with self._mu:
            vc = self._vc_of(self._tid_locked())
            if parent_vc:
                _join(vc, parent_vc)

    def child_end(self) -> Dict[int, int]:
        with self._mu:
            snap = dict(self._vc_of(self._tid_locked()))
            # retire the ident→logical mapping: the OS may hand this
            # ident to the next thread the moment we exit
            self._logical.pop(_get_ident(), None)
            return snap

    def join_vc(self, child_vc: Optional[Dict[int, int]]) -> None:
        with self._mu:
            if child_vc:
                _join(self._vc_of(self._tid_locked()), child_vc)

    # -- lock events ---------------------------------------------------

    def note_acquire(self, lock: Any) -> None:
        with self._mu:
            tid = self._tid_locked()
            held = self._held.setdefault(tid, [])
            for h in held:
                if h is not lock:
                    self._add_edge(h, lock)
            held.append(lock)
            _join(self._vc_of(tid), lock._release_vc)

    def note_release(self, lock: Any) -> None:
        with self._mu:
            tid = self._tid_locked()
            held = self._held.get(tid, [])
            if lock in held:
                # remove the most recent acquisition
                for i in range(len(held) - 1, -1, -1):
                    if held[i] is lock:
                        del held[i]
                        break
            vc = self._vc_of(tid)
            lock._release_vc = dict(vc)
            vc[tid] = vc.get(tid, 0) + 1

    def _add_edge(self, a: Any, b: Any) -> None:
        ka, kb = id(a), id(b)
        if (ka, kb) in self._edge_seen:
            return
        self._edge_seen.add((ka, kb))
        # does b already reach a?  then a→b closes a cycle
        if self._reaches(kb, ka):
            self._report(
                ("lock-order", ka, kb), "lock-order",
                f"lock-order inversion: `{self._name(a)}` acquired "
                f"before `{self._name(b)}` here, but the opposite "
                f"order was also observed")
        self._edges.setdefault(ka, set()).add(kb)

    def _reaches(self, src: int, dst: int) -> bool:
        seen: Set[int] = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._edges.get(n, ()))
        return False

    def _name(self, lock: Any) -> str:
        return self._lock_names.get(id(lock), "lock")

    def register_lock(self, lock: Any, name: str) -> None:
        with self._mu:
            self._lock_names[id(lock)] = name

    def holds(self, lock: Any) -> bool:
        with self._mu:
            tid = self._tid_locked()
            return any(h is lock for h in self._held.get(tid, []))

    # -- guarded-field events ------------------------------------------

    def on_field(self, obj: Any, name: str, lockname: str,
                 write: bool) -> None:
        cls = type(obj).__name__
        with self._mu:
            tid = self._tid_locked()
            tids = self._obj_tids.setdefault(id(obj), set())
            tids.add(tid)
            shared = len(tids) > 1
            vc = self._vc_of(tid)
            # lockset: the declared owner must actually be held
            if shared:
                try:
                    lock = object.__getattribute__(obj, lockname)
                except AttributeError:
                    lock = None
                if lock is not None and hasattr(lock, "_release_vc") \
                        and not any(h is lock for h in
                                    self._held.get(tid, [])):
                    self._report(
                        ("lockset", id(obj), name, write), "lockset",
                        f"{'write' if write else 'read'} of "
                        f"`{cls}.{name}` (guarded by `{lockname}`) "
                        f"without holding the lock, on shared object")
            # FastTrack-lite race detection
            st = self._vars.setdefault((id(obj), name), _VarState())
            me = vc.get(tid, 1)
            if st.w is not None:
                wt, wc = st.w
                if wt != tid and vc.get(wt, 0) < wc:
                    self._report(
                        ("race", id(obj), name,
                         "w" if write else "r"), "race",
                        f"data race on `{cls}.{name}`: "
                        f"{'write' if write else 'read'} unordered "
                        f"with a previous write (no happens-before "
                        f"edge between the threads)")
            if write:
                for rt_, rc in st.reads.items():
                    if rt_ != tid and vc.get(rt_, 0) < rc:
                        self._report(
                            ("race", id(obj), name, "rw"), "race",
                            f"data race on `{cls}.{name}`: write "
                            f"unordered with a previous read")
                        break
                st.w = (tid, me)
                st.reads = {}
            else:
                st.reads[tid] = me


# -- wrapper classes ---------------------------------------------------


class _LockWrapper:
    """Recording stand-in for ``threading.Lock``.  Also satisfies the
    stdlib ``Condition`` fallback protocol (plain acquire/release), so
    ``Condition(wrapped_lock)`` works unmodified."""

    _kind = "Lock"

    def __init__(self, rt: Runtime):
        self._rt = rt
        self._raw = _RawLock()
        self._release_vc: Dict[int, int] = {}
        rt.register_lock(self, f"{self._kind}@{_creation_site()}")

    def acquire(self, blocking: bool = True, timeout: float = -1):
        rt = self._rt
        if rt.active and blocking:
            rt.maybe_preempt("lock-acquire")
        ok = (self._raw.acquire(True, timeout) if blocking
              else self._raw.acquire(False))
        if ok and rt.active:
            rt.note_acquire(self)
        return ok

    def release(self) -> None:
        if self._rt.active:
            self._rt.note_release(self)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class _RLockWrapper:
    """Recording stand-in for ``threading.RLock`` — only the outermost
    acquire/release of a reentrant series is recorded."""

    _kind = "RLock"

    def __init__(self, rt: Runtime):
        self._rt = rt
        self._raw = _RealRLock()
        self._release_vc: Dict[int, int] = {}
        self._owner: Optional[int] = None
        self._depth = 0
        rt.register_lock(self, f"{self._kind}@{_creation_site()}")

    def acquire(self, blocking: bool = True, timeout: float = -1):
        rt = self._rt
        tid = _get_ident()
        outer = self._owner != tid
        if rt.active and blocking and outer:
            rt.maybe_preempt("lock-acquire")
        ok = (self._raw.acquire(True, timeout) if blocking
              else self._raw.acquire(False))
        if ok:
            # owner/depth only ever touched while the raw lock is held
            self._owner = tid
            self._depth += 1
            if self._depth == 1 and rt.active:
                rt.note_acquire(self)
        return ok

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
            if self._rt.active:
                self._rt.note_release(self)
        self._raw.release()

    def _is_owned(self) -> bool:
        return self._owner == _get_ident()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class _EventWrapper:
    """Recording stand-in for ``threading.Event`` with a set→wait
    happens-before edge."""

    def __init__(self, rt: Runtime):
        self._rt = rt
        self._raw = _RealEvent()
        self._set_vc: Dict[int, int] = {}

    def set(self) -> None:
        rt = self._rt
        if rt.active:
            with rt._mu:
                tid = rt._tid_locked()
                vc = rt._vc_of(tid)
                _join(self._set_vc, vc)
                vc[tid] = vc.get(tid, 0) + 1
        self._raw.set()

    def clear(self) -> None:
        self._raw.clear()

    def is_set(self) -> bool:
        return self._raw.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        rt = self._rt
        if rt.active:
            rt.maybe_preempt("event-wait")
        ok = self._raw.wait(timeout)
        if ok and rt.active:
            with rt._mu:
                _join(rt._vc_of(rt._tid_locked()), self._set_vc)
        return ok


@contextlib.contextmanager
def instrument(runtime: Runtime):
    """Patch ``threading`` so every Lock/RLock/Event/Thread created in
    the scope records into ``runtime``.  Restores the real classes on
    exit and flips ``runtime.active`` off, leaving escaped wrappers
    inert."""

    def _lock() -> _LockWrapper:
        return _LockWrapper(runtime)

    def _rlock() -> _RLockWrapper:
        return _RLockWrapper(runtime)

    def _event() -> _EventWrapper:
        return _EventWrapper(runtime)

    class _Thread(_RealThread):
        """Thread with start→run / exit→join happens-before edges."""

        def start(self) -> None:
            if runtime.active:
                self._tsan_parent_vc = runtime.fork_vc()
            super().start()

        def run(self) -> None:
            if runtime.active:
                runtime.child_begin(
                    getattr(self, "_tsan_parent_vc", None))
            try:
                super().run()
            finally:
                if runtime.active:
                    self._tsan_final_vc = runtime.child_end()

        def join(self, timeout: Optional[float] = None) -> None:
            super().join(timeout)
            if runtime.active and not self.is_alive():
                runtime.join_vc(getattr(self, "_tsan_final_vc", None))

    saved = (threading.Lock, threading.RLock, threading.Event,
             threading.Thread)
    threading.Lock = _lock
    threading.RLock = _rlock
    threading.Event = _event
    threading.Thread = _Thread
    runtime.active = True
    try:
        yield runtime
    finally:
        runtime.active = False
        (threading.Lock, threading.RLock, threading.Event,
         threading.Thread) = saved


@contextlib.contextmanager
def watch(runtime: Runtime, *classes: type):
    """Intercept every access to the ``@guarded_by`` fields of
    ``classes`` (lockset + race checks).  Class-wide: affects all live
    instances for the duration of the scope."""
    saved = []
    for cls in classes:
        guarded: Dict[str, str] = dict(getattr(cls, GUARD_ATTR, {}))
        if not guarded:
            continue
        orig_get = cls.__getattribute__
        orig_set = cls.__setattr__

        def _make(guarded=guarded, orig_get=orig_get,
                  orig_set=orig_set):
            def __getattribute__(obj, name):
                if name in guarded and runtime.active:
                    runtime.maybe_preempt("field-read")
                    runtime.on_field(obj, name, guarded[name],
                                     write=False)
                return orig_get(obj, name)

            def __setattr__(obj, name, value):
                if name in guarded and runtime.active:
                    runtime.maybe_preempt("field-write")
                    runtime.on_field(obj, name, guarded[name],
                                     write=True)
                orig_set(obj, name, value)
            return __getattribute__, __setattr__

        cls.__getattribute__, cls.__setattr__ = _make()
        saved.append((cls, orig_get, orig_set))
    try:
        yield runtime
    finally:
        for cls, g, s in saved:
            cls.__getattribute__ = g
            cls.__setattr__ = s


def assert_clean(runtime: Runtime) -> None:
    """Raise with every report if the session observed any violation."""
    if runtime.reports:
        lines = "\n".join(f"  {r}" for r in runtime.reports)
        raise AssertionError(
            f"{len(runtime.reports)} concurrency violation(s):\n{lines}")
