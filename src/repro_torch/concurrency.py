"""Concurrency annotations: declared lock→field guard maps.

Port of ``repro/concurrency.py``.  The serving layer is multi-threaded
(client submitters, the flusher, hedge pools), and its correctness
argument — per-session bit-identity under any schedule — rests on a
small set of locking conventions.  This module makes those conventions
*declared* instead of implied, so the dynamic sanitizer
(``repro_torch.analysis.tsan``) can read ``__guarded_fields__`` off the
live class and check, at runtime, that every access to a guarded field
of a *shared* object happens while the owning lock is held — on top of
its vector-clock race detection.  The static ``guarded-fields`` and
``lock-order`` passes (``repro_torch.analysis.guarded_fields`` /
``lock_order``) read the same decorators from the AST.

The decorators are deliberately inert at runtime: they only attach
metadata (``__guarded_fields__`` on classes, ``__holds_locks__`` on
methods) and never wrap calls, so annotated classes pay zero overhead
in production.

Usage::

    @guarded_by("_lock", "_queue", "batch_sizes")
    @guarded_by("_drain_lock", "_inflight")
    class MicroBatcher:
        def __init__(self):
            self._lock = threading.Lock()
            ...

        @holds("_drain_lock")
        def _retire_oldest_locked(self):   # caller holds _drain_lock
            ...

A ``threading.Condition`` built on a declared lock counts as that lock:
``with self._work:`` (where ``self._work = Condition(self._lock)``)
holds the lock guarding the fields declared on ``"_lock"``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Type, TypeVar

_C = TypeVar("_C")
_F = TypeVar("_F", bound=Callable)

#: class attribute holding the declared field → lock-attr mapping
GUARD_ATTR = "__guarded_fields__"
#: function attribute naming locks the *caller* is required to hold
HOLDS_ATTR = "__holds_locks__"


def guarded_by(lock: str, *fields: str) -> Callable[[Type[_C]], Type[_C]]:
    """Class decorator: declare ``fields`` as guarded by ``self.<lock>``.

    Stackable — each application merges into the class's
    ``__guarded_fields__`` dict (field name → lock attribute name).
    Subclasses inherit and may extend the parent's map.
    """
    if not fields:
        raise ValueError("guarded_by needs at least one field name")

    def deco(cls: Type[_C]) -> Type[_C]:
        # copy (never mutate) so a subclass's map doesn't leak upward
        mapping: Dict[str, str] = dict(getattr(cls, GUARD_ATTR, {}))
        for f in fields:
            prev = mapping.get(f)
            if prev is not None and prev != lock:
                raise ValueError(
                    f"field {f!r} already guarded by {prev!r}; cannot "
                    f"re-guard with {lock!r}")
            mapping[f] = lock
        setattr(cls, GUARD_ATTR, mapping)
        return cls
    return deco


def holds(*locks: str) -> Callable[[_F], _F]:
    """Method decorator: the *caller* is contractually holding
    ``self.<lock>`` for each named lock when this method runs (the
    ``_locked``-suffix convention, made machine-readable).  The static
    pass treats the whole body as dominated by those locks; the dynamic
    checker verifies they really are held on entry.
    """
    if not locks:
        raise ValueError("holds needs at least one lock name")

    def deco(fn: _F) -> _F:
        held: Tuple[str, ...] = tuple(getattr(fn, HOLDS_ATTR, ()))
        setattr(fn, HOLDS_ATTR, held + tuple(locks))
        return fn
    return deco


def guard_map(cls: type) -> Dict[str, str]:
    """The declared field → lock-attribute map of ``cls`` ({} if none)."""
    return dict(getattr(cls, GUARD_ATTR, {}))
