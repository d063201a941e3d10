"""Device-resident session store for batched conversational serving.

Port of ``repro/serving/sessions.py``.  The sequential engine keeps one
``IVFSession`` per conversation in a Python dict — fine for one turn at
a time, useless for batched dispatch (B separate sessions would need B
gathers anyway).  ``SessionStore`` instead keeps *one* struct-of-arrays
slab per field with a fixed slot count:

    cache_ids  (S+1, h)      int32      anchor_sel (S+1, np) int32
    cache_vecs (S+1, h, d)   float32    refreshes  (S+1,)    int32
    turn       (S+1,)        int32

so serving a micro-batch is: gather B rows (``index_select``) → one
batched step → scatter B rows back (``index_copy_``, in place: the
counterpart of the reference's donated ``_scatter_slab``).  Slot
bookkeeping (conv_id → slot, free list, LRU eviction) is host-side
Python — O(B) dict work per flush that never touches device memory.

Slot model
  * ``n_slots`` live slots are allocated from a free list; slot ids are
    stable for the lifetime of a conversation (sticky sessions).
  * One extra **trash slot** (index ``n_slots``) absorbs the padded rows
    of a partially-filled device batch: padded rows gather/scatter the
    trash row, so they run the full batched step without ever corrupting
    a live session.  Several pad rows scatter to the trash row in one
    call; which of them ``index_copy_`` keeps is unspecified, which is
    harmless only because no conversation ever maps to the trash slot.
  * When the store is full, the least-recently-served conversation is
    evicted.  An evicted conversation that returns is treated as a first
    turn again (its C0 cache is rebuilt from the current utterance) —
    the same semantics as a TopLoc_IVF+ refresh.

Streams.  On CUDA the store is given the engine's stream, and every
gather, scatter and clear runs on it (``on_stream``), whichever thread
calls: in PyTorch the current stream is per thread, and ``release``
arrives on *client* threads (``end_conversation``).  A wave's scatter is
queued before the next wave's gather on that one stream, so in-order
execution gives the next wave the updated rows, as the reference's
single device stream does.  A caller on another stream is ordered both
ways against the store's (``Stream.wait_stream``; no host sync).

The slab's layout is the backend's ``session_template``: the rows
above for IVF and IVF-PQ, ``entry_point`` (S+1,) int32 and ``turn``
(S+1,) int32 for HNSW.  The corpus mesh of the reference (``mesh=``, a
slab replicated over the sharded corpus) comes with ROADMAP Queue 1,
item 6.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.concurrency import guarded_by


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the fields of one or more NamedTuples of tensors."""
    return type(trees[0])(*(fn(*xs) for xs in zip(*trees)))


@contextlib.contextmanager
def on_stream(stream: Optional["torch.cuda.Stream"]
              ) -> Iterator[Optional["torch.cuda.Stream"]]:
    """Run the block on ``stream`` (None: the caller's current stream).

    When the caller's current stream is another one, ``stream`` first
    waits for it (the block may read what the caller queued) and the
    caller's stream waits for ``stream`` after the block (the caller may
    read what the block wrote); both are device-side waits.  Yields the
    caller's stream when it differs from ``stream``, else None: a tensor
    the block allocates and the caller keeps must then be
    ``record_stream``-ed to it.
    """
    if stream is None:
        yield None
        return
    caller = torch.cuda.current_stream(stream.device)
    if caller == stream:
        yield None
        return
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        yield caller
    caller.wait_stream(stream)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on CUDA through pinned memory with a
    non-blocking copy on the current stream, so the host does not wait
    for the stream to drain (a pageable copy would)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _scatter_slab(slab: Any, idx: torch.Tensor, updates: Any) -> None:
    """Write batched session rows into the slab in place."""
    for a, u in zip(slab, updates):
        a.index_copy_(0, idx, u.to(a.dtype))


@guarded_by("_lock", "_slab", "_slot_of", "_free",
            "allocs", "evictions", "hits")
class SessionStore:
    """Fixed-capacity struct-of-arrays slab of per-conversation state.

    Thread safety: slot bookkeeping and the slab are guarded by an
    internal ``RLock`` (reentrant because ``acquire``/``release`` scatter
    through ``self.scatter`` while already holding it).  The batched
    engine serialises its wave path through the MicroBatcher's drain
    lock, but ``release`` arrives on *client* threads
    (``end_conversation``) — without the store lock, a release racing a
    wave's ``acquire`` could interleave the free-list append with an LRU
    eviction and hand one slot to two conversations.  Lock order is
    always batcher drain lock → store lock, never the reverse.
    """

    def __init__(self, template: Any, n_slots: int, *, mesh: Any = None,
                 stream: Optional["torch.cuda.Stream"] = None):
        """``template``: one session's NamedTuple of tensors (no leading
        batch dim), whose shapes, dtypes and device define the slab.
        ``stream``: the CUDA stream every slab access runs on (None: the
        caller's current stream)."""
        if mesh is not None:
            raise NotImplementedError(
                "a session slab replicated over a corpus mesh is not "
                "ported yet: ROADMAP Queue 1, item 6")
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self.device = template[0].device
        self._stream = stream
        with on_stream(stream):
            self._slab = tree_map(
                lambda a: torch.zeros((n_slots + 1,) + tuple(a.shape),
                                      dtype=a.dtype, device=a.device),
                template)
            # the all-zero row scattered over released slots
            self._zero_row = tree_map(
                lambda a: torch.zeros((1,) + tuple(a.shape), dtype=a.dtype,
                                      device=a.device), template)
        self._lock = threading.RLock()
        self._free = list(range(n_slots - 1, -1, -1))   # pop() → slot 0 first
        self._slot_of: "OrderedDict[str, int]" = OrderedDict()  # LRU order
        self._slot_freed_listeners: list = []
        self.allocs = 0
        self.evictions = 0
        self.hits = 0

    # -- slot bookkeeping (host) --------------------------------------

    @property
    def trash_slot(self) -> int:
        """Slot absorbing padded batch rows; never mapped to a conv."""
        return self.n_slots

    def add_slot_freed_listener(self, fn) -> None:
        """Register ``fn(slot)`` to run whenever a slot leaves its
        conversation (release or LRU eviction), *after* the slab row has
        been zeroed.  Companion per-slot state — the result cache's slab
        (``serving.result_cache``) — hooks in here so a recycled slot can
        never leak another conversation's entries."""
        self._slot_freed_listeners.append(fn)

    def _notify_slot_freed(self, slot: int) -> None:
        for fn in self._slot_freed_listeners:
            fn(slot)

    @property
    def occupancy(self) -> int:
        with self._lock:
            return len(self._slot_of)

    def lookup(self, conv_id: str) -> Optional[int]:
        with self._lock:
            return self._slot_of.get(conv_id)

    def acquire(self, conv_id: str) -> Tuple[int, bool]:
        """Slot for ``conv_id``; allocates (evicting LRU if full).

        Returns (slot, is_new) — ``is_new`` means the slot holds no state
        for this conversation and the caller must treat the turn as a
        first turn (full cache build).
        """
        with self._lock:
            slot = self._slot_of.get(conv_id)
            if slot is not None:
                self._slot_of.move_to_end(conv_id)
                self.hits += 1
                return slot, False
            if not self._free:
                lru_id, lru_slot = next(iter(self._slot_of.items()))
                del self._slot_of[lru_id]
                self._free.append(lru_slot)
                self.evictions += 1
                # the evicted row is wiped before the slot changes hands,
                # so the new occupant can never read the evicted
                # conversation's cache
                self.scatter([lru_slot], self._zero_row)
                self._notify_slot_freed(lru_slot)
            slot = self._free.pop()
            self._slot_of[conv_id] = slot
            self.allocs += 1
            return slot, True

    def release(self, conv_id: str) -> Optional[int]:
        """End a conversation; its slot returns to the free list.

        The released slab row is zeroed so a freed slot can never leak
        the prior conversation's centroid cache to a later occupant.
        Idempotent: releasing an unknown or already-released ``conv_id``
        is a no-op returning ``None`` (the slot is never double-appended
        to the free list, which would hand one slot to two
        conversations).
        """
        with self._lock:
            slot = self._slot_of.pop(conv_id, None)
            if slot is not None:
                self._free.append(slot)
                self.scatter([slot], self._zero_row)
                self._notify_slot_freed(slot)
            return slot

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"n_slots": self.n_slots, "occupancy": self.occupancy,
                    "allocs": self.allocs, "evictions": self.evictions,
                    "hits": self.hits}

    # -- device slab access -------------------------------------------

    def _index(self, slots) -> torch.Tensor:
        if isinstance(slots, torch.Tensor):
            return slots
        return to_device(np.asarray(slots, np.int64), self.device)

    def gather(self, slots) -> Any:
        """Session batch for ``slots`` (leading dim len(slots)), usable
        on the caller's current stream.  ``slots``: ints, or an int64
        tensor of them on the store's device (a wave copies its slots
        there once for all its gathers and scatters)."""
        with self._lock, on_stream(self._stream) as caller:
            idx = self._index(slots)
            rows = tree_map(lambda a: a.index_select(0, idx), self._slab)
            if caller is not None:
                for t in rows:
                    t.record_stream(caller)
            return rows

    def scatter(self, slots, sessions: Any) -> None:
        """Write a batched session back into the slab rows (``slots`` as
        ``gather``'s).

        ``slots`` may repeat only on the trash slot (padded rows);
        live-slot rows must be unique within one call — the batched
        engine guarantees one turn per conversation per device batch.
        """
        with self._lock, on_stream(self._stream):
            _scatter_slab(self._slab, self._index(slots), sessions)

    def clear(self, slots: Sequence[int]) -> None:
        """Zero the given slab rows in one scatter (the zero row is
        expanded to the batch, not dispatched once per slot)."""
        slots = list(slots)
        if not slots:
            return
        tiled = tree_map(
            lambda a: a.expand((len(slots),) + tuple(a.shape[1:])),
            self._zero_row)
        self.scatter(slots, tiled)

    def restore(self, slab: Any, slot_of: Sequence[Tuple[str, int]],
                free: Sequence[int]) -> None:
        """Take over another store's state: ``slab`` (every row, leading
        dim ``n_slots + 1``; ``convert`` turns the reference's into the
        port's), its conversation → slot map in LRU order (least recent
        first) and its free list (popped from the end), so later turns
        land on the slots they would have had there."""
        with self._lock:
            self.scatter(range(self.n_slots + 1), slab)
            self._slot_of = OrderedDict(slot_of)
            self._free = list(free)

    @property
    def slab(self) -> Any:
        """The raw slab (leading dim ``n_slots + 1``), written in place on
        the store's stream.  Read-only view for bulk inspection (the
        result cache's tombstone sweep reads it inside ``on_stream``);
        mutate only through ``scatter``/``clear``."""
        with self._lock:
            return self._slab

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        return self._stream


def store_for_backend(backend: Any, index: Any, *, n_slots: int,
                      mesh: Any = None,
                      stream: Optional["torch.cuda.Stream"] = None
                      ) -> Optional[SessionStore]:
    """Slab sized by ``backend.session_template(index)`` — the generic
    constructor both engines use.  Returns None for stateless backends
    (no per-conversation state)."""
    template = backend.session_template(index)
    if template is None:
        return None
    return SessionStore(template, n_slots, mesh=mesh, stream=stream)


def ivf_session_store(index: Any, *, h: int, nprobe: int, n_slots: int,
                      mesh: Any = None,
                      stream: Optional["torch.cuda.Stream"] = None
                      ) -> SessionStore:
    """Slab of ``toploc.IVFSession`` rows sized for ``index`` (reads only
    the ``.d``/``.centroids`` fields both IVF index types share), on the
    index's device."""
    from repro_torch.core import backend as _backend
    return store_for_backend(_backend.IVFBackend(h=h, nprobe=nprobe),
                             index, n_slots=n_slots, mesh=mesh,
                             stream=stream)


def ivf_pq_session_store(index: Any, *, h: int, nprobe: int, n_slots: int,
                         mesh: Any = None,
                         stream: Optional["torch.cuda.Stream"] = None
                         ) -> SessionStore:
    """Slab for the IVF-PQ backend: TopLoc_IVFPQ reuses the
    ``IVFSession`` layout unchanged (only the list scan differs)."""
    return ivf_session_store(index, h=h, nprobe=nprobe, n_slots=n_slots,
                             mesh=mesh, stream=stream)


def hnsw_session_store(index: Any, *, n_slots: int, mesh: Any = None,
                       stream: Optional["torch.cuda.Stream"] = None
                       ) -> SessionStore:
    """Slab of ``toploc.HNSWSession`` rows, on the index's device."""
    from repro_torch.core import backend as _backend
    return store_for_backend(_backend.HNSWBackend(), index, n_slots=n_slots,
                             mesh=mesh, stream=stream)
