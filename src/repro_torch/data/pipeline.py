"""Host -> device input pipeline: batching, shuffling, shard-aware
feeding (``repro/data/pipeline.py``).

Deliberately simple and deterministic (seeded): a real pipeline
boundary, host numpy to device tensors placed on a mesh, with
background prefetch.  ``batch_iterator`` draws as the reference's does,
draw for draw (``np.random.default_rng(seed).permutation`` an epoch).
``shard_batch`` places a host batch: with no mesh on one device (cuda
unless given), else each array split along its batch dimension over the
mesh's data axes (``distributed.elastic.place``).
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.distributed import elastic
from repro_torch.distributed.sharding import P


def batch_iterator(arrays: Dict[str, np.ndarray], batch_size: int, *,
                   shuffle: bool = True, seed: int = 0,
                   drop_remainder: bool = True
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch-looping iterator over equally-indexed host arrays."""
    n = len(next(iter(arrays.values())))
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        stop = n - (n % batch_size) if drop_remainder else n
        for s in range(0, stop, batch_size):
            take = idx[s: s + batch_size]
            yield {k: v[take] for k, v in arrays.items()}


def shard_batch(batch: Dict[str, np.ndarray], mesh=None,
                spec_fn: Optional[Callable[[str, np.ndarray], P]] = None,
                *, device=None) -> Dict[str, Any]:
    """Place a host batch.  ``mesh`` None: each array as a tensor on
    ``device`` (default cuda).  Else by ``spec_fn(name, array)``, by
    default the batch dimension over every data-like mesh axis ("pod"
    if present, then "data"), scalars replicated: a dict of
    ``elastic.Placed``."""
    if mesh is None:
        dev = _device.resolve(device)
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in batch.items()}
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def default_spec(name: str, arr: np.ndarray) -> P:
        return P(data_axes) if np.ndim(arr) >= 1 else P()

    spec_fn = spec_fn or default_spec
    return {k: elastic.place(v, spec_fn(k, v), mesh)
            for k, v in batch.items()}


class Prefetcher:
    """Background prefetch of up to ``depth`` items (overlaps host batch
    preparation with the step)."""

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._it = it
        self._q: "collections.deque[Any]" = collections.deque()
        self._depth = depth
        self._lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._sema = threading.Semaphore(0)
        self._thread.start()

    def _fill(self):
        for item in self._it:
            while True:
                with self._lock:
                    if len(self._q) < self._depth:
                        self._q.append(item)
                        self._sema.release()
                        break
                if self._stop:
                    return
                threading.Event().wait(0.001)
            if self._stop:
                return

    def __iter__(self):
        return self

    def __next__(self):
        self._sema.acquire()
        with self._lock:
            return self._q.popleft()

    def close(self):
        self._stop = True
