"""Checkpoint save and restore (``repro/checkpoint/checkpoint.py``).

A checkpoint is one ``ckpt_%010d.npz`` of a tree's leaves under their
``"//"``-joined names; the launcher's tree is ``{"params":
model.state_dict(), "opt": optimizer.state_dict()["state"]}`` (every
parameter, every moment and step).  The write is an atomic publish:
``.tmp.npz``, fsync, rename, so a crash mid-write never leaves a
half-written latest checkpoint.  ``restore`` reads into the shapes of a
template tree (``KeyError`` on a missing leaf, ``ValueError`` on a shape
mismatch) and returns host arrays; ``load_into`` copies them into the
template's own tensors in place, each in its dtype.  ``AsyncCheckpointer``
copies the tree to the host on the caller's thread and writes it on
another, one write in flight; a failed write raises at the next ``wait``
or ``save``.  bfloat16 leaves are stored as their 16-bit patterns.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

SEP = "//"


def _items(tree: Any, prefix: str = ""):
    """(key, leaf) of every tensor or array leaf, dict keys and list
    positions joined by ``SEP``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{SEP}{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{SEP}{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _host(x) -> np.ndarray:
    """A leaf as a host array (bfloat16 as its 16-bit patterns)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        # a CPU tensor's numpy() shares its memory: copy it, so that the
        # caller may update the tensor while the write is in flight
        return x.numpy().copy() if x.device.type == "cpu" else \
            x.cpu().numpy()
    return np.array(x)


def flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in _items(tree)}


def _path(directory: str, step: int, prefix: str) -> str:
    return os.path.join(directory, f"{prefix}_{step:010d}.npz")


def save(directory: str, step: int, tree: Any, *, prefix: str = "ckpt"
         ) -> str:
    """Atomic checkpoint write of a tree.  Returns the final path."""
    return _write(directory, step, flatten(tree), prefix)


def _write(directory: str, step: int, flat: Dict[str, np.ndarray],
           prefix: str) -> str:
    """``.tmp.npz``, fsync, rename: a reader never sees a partial file."""
    os.makedirs(directory, exist_ok=True)
    final = _path(directory, step, prefix)
    tmp = final + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)
    return final


def list_steps(directory: str, prefix: str = "ckpt") -> List[int]:
    if not os.path.isdir(directory):
        return []
    pat = re.compile(rf"{re.escape(prefix)}_(\d+)\.npz$")
    return sorted(int(m.group(1)) for m in map(pat.match,
                                               os.listdir(directory)) if m)


def latest_step(directory: str, prefix: str = "ckpt") -> Optional[int]:
    steps = list_steps(directory, prefix)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like: Any, *, prefix: str = "ckpt"
            ) -> Dict[str, np.ndarray]:
    """The leaves of ``like``'s keys from checkpoint ``step``, as host
    arrays by key.  ``KeyError`` on a leaf the checkpoint lacks,
    ``ValueError`` on a shape that differs from the template's."""
    with np.load(_path(directory, step, prefix)) as z:
        flat = {k: z[k] for k in z.files}
    out = {}
    for key, leaf in _items(like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key!r}: ckpt "
                             f"{arr.shape} vs template {tuple(leaf.shape)}")
        out[key] = arr
    return out


@torch.no_grad()
def load_into(like: Any, flat: Dict[str, np.ndarray]) -> None:
    """Copy ``restore``'s arrays into the template's tensors in place,
    each in its own dtype and device (bfloat16 from its bits)."""
    for key, t in _items(like):
        arr = torch.from_numpy(np.array(flat[key]))
        if t.dtype == torch.bfloat16:
            arr = arr.view(torch.bfloat16)
        t.copy_(arr.to(t.dtype))


def keep_last_k(directory: str, k: int, prefix: str = "ckpt") -> None:
    steps = list_steps(directory, prefix)
    for s in steps[:-k] if k > 0 else []:
        try:
            os.remove(_path(directory, s, prefix))
        except OSError:
            pass


class AsyncCheckpointer:
    """Background checkpoint writer (one write in flight)."""

    def __init__(self, directory: str, *, keep: int = 3,
                 prefix: str = "ckpt"):
        self.directory = directory
        self.keep = keep
        self.prefix = prefix
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        """Wait for the write in flight, copy ``tree`` to the host (on
        this thread: the caller may update the tensors right after), then
        write it on another thread."""
        self.wait()
        host = flatten(tree)

        def work():
            try:
                _write(self.directory, step, host, self.prefix)
                keep_last_k(self.directory, self.keep, self.prefix)
            except BaseException as e:   # surfaced at the next wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
