"""Production and debug meshes (``repro/launch/mesh.py``).

A mesh here is a grid of named axes.  ``make_production_mesh`` is
**logical**: the reference's shapes and axis names with no devices
behind them, the counterpart of the 512 forced host devices the
reference's dry-run lowers for (``repro/launch/dryrun.py:1-2``).  The
dry-run (``launch.dryrun``) reads its sizes and places nothing on it.

  single-pod:  (16, 16)      = 256 devices, axes ("data", "model")
  multi-pod:   (2, 16, 16)   = 512 devices, axes ("pod", "data", "model")

``make_debug_mesh`` puts a device at every coordinate of a small grid,
repeating the devices there are where there are fewer (as
``distributed.retrieval.RetrievalMesh`` does), so one card, or the CPU,
holds a (2, 4) mesh.  Both expose ``shape`` (axis -> size),
``axis_names`` and ``size``, which ``distributed.sharding.from_mesh``
reads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes of the given sizes; ``devices`` an object array of that
    shape holding a ``torch.device`` per coordinate, or None (a logical
    mesh)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Optional[np.ndarray] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes, dtype=np.int64))

    def device_at(self, coords: Sequence[int]) -> torch.device:
        """The device at mesh coordinates ``coords`` (one per axis)."""
        if self.devices is None:
            raise ValueError("a logical mesh has no devices")
        return self.devices[tuple(coords)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes and axis names, logical."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def cuda_devices():
    """Every CUDA device of this machine (raises without CUDA)."""
    _device.resolve(None)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_debug_mesh(shape=(2, 4), axes=("data", "model"),
                    devices=None) -> Mesh:
    """A ``shape`` mesh over ``devices`` (default: every CUDA device; raises
    without one), in row-major order, the list repeated where it is
    shorter than the mesh."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    if devices is None:
        devices = cuda_devices()
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("no devices")
    n = int(np.prod(shape, dtype=np.int64))
    grid = np.empty(n, dtype=object)
    for i in range(n):
        grid[i] = devs[i % len(devs)]
    return Mesh(axes, shape, grid.reshape(shape))
