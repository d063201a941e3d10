"""Elastic scaling: rebuild the mesh for whatever devices survive
(``repro/distributed/elastic.py``).

Checkpoints restore as host arrays (mesh-independent), so elasticity is
(1) pick a mesh shape for the new device count, (2) re-place the
parameters with the same logical specs on the new mesh.  Divisibility
rule: keep the model axis as large as possible (<= the requested tp)
while it still divides the device count; the rest becomes data
parallelism.  Shrinking tp changes the math a device does, shrinking dp
only the throughput, so dp absorbs the loss.

``replace_on_mesh`` places a host tree by its specs on a ``launch.mesh``
mesh: each leaf becomes a ``Placed``, the block of the host array each
mesh coordinate's spec names, on that coordinate's device (a view where
the device is the host array's own, else a copy).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import P, entry_axes, map_specs
from repro_torch.launch import mesh as _mesh


def choose_mesh_shape(n_devices: int, *, preferred_model: int = 16,
                      multi_pod: bool = False) -> Tuple[Tuple[int, ...],
                                                        Tuple[str, ...]]:
    """Largest model axis <= preferred_model dividing n_devices; the rest
    is data (split in two pods where ``multi_pod`` and it is even)."""
    tp = min(preferred_model, n_devices)
    while tp > 1 and n_devices % tp:
        tp -= 1
    rest = n_devices // tp
    if multi_pod and rest % 2 == 0 and rest > 1:
        return (2, rest // 2, tp), ("pod", "data", "model")
    return (rest, tp), ("data", "model")


def make_elastic_mesh(n_devices: Optional[int] = None, *,
                      preferred_model: int = 16, multi_pod: bool = False,
                      devices: Optional[Sequence] = None) -> _mesh.Mesh:
    """A mesh of ``choose_mesh_shape(n_devices)`` over ``devices``
    (default every CUDA device; ``n_devices`` defaults to their count),
    repeating devices where there are fewer (``make_debug_mesh``)."""
    if devices is None:
        devices = _mesh.cuda_devices()
    n = n_devices or len(devices)
    shape, axes = choose_mesh_shape(n, preferred_model=preferred_model,
                                    multi_pod=multi_pod)
    return _mesh.make_debug_mesh(shape, axes, devices)


def block_index(spec: P, mesh: _mesh.Mesh, coords: Sequence[int],
                shape: Sequence[int]) -> Tuple[slice, ...]:
    """The block of an array of ``shape`` that mesh coordinates
    ``coords`` hold under ``spec``: per dimension, the part the named
    axes' coordinates pick (the first axis major), of size / Π sizes.
    Raises ``ValueError`` where a size does not divide, as the
    reference's placement does."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} for a {len(shape)}-d array")
    pos = dict(zip(mesh.axis_names, coords))
    out = []
    for dim, (n, entry) in enumerate(zip(shape, spec)):
        parts, idx = 1, 0
        for a in entry_axes(entry):
            idx = idx * mesh.shape[a] + pos[a]
            parts *= mesh.shape[a]
        if n % parts:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split into {parts} parts ({spec})")
        per = n // parts
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class Placed:
    """A leaf placed on a mesh: ``blocks[coords]`` the part of the global
    array (``shape``) that the device at ``coords`` of ``mesh`` holds
    under ``spec``."""
    spec: P
    shape: Tuple[int, ...]
    mesh: _mesh.Mesh
    blocks: Dict[Tuple[int, ...], torch.Tensor]

    def gather(self) -> torch.Tensor:
        """The global array on the CPU, each block written back in
        place."""
        first = next(iter(self.blocks.values()))
        out = torch.empty(self.shape, dtype=first.dtype)
        for coords, blk in self.blocks.items():
            out[block_index(self.spec, self.mesh, coords, self.shape)] = \
                blk.cpu()
        return out


def place(x, spec: P, mesh: _mesh.Mesh) -> Placed:
    """One leaf (a numpy array or a tensor) placed by ``spec``: a view of
    it where the coordinate's device is its own, else a copy there."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))
    blocks = {}
    for coords in np.ndindex(*mesh.sizes):
        dev = torch.device(mesh.device_at(coords))
        blk = t[block_index(spec, mesh, coords, t.shape)]
        blocks[tuple(int(c) for c in coords)] = (
            blk if dev == t.device else blk.to(dev))
    return Placed(P(*spec), tuple(t.shape), mesh, blocks)


def replace_on_mesh(tree: Any, specs: Any, mesh: _mesh.Mesh) -> Any:
    """Place a host tree on ``mesh`` with logical ``specs`` (after an
    elastic restore: the same specs work on any mesh that keeps the axis
    names, whatever their sizes).  ``specs`` is a tree of ``P`` in the
    structure of ``tree`` (None: replicated).  Returns the tree of
    ``Placed``."""
    return map_specs(lambda s, x: place(x, s or P(), mesh), specs, tree)
