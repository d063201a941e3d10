"""Launch of the HNSW search kernel (``csrc/hnsw_search.cu``).

Counterpart of the reference's XLA traversal ``repro/core/hnsw.py``
``_search_impl`` (no Pallas kernel there).  As the other bindings: CUDA
tensors only, every operand checked (device, dtype, shape, contiguity,
16-byte rows), outputs and (for the global instance of the visited
set) its scratch allocated here, and the
entry with its launch plan handed to ``launcher.run``: one launch on
PyTorch's current stream, no host sync.  Ids are not checked against n
here (that needs them on the host): the index's build makes them, and
the engines pass back ids the search returned.  The choice between
kernel and plain version belongs to ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, launcher, tiling
from repro_torch.kernels.embedding_bag import _check


def _check_graph(d: int, n: int, adj0: torch.Tensor,
                 upper_adj: torch.Tensor, entry_point: torch.Tensor,
                 queries: torch.Tensor,
                 entry_override: Optional[torch.Tensor],
                 deleted: Optional[torch.Tensor], *, ef: int, k: int):
    """Check the graph and the queries of a search over n rows of d
    floats; returns (B, deg, levels, m)."""
    _check("adj0", adj0, torch.int32, 2)
    _check("upper_adj", upper_adj, torch.int32, 3)
    _check("entry_point", entry_point, torch.int32, 0)
    _check("queries", queries, torch.float32, 2)
    if entry_override is not None:
        _check("entry_override", entry_override, torch.int32, 1)
    if deleted is not None:
        _check("deleted", deleted, torch.bool, 1)
    b = queries.shape[0]
    deg = adj0.shape[1]
    levels, _, m = upper_adj.shape
    if (queries.shape[1] != d or adj0.shape[0] != n
            or (levels and upper_adj.shape[1] != n)
            or (entry_override is not None
                and tuple(entry_override.shape) != (b,))
            or (deleted is not None and tuple(deleted.shape) != (n,))):
        raise ValueError(f"shapes disagree: vectors ({n}, {d}), "
                         f"adj0 {tuple(adj0.shape)}, upper_adj "
                         f"{tuple(upper_adj.shape)}, queries "
                         f"{tuple(queries.shape)}")
    tensors = [t for t in (adj0, upper_adj, entry_point, queries,
                           entry_override, deleted) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the graph and the queries lie on different "
                         "devices")
    tiling.check_hnsw(d, ef, max(deg, m), k)
    if not launcher.aligned(queries):
        raise ValueError("queries must start 16-byte aligned")
    if b > tiling.MAX_GRID_X or n >= 2 ** 31 - 31:
        raise ValueError(f"batch {b} or {n} nodes out of range")
    return b, deg, levels, m


def _outputs(b: int, k: int, n: int, d: int, ef: int, deg: int,
             visited: str, dev: torch.device):
    kind, words = tiling.hnsw_visited(n, d, ef, deg, visited)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    out_nd = torch.empty((b,), dtype=torch.int32, device=dev)
    scratch = (torch.empty((b, words), dtype=torch.int32, device=dev)
               if kind == "global" else None)
    return kind, words, scratch, (out_v, out_i, out_nd)


def hnsw_search(vectors: torch.Tensor, adj0: torch.Tensor,
                upper_adj: torch.Tensor, entry_point: torch.Tensor,
                queries: torch.Tensor, entry_override: Optional[torch.Tensor],
                deleted: Optional[torch.Tensor], *, ef: int, k: int,
                visited: str = ""
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Search B queries: vectors (n, d) float32, adj0 (n, 2M) and
    upper_adj (L, n, M) int32 with -1 pads, entry_point () int32,
    queries (B, d) float32, entry_override (B,) int32 or None (then the
    descent runs), deleted (n,) bool or None.  Returns (scores (B, k)
    float32, ids (B, k) int32, ndist (B,) int32).  A B of 0 launches
    nothing.  ``visited`` forces an instance of the visited set
    (``tiling.HNSW_VISITED``; by default ``tiling.hnsw_visited``'s
    choice): every instance gives the same bits."""
    _check("vectors", vectors, torch.float32, 2)
    n, d = vectors.shape
    b, deg, levels, m = _check_graph(d, n, adj0, upper_adj, entry_point,
                                     queries, entry_override, deleted,
                                     ef=ef, k=k)
    if vectors.device != queries.device:
        raise ValueError("the index and the queries lie on different "
                         "devices")
    if not launcher.aligned(vectors):
        raise ValueError("vectors must start 16-byte aligned")
    dev = queries.device
    kind, words, scratch, out = _outputs(b, k, n, d, ef, deg, visited, dev)
    launcher.run("hnsw_search",
                 tiling.plan_hnsw_search(b, d, n, ef, deg, kind), dev,
                 vectors, n, d, adj0, deg, upper_adj if levels else None,
                 levels, m, entry_point, queries, b, entry_override, deleted,
                 ef, k, tiling.hnsw_max_steps(ef),
                 tiling.HNSW_VISITED.index(kind), scratch, words, *out)
    return out


def _peer_access(dev: torch.device, part: torch.Tensor) -> None:
    """Let ``dev`` read a shard on another card, or raise."""
    if part.device == dev or part.device.type != "cuda":
        return
    if not torch.cuda.can_device_access_peer(dev, part.device):
        raise ValueError(f"a shard on {part.device} is not readable from "
                         f"{dev}: peer access unsupported")
    if not launcher.recording():
        with torch.cuda.device(dev):
            err = _build.lib().hnsw_peer_access(part.device.index)
        if err != 0:
            raise RuntimeError(f"peer access {dev} -> {part.device} "
                               f"failed with cudaError {err}")


def hnsw_search_sharded(parts: Sequence[torch.Tensor], n_local: int,
                        adj0: torch.Tensor, upper_adj: torch.Tensor,
                        entry_point: torch.Tensor, queries: torch.Tensor,
                        entry_override: Optional[torch.Tensor],
                        deleted: Optional[torch.Tensor], *, ef: int, k: int,
                        visited: str = ""
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``hnsw_search`` over row-sharded vectors: shard s (``parts[s]``,
    float32, up to ``tiling.HNSW_MAX_SHARDS`` of them) holds rows
    [s·n_local, s·n_local + len); the graph, the queries and the outputs
    lie on the queries' device, and a shard on another card is read
    through peer access (raises where the cards have none).  Every score
    is the owner's dot + 0.0, the reference's psum over the shards."""
    if not 1 <= len(parts) <= tiling.HNSW_MAX_SHARDS:
        raise ValueError(f"{len(parts)} shards: 1 to "
                         f"{tiling.HNSW_MAX_SHARDS}")
    for s, part in enumerate(parts):
        _check(f"parts[{s}]", part, torch.float32, 2)
    d = parts[0].shape[1]
    n = sum(part.shape[0] for part in parts)
    if (any(part.shape[1] != d for part in parts) or n_local < 1
            or any(part.shape[0] != min(n_local, max(0, n - s * n_local))
                   for s, part in enumerate(parts))):
        raise ValueError(f"shards {[tuple(p.shape) for p in parts]} are not "
                         f"blocks of {n_local} rows")
    b, deg, levels, m = _check_graph(d, n, adj0, upper_adj, entry_point,
                                     queries, entry_override, deleted,
                                     ef=ef, k=k)
    dev = queries.device
    for part in parts:
        if not launcher.aligned(part):
            raise ValueError("every shard must start 16-byte aligned")
        _peer_access(dev, part)
    bases = (ctypes.c_void_p * tiling.HNSW_MAX_SHARDS)(
        *[p.data_ptr() if p.device.type == "cuda" else 0 for p in parts])
    kind, words, scratch, out = _outputs(b, k, n, d, ef, deg, visited, dev)
    launcher.run("hnsw_search_sharded",
                 tiling.plan_hnsw_search(b, d, n, ef, deg, kind), dev,
                 bases, len(parts), n_local, n, d, adj0, deg,
                 upper_adj if levels else None, levels, m, entry_point,
                 queries, b, entry_override, deleted, ef, k,
                 tiling.hnsw_max_steps(ef), tiling.HNSW_VISITED.index(kind),
                 scratch, words, *out)
    return out
