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

from typing import Optional, Tuple

import torch

from repro_torch.kernels import launcher, tiling
from repro_torch.kernels.embedding_bag import _check


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
    _check("adj0", adj0, torch.int32, 2)
    _check("upper_adj", upper_adj, torch.int32, 3)
    _check("entry_point", entry_point, torch.int32, 0)
    _check("queries", queries, torch.float32, 2)
    if entry_override is not None:
        _check("entry_override", entry_override, torch.int32, 1)
    if deleted is not None:
        _check("deleted", deleted, torch.bool, 1)
    n, d = vectors.shape
    b = queries.shape[0]
    deg = adj0.shape[1]
    levels, _, m = upper_adj.shape
    if (queries.shape[1] != d or adj0.shape[0] != n
            or (levels and upper_adj.shape[1] != n)
            or (entry_override is not None
                and tuple(entry_override.shape) != (b,))
            or (deleted is not None and tuple(deleted.shape) != (n,))):
        raise ValueError(f"shapes disagree: vectors {tuple(vectors.shape)}, "
                         f"adj0 {tuple(adj0.shape)}, upper_adj "
                         f"{tuple(upper_adj.shape)}, queries "
                         f"{tuple(queries.shape)}")
    tensors = [t for t in (vectors, adj0, upper_adj, entry_point, queries,
                           entry_override, deleted) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the index and the queries lie on different "
                         "devices")
    tiling.check_hnsw(d, ef, max(deg, m), k)
    if not (launcher.aligned(vectors) and launcher.aligned(queries)):
        raise ValueError("vectors and queries must start 16-byte aligned")
    if b > tiling.MAX_GRID_X or n >= 2 ** 31 - 31:
        raise ValueError(f"batch {b} or {n} nodes out of range")
    dev = queries.device
    kind, words = tiling.hnsw_visited(n, d, ef, deg, visited)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    out_nd = torch.empty((b,), dtype=torch.int32, device=dev)
    scratch = (torch.empty((b, words), dtype=torch.int32, device=dev)
               if kind == "global" else None)
    launcher.run("hnsw_search",
                 tiling.plan_hnsw_search(b, d, n, ef, deg, kind), dev,
                 vectors, n, d, adj0, deg, upper_adj if levels else None,
                 levels, m, entry_point, queries, b, entry_override, deleted,
                 ef, k, tiling.hnsw_max_steps(ef),
                 tiling.HNSW_VISITED.index(kind), scratch, words, out_v,
                 out_i, out_nd)
    return out_v, out_i, out_nd
