"""Launch of the EmbeddingBag kernel (``csrc/embedding_bag.cu``).

Counterpart of ``repro/kernels/embedding_bag.py`` (sum mode; the mean
is ``ops.embedding_bag``'s).  As in ``fused_turn.py``: CUDA tensors
only, every operand checked (device, dtype, shape, contiguity), the
output allocated here, and the entry with its launch plan handed to
``launcher.run`` (one launch on PyTorch's current stream without
synchronising; a refused launch raises).  Ids past the table's rows
are not checked here: that needs the ids on the host, and the callers
check them there (``models/recsys.py``).  The choice between kernel and
plain version belongs to ``ops.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import launcher, tiling


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int
           ) -> None:
    launcher.check_device(name, t)
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Sum of each bag's rows: table (V, d) float32, ids (B, L) int32
    (negative = pad), weights (B, L) float32 or None.  Returns (B, d)
    float32.  A B of 0 launches nothing."""
    _check("table", table, torch.float32, 2)
    _check("ids", ids, torch.int32, 2)
    if weights is not None:
        _check("weights", weights, torch.float32, 2)
        if weights.shape != ids.shape:
            raise ValueError(f"weights {tuple(weights.shape)} do not match "
                             f"ids {tuple(ids.shape)}")
    if len({t.device for t in (table, ids, weights) if t is not None}) != 1:
        raise ValueError("table, ids and weights lie on different devices")
    b, bag = ids.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    launcher.run("embedding_bag_f32", tiling.plan_embedding_bag(b),
                 table.device, table, d, ids, weights, b, bag, out)
    return out
