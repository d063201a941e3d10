"""Plain PyTorch versions of the fused IVF kernels (float32).

Mirror ``repro/kernels/ref.py:182-263`` (``fused_turn_ivf`` /
``fused_scan_ivf`` at ``precision="f32"``): centroid scores → top
``nprobe`` → gather of the probed lists → masked scores → top-k in
``lax.top_k`` order.  The CPU runs these; ``chip_smoke.py`` holds the
CUDA kernels against them on the card.

Every score is a per-row matrix–vector product (``gemv_rows``): one
query at a time, with the same operand shapes at any batch size, so a
row reduces in the same order whether it is served alone or in a batch
— the port's form of the reference's batch-size-stable broadcast
(``repro/core/toploc.py:78-95``).

Unlike the reference oracle, whose positions are undefined where a
value is ``-inf``, the pads here carry the kernels' convention
``(-inf, -1, PAD_POS)``, so kernel and plain version agree bit for bit
on every lane.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.topk import topk
from repro_torch.kernels.sorting import PAD_POS

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def gemv_rows(mat: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(B, n) scores, row b = ``mat @ q_b`` for a shared (n, d) ``mat``
    or ``mat[b] @ q_b`` for a per-row (B, n, d) one — one matrix–vector
    product per row, so each row's result is independent of B."""
    rows = [(mat if mat.dim() == 2 else mat[b]) @ queries[b]
            for b in range(queries.shape[0])]
    if not rows:
        n = mat.shape[-2]
        return queries.new_empty((0, n))
    return torch.stack(rows)


def list_scores(queries: torch.Tensor, list_vecs: torch.Tensor,
                sel: torch.Tensor) -> torch.Tensor:
    """Scores of every slot of the probed lists, (B, nprobe·lmax), flat
    position ``probe·lmax + offset``."""
    d = list_vecs.shape[-1]
    rows = [list_vecs[sel[b]].reshape(-1, d) @ queries[b]
            for b in range(queries.shape[0])]
    if not rows:
        return queries.new_empty((0, sel.shape[1] * list_vecs.shape[1]))
    return torch.stack(rows)


def fused_scan_ivf(queries: torch.Tensor, list_vecs: torch.Tensor,
                   list_ids: torch.Tensor, sel: torch.Tensor,
                   own: Optional[torch.Tensor], *, k: int) -> Triple:
    """Plain version of the fused IVF scan: (values (B, k), ids (B, k),
    flat positions (B, k)), int32 ids/positions."""
    b = queries.shape[0]
    ids = list_ids[sel]                                  # (B, np, lmax)
    if own is not None:
        ids = torch.where(own[..., None] > 0, ids, -1)
    flat_i = ids.reshape(b, -1)
    flat_v = torch.where(flat_i >= 0, list_scores(queries, list_vecs, sel),
                         float("-inf"))
    v, pos = topk(flat_v, k)
    i = flat_i.gather(-1, pos)
    pos = torch.where(torch.isneginf(v), PAD_POS, pos)
    return v, i.to(torch.int32), pos.to(torch.int32)


def fused_turn_ivf(queries: torch.Tensor, centroids: torch.Tensor,
                   list_vecs: torch.Tensor, list_ids: torch.Tensor, *,
                   nprobe: int, k: int) -> Triple:
    """Plain version of the whole IVF turn: (values (B, k), ids (B, k),
    sel (B, nprobe)), int32 ids/sel."""
    _, sel = topk(gemv_rows(centroids, queries), nprobe)
    sel = sel.to(torch.int32)
    v, i, _ = fused_scan_ivf(queries, list_vecs, list_ids, sel, None, k=k)
    return v, i, sel
