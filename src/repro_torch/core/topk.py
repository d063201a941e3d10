"""Top-k selection in ``lax.top_k`` order.

Everything here operates on similarity scores (higher is better).  The
reference's ``lax.top_k`` resolves equal values by the lower index;
``torch.topk`` promises no order among ties.  ``topk`` therefore takes
a stable descending sort of the whole row and keeps its first k: ties
stay in index order, which is exactly ``lax.top_k``'s result, with no
host sync.
"""
from __future__ import annotations

from typing import Tuple

import torch


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis: (values, int64 indices), sorted desc,
    ties to the lower index."""
    n = scores.shape[-1]
    if k > n:
        raise ValueError(f"top-{k} of {n} elements")
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def masked_topk(scores: torch.Tensor, mask: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis ignoring positions where ``mask`` is False."""
    neg = torch.full((), float("-inf"), dtype=scores.dtype,
                     device=scores.device)
    return topk(torch.where(mask, scores, neg), k)


def intersect_count(ids_a: torch.Tensor, ids_b: torch.Tensor) -> torch.Tensor:
    """|set(ids_a) ∩ set(ids_b)| over the last axis (entries unique within
    each row; -1 entries are padding).  The paper's ``|I0|`` (Eq. 1);
    leading axes are a batch."""
    a = ids_a.unsqueeze(-1)
    b = ids_b.unsqueeze(-2)
    eq = (a == b) & (a >= 0)
    return eq.any(-1).sum(-1).to(torch.int32)
