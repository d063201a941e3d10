"""Top-k selection in ``lax.top_k`` order.

Everything here operates on similarity scores (higher is better).  The
reference's ``lax.top_k`` resolves equal values by the lower index and
ranks +0.0 above -0.0 (it orders floats by their bits); ``torch.topk``
promises no order among ties and ``torch.sort`` compares -0.0 == +0.0.
``topk`` therefore sorts the whole row by ``order_key`` (the float's
bit pattern mapped to a monotone integer, so -0.0 < +0.0), descending
and stable, and keeps its first k: ties stay in index order, which is
exactly ``lax.top_k``'s result, with no host sync.  NaN is out of
scope, as it is for the kernels.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INT_OF = {torch.float64: torch.int64, torch.float32: torch.int32,
           torch.float16: torch.int16, torch.bfloat16: torch.int16}


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """An integer tensor that orders like ``scores`` with -0.0 below
    +0.0: the float's bits, with the magnitude bits of negatives
    flipped (``csrc/topk_tie.cuh`` ``order_key`` for float32).  Integer
    scores are their own key."""
    itype = _INT_OF.get(scores.dtype)
    if itype is None:
        return scores
    bits = scores.view(itype)
    key = bits >> (bits.element_size() * 8 - 1)      # -1 on negatives
    key &= torch.iinfo(itype).max
    key ^= bits
    return key


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis: (values, int64 indices), sorted desc,
    ties to the lower index."""
    n = scores.shape[-1]
    if k > n:
        raise ValueError(f"top-{k} of {n} elements")
    i = torch.sort(order_key(scores), dim=-1, descending=True,
                   stable=True).indices[..., :k]
    return scores.gather(-1, i), i


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
