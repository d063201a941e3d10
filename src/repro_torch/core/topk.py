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

from typing import Sequence, Tuple

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


def merge_topk(values_a: torch.Tensor, ids_a: torch.Tensor,
               values_b: torch.Tensor, ids_b: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (values, ids) top-k lists into one top-k over the last
    axis; a tie goes to side a, then to the lower index."""
    v = torch.cat([values_a, values_b], -1)
    i = torch.cat([ids_a, ids_b], -1)
    top_v, pos = topk(v, k)
    return top_v, i.gather(-1, pos)


def distributed_topk(local_values: Sequence[torch.Tensor],
                     local_ids: Sequence[torch.Tensor], k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k of per-shard top-k lists, concatenated in shard
    order (so ties resolve shard-major)."""
    top_v, pos = topk(torch.cat(list(local_values), -1), k)
    return top_v, torch.cat(list(local_ids), -1).gather(-1, pos)


def distributed_topk_ordered(local_values: Sequence[torch.Tensor],
                             local_pos: Sequence[torch.Tensor],
                             local_ids: Sequence[torch.Tensor], k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k with single-device tie-breaking: every shard's
    candidates carry their flat position in the single-device scan, and
    the merge orders by (score desc, position asc), so duplicate
    documents with equal scores come out as the single-device
    ``lax.top_k`` over the flat candidates gives them.  Pads
    (``-inf``, ``PAD_POS``) come last.  Two stable sorts: by position,
    then by ``order_key`` descending."""
    v = torch.cat(list(local_values), -1)
    p = torch.cat(list(local_pos), -1)
    i = torch.cat(list(local_ids), -1)
    if k > v.shape[-1]:
        raise ValueError(f"top-{k} of {v.shape[-1]} merged candidates")
    by_pos = torch.sort(p, dim=-1, stable=True).indices
    v, i = v.gather(-1, by_pos), i.gather(-1, by_pos)
    by_v = torch.sort(order_key(v), dim=-1, descending=True,
                      stable=True).indices[..., :k]
    return v.gather(-1, by_v), i.gather(-1, by_v)


def intersect_count(ids_a: torch.Tensor, ids_b: torch.Tensor) -> torch.Tensor:
    """|set(ids_a) ∩ set(ids_b)| over the last axis (entries unique within
    each row; -1 entries are padding).  The paper's ``|I0|`` (Eq. 1);
    leading axes are a batch."""
    a = ids_a.unsqueeze(-1)
    b = ids_b.unsqueeze(-2)
    eq = (a == b) & (a >= 0)
    return eq.any(-1).sum(-1).to(torch.int32)
